"""The port's checkpoint manager (``repro_torch.checkpoint``) against the JAX
reference's (``repro.checkpoint``) on the CPU; ``TestCheckpointCore``
mirrors ``tests/test_checkpoint.py``'s, and ``TestAcrossPackages`` reads a
directory written by either package in the other. Values are compared
exactly: a checkpoint stores the arrays' bits (bf16 widened to f32, which
is exact).

The reference's ``TestCrashResume`` (the LM trainer) and
``TestElasticRemesh`` (an 8-device mesh) wait for ROADMAP.md Queue 1 items
15 and 13.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_manager
from repro.core.path import PathPoint as RefPathPoint
from repro.resilience import checkpoint as ref_path_ckpt

from repro_torch.checkpoint import (CheckpointManager, load_latest, load_latest_raw,
                                    save_checkpoint)
from repro_torch.checkpoint import manager
from repro_torch.core.path import PathPoint
from repro_torch.resilience import checkpoint as path_ckpt


class Pair(NamedTuple):
    first: torch.Tensor
    second: torch.Tensor


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16)},
    }


def _ref_tree():
    return {
        "a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
        "nested": {"b": jnp.ones((2, 2), jnp.bfloat16)},
    }


def _leaves(tree):
    return [leaf for _, leaf in manager._items(tree)]


class TestCheckpointCore:
    def test_roundtrip(self, tmp_path):
        state = {"params": _tree()}
        save_checkpoint(tmp_path, 7, state)
        step, restored = load_latest(tmp_path, {"params": _tree()})
        assert step == 7
        for a, b in zip(_leaves(state["params"]), _leaves(restored["params"])):
            assert torch.equal(a, b) and a.dtype == b.dtype

    def test_roundtrip_namedtuples_lists_and_numpy(self, tmp_path):
        state = {"s": {"pair": Pair(torch.tensor([1.5, -2.0]), torch.tensor(3, dtype=torch.int32)),
                       "seq": [np.arange(3, dtype=np.int64), np.float64(0.25)], "skip": None}}
        save_checkpoint(tmp_path, 1, state)
        _, raw = load_latest_raw(tmp_path)
        assert sorted(raw["s"]) == ["pair/first", "pair/second", "seq/0", "seq/1"]
        _, restored = load_latest(tmp_path, state)
        got = restored["s"]
        assert isinstance(got["pair"], Pair) and got["skip"] is None
        assert torch.equal(got["pair"].first, state["s"]["pair"].first)
        assert got["pair"].second.dtype == torch.int32
        np.testing.assert_array_equal(got["seq"][0], state["s"]["seq"][0])

    def test_corrupt_checkpoint_skipped(self, tmp_path):
        save_checkpoint(tmp_path, 1, {"params": _tree()})
        save_checkpoint(tmp_path, 2, {"params": _tree()})
        newest = sorted(tmp_path.iterdir())[-1]
        next(newest.glob("*.npz")).write_bytes(b"garbage")
        step, _ = load_latest(tmp_path, {"params": _tree()})
        assert step == 1  # fell back to the previous valid checkpoint
        assert load_latest_raw(tmp_path)[0] == 1

    def test_partial_checkpoint_invisible(self, tmp_path):
        """A crash mid-save leaves only a temp dir, never a visible one."""
        save_checkpoint(tmp_path, 1, {"params": _tree()})
        tmp = tmp_path / ".tmp_ckpt_crashed"
        tmp.mkdir()
        (tmp / "params.npz").write_bytes(b"partial")
        step, _ = load_latest(tmp_path, {"params": _tree()})
        assert step == 1

    def test_missing_directory_is_none(self, tmp_path):
        assert load_latest(tmp_path / "nope", {"params": _tree()}) is None
        assert load_latest_raw(tmp_path / "nope") is None

    def test_rotation(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"params": _tree()})
        mgr.wait()
        names = sorted(d.name for d in tmp_path.iterdir() if d.name.startswith("step_"))
        assert names == ["step_0000000003", "step_0000000004"]
        assert mgr.save_count == 4

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
        state = {"params": _tree()}
        mgr.save(5, state)
        state["params"]["a"].fill_(-1.0)  # the save copied to the host first
        mgr.wait()
        step, restored = mgr.restore({"params": _tree()})
        assert step == 5
        assert torch.equal(restored["params"]["a"], _tree()["a"])

    def test_async_save_error_is_raised_by_wait(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        mgr = CheckpointManager(blocker, async_save=True)
        mgr.save(1, {"params": _tree()})
        with pytest.raises(OSError):
            mgr.wait()


class TestAcrossPackages:
    def test_port_writes_reference_reads(self, tmp_path):
        save_checkpoint(tmp_path, 3, {"params": _tree()})
        step, restored = ref_manager.load_latest(tmp_path, {"params": _ref_tree()})
        assert step == 3
        for a, b in zip(jax.tree.leaves(_ref_tree()), jax.tree.leaves(restored["params"])):
            np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
            assert a.dtype == b.dtype

    def test_reference_writes_port_reads(self, tmp_path):
        ref_manager.save_checkpoint(tmp_path, 4, {"params": _ref_tree()})
        step, restored = load_latest(tmp_path, {"params": _tree()})
        assert step == 4
        for a, b in zip(_leaves(_tree()), _leaves(restored["params"])):
            assert torch.equal(a, b) and a.dtype == b.dtype

    def test_raw_groups_are_the_same_files(self, tmp_path):
        """The same tree, written by each package: the same npz keys, dtypes
        and values, and the same manifest layout."""
        save_checkpoint(tmp_path / "port", 9, {"params": _tree(), "opt": {"m": torch.zeros(2)}})
        ref_manager.save_checkpoint(tmp_path / "ref", 9,
                                    {"params": _ref_tree(), "opt": {"m": jnp.zeros(2)}})
        got = load_latest_raw(tmp_path / "port")
        want = ref_manager.load_latest_raw(tmp_path / "ref")
        assert got[0] == want[0] == 9
        assert sorted(got[1]) == sorted(want[1])
        for group in want[1]:
            assert sorted(got[1][group]) == sorted(want[1][group])
            for key, arr in want[1][group].items():
                assert got[1][group][key].dtype == arr.dtype
                np.testing.assert_array_equal(got[1][group][key], arr)
        # the port's reader takes the reference's directory too, and back
        assert sorted(load_latest_raw(tmp_path / "ref")[1]) == sorted(want[1])
        assert sorted(ref_manager.load_latest_raw(tmp_path / "port")[1]) == sorted(got[1])

    def test_path_checkpoint_groups_across_packages(self, tmp_path):
        """A path snapshot: the reference reads the port's points group to
        its own packing of the same points, and the port unpacks the
        reference's."""
        pts = [PathPoint(reg=0.5, objective=1.25, l1=0.5, active=2, iterations=10, n_dots=400,
                         seconds=0.1, alpha_nnz_idx=np.array([3, 17], np.int64),
                         alpha_nnz_val=np.array([0.25, -0.25], np.float32), gap=1e-3)]
        carry = torch.tensor([0.0, 0.5, -0.25], dtype=torch.bfloat16)
        path_ckpt.save_path_checkpoint(tmp_path / "port", 1, 5, carry, pts, saved_iters=7)
        _, groups = ref_manager.load_latest_raw(tmp_path / "port")
        want = ref_path_ckpt.pack_points([RefPathPoint(*pt) for pt in pts])
        for key, arr in want.items():
            np.testing.assert_array_equal(groups[ref_path_ckpt.PATH_GROUP][key], arr)
        pos = groups[path_ckpt.POS_GROUP]
        assert int(pos["next"]) == 1 and int(pos["seed"]) == 5 and int(pos["saved"]) == 7
        assert pos["carry"].dtype == np.float32
        np.testing.assert_array_equal(pos["carry"], carry.float().numpy())

        ref_path_ckpt.save_path_checkpoint(tmp_path / "ref", 1, jax.random.PRNGKey(0),
                                           jnp.zeros(3), [RefPathPoint(*pt) for pt in pts])
        _, raw = load_latest_raw(tmp_path / "ref")
        back = path_ckpt.unpack_points(raw[path_ckpt.PATH_GROUP])
        assert len(back) == 1 and (back[0].n_dots, back[0].reg) == (400, 0.5)
        np.testing.assert_array_equal(back[0].alpha_nnz_val, pts[0].alpha_nnz_val)
