"""The port's cell plan (``repro_torch.launch.cells``) against the
reference's: the reference's ``TestCellPlan`` on the port, then for the
ten full configs every leaf of ``batch_specs_for``, ``decode_inputs_for``,
``params_spec_for`` and ``opt_spec_for`` against the reference's
``jax.eval_shape`` leaf (shape and dtype). The port's stand-ins are fake
tensors: kimi-k2's 1.03 T parameters take no memory.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import cells as ref_cells
from repro.training import optimizers as ref_opt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import cells as cell_lib
from repro_torch.training import optimizers as opt_lib


class TestCellPlan:
    def test_40_cells(self):
        assert len(list(cell_lib.iter_cells())) == 40

    def test_skips_match_design(self):
        skipped = {(a, s) for a, s, r in cell_lib.iter_cells() if r}
        assert ("mamba2_130m", "long_500k") not in skipped
        assert ("hymba_1_5b", "long_500k") not in skipped
        assert ("qwen2_72b", "long_500k") in skipped
        assert ("gemma2_9b", "long_500k") in skipped  # global layers quadratic
        assert len(skipped) == 8

    def test_input_specs_cover_all_inputs(self):
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            batch = cell_lib.batch_specs_for(cfg, cell_lib.SHAPES["train_4k"])
            assert "tokens" in batch
            if cfg.n_prefix_embeds:
                assert "patches" in batch
            if cfg.n_enc_layers:
                assert "frames" in batch
            toks, cache = cell_lib.decode_inputs_for(cfg, cell_lib.SHAPES["decode_32k"])
            assert toks.shape == (128, 1)
            assert "len" in cache

    def test_microbatches_defined_for_all(self):
        for arch in ARCH_IDS:
            assert arch in cell_lib.TRAIN_MICROBATCHES

    def test_the_references_plan(self):
        assert list(cell_lib.iter_cells()) == list(ref_cells.iter_cells())
        assert {k: tuple(vars(v).values()) for k, v in cell_lib.SHAPES.items()} == {
            k: tuple(vars(v).values()) for k, v in ref_cells.SHAPES.items()}
        assert cell_lib.TRAIN_MICROBATCHES == ref_cells.TRAIN_MICROBATCHES
        assert cell_lib.SERVE_MLP_DATA == ref_cells.SERVE_MLP_DATA


def _path(p) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", getattr(e, "name", e)))) for e in p)


def _same(got: torch.Tensor, want, where):
    from torch._subclasses.fake_tensor import is_fake

    assert is_fake(got), where
    assert tuple(got.shape) == tuple(want.shape), where
    assert str(got.dtype).removeprefix("torch.") == np.dtype(want.dtype).name, where


def _ref_leaves(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {_path(p): leaf for p, leaf in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stand_ins_are_the_references(arch):
    cfg, ref = get_config(arch), ref_config(arch)
    for shape in ("train_4k", "prefill_32k"):
        got = cell_lib.batch_specs_for(cfg, cell_lib.SHAPES[shape])
        want = ref_cells.batch_specs_for(ref, ref_cells.SHAPES[shape])
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], (shape, k))
    for shape in ("decode_32k", "long_500k"):
        toks, cache = cell_lib.decode_inputs_for(cfg, cell_lib.SHAPES[shape])
        rtoks, rcache = ref_cells.decode_inputs_for(ref, ref_cells.SHAPES[shape])
        _same(toks, rtoks, (shape, "tokens"))
        assert set(cache) == set(rcache)
        for k in rcache:
            _same(cache[k], rcache[k], (shape, k))

    params = cell_lib.params_spec_for(cfg)
    ref_params = ref_cells.params_spec_for(ref)
    want = _ref_leaves(ref_params)
    named = dict(params.named_parameters())
    groups = opt_lib.leaf_groups(params)
    assert set(groups) == set(want)
    for path, (names, stacked) in groups.items():
        w = want[path]
        if stacked:  # the reference's layer stack: one block a leading index
            assert len(names) == w.shape[0], path
            w = jax.ShapeDtypeStruct(w.shape[1:], w.dtype)
        for n in names:
            _same(named[n], w, (path, n))

    opt = cell_lib.opt_spec_for(cfg, params)
    ref_state = ref_cells.opt_spec_for(ref, ref_params)
    _same(opt.step, ref_state.step, "step")
    ref_inner = _ref_leaves(ref_state.inner,
                            is_leaf=lambda x: isinstance(x, (ref_opt.AdamLeaf, ref_opt.FactorLeaf)))
    assert set(opt.inner) == set(ref_inner)
    for path, leaf in opt.inner.items():
        assert type(leaf).__name__ == type(ref_inner[path]).__name__, path
        for field in leaf._fields:
            _same(getattr(leaf, field), getattr(ref_inner[path], field), (path, field))


def test_stand_ins_take_no_memory_and_follow_the_device():
    """kimi-k2's parameters (1.03 T) as fake tensors, labelled 'cuda' with
    no card."""
    from torch._subclasses.fake_tensor import is_fake

    params = cell_lib.params_spec_for(get_config("kimi_k2_1t_a32b"), device="cuda")
    ps = list(params.parameters())
    assert all(is_fake(p) and p.device.type == "cuda" for p in ps)
    assert sum(p.numel() for p in ps) > 1.0e12
