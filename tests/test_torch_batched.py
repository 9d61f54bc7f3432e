"""The port's batched delta lanes (``engine.solve_batched``,
``path.fw_path_batched``) on the CPU: against the JAX reference's
``fw_path_batched``, and each lane against the port's own sequential solve.

Against the reference: both packages get the same numpy problem, and the
port replays the reference's per-lane index streams (each chunk's key split
into ``lane_width + 1`` keys, one lane's stream the scan of its key, drawn
inside ``jax.threefry_partitionable(False)``, ROADMAP.md Queue 3 R1) through
``convert.lane_streams_from_reference``. Per point, the integer facts
(iterations, n_dots, active, the support) and the path's ``saved_iters``
are exact: the stream, the argmax and the stopping rule determine them.
Objectives and l1 norms at rtol 1e-6, the reference goldens' tolerance for
summation-order differences. On these problems no near-tie flips a vertex
between the packages, so every point is compared whole.

Against itself: each lane of ``solve_batched`` is bit for bit the
sequential ``solve`` replaying the lane's stream (alpha, objective, gap,
iterations, n_dots, the vertex sequence), on every backend and sampling
mode, unfused and with ``fuse_steps=8`` (whose sequential counterpart is
the chunk of K unfused steps, ``run_loop``'s ``per_step`` route), with
lanes frozen early.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FWConfig as RefConfig
from repro.core import path as ref_path
from repro.sparse import SparseBlockMatrix as RefMatrix

from repro_torch import convert
from repro_torch.core import (LASSO, LOGISTIC, ENOracle, FWConfig, LaneSampler,
                              LaneStreamSampler, StreamSampler, engine, path)
from repro_torch.kernels import launch_counts

KAPPA, MAX_ITERS, SEED, DELTA_MAX = 60, 2000, 0, 150.0
BACKENDS = [("torch", "xla"), ("kernels", "pallas"), ("sparse", "sparse")]
# (n points, lane_width, fuse_steps): the default width (8 points: 1 lane a
# chunk), width 1, a ragged last chunk (7 points at width 3), fused at 3
LANE_CASES = {"default": (8, None, 1), "width 1": (3, 1, 1), "ragged": (7, 3, 1),
              "fused": (6, 3, 8)}


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    Xt = np.ascontiguousarray(ds.X.T)
    return Xt, ds.y, RefMatrix.from_dense(Xt, block_size=64)


def _port_design(prob, backend):
    Xt, _, ref_mat = prob
    if backend != "sparse":
        return torch.from_numpy(Xt)
    return convert.sparse_from_reference(np.asarray(ref_mat.values), np.asarray(ref_mat.rows),
                                         ref_mat.p, ref_mat.m, ref_mat.block_size,
                                         ref_mat.nnz_max, "cpu")


def _lane_streams(n_chunks, lane_width, p):
    """The reference fw_path_batched's per-lane streams, chunk by chunk."""
    with jax.threefry_partitionable(False):
        def step(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (KAPPA,), 0, p)

        key, chunks = jax.random.PRNGKey(SEED), []
        for _ in range(n_chunks):
            key, *subs = jax.random.split(key, lane_width + 1)
            chunks.append([np.asarray(jax.lax.scan(step, s, None, length=MAX_ITERS)[1])
                           for s in subs])
    return chunks


@pytest.mark.parametrize("case", list(LANE_CASES))
@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_fw_path_batched_matches_reference(prob, backend, ref_backend, case):
    Xt, y, ref_mat = prob
    n, lane_width, fuse = LANE_CASES[case]
    deltas = ref_path.delta_grid(DELTA_MAX, n_points=n)
    kw = dict(delta=1.0, kappa=KAPPA, max_iters=MAX_ITERS, tol=1e-4, report_gap=True,
              fuse_steps=fuse)
    ref_design = ref_mat if backend == "sparse" else jnp.asarray(Xt)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path_batched(ref_design, jnp.asarray(y), deltas,
                                       RefConfig(backend=ref_backend, **kw), seed=SEED,
                                       lane_width=lane_width)
    width = lane_width or max(1, -(-n // 8))
    streams = _lane_streams(-(-n // width), width, Xt.shape[0])
    res = path.fw_path_batched(
        _port_design(prob, backend), torch.from_numpy(y), deltas,
        FWConfig(backend=backend, **kw), lane_width=lane_width, device="cpu",
        lane_sampler_fn=lambda c: convert.lane_streams_from_reference(streams[c], "cpu"))
    assert len(res.points) == len(ref.points) == n
    for got, want in zip(res.points, ref.points):
        assert got.reg == want.reg
        assert (got.iterations, got.n_dots, got.active) == (
            want.iterations, want.n_dots, want.active)
        np.testing.assert_array_equal(got.alpha_nnz_idx, want.alpha_nnz_idx)
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
        np.testing.assert_allclose(got.l1, want.l1, rtol=1e-6)
        assert got.l1 <= got.reg * (1 + 1e-4)
        # the certified gap: a small difference of large terms (see
        # test_torch_path), so to 1e-6 of delta * ||X^T y||_inf
        assert abs(got.gap - want.gap) <= 1e-6 * got.reg * float(np.abs(Xt @ y).max())
    assert res.saved_iters == ref.saved_iters
    assert (res.total_iters, res.total_dots) == (ref.total_iters, ref.total_dots)


# --------------------------------------------------------------------------
# each lane against the port's sequential solve
# --------------------------------------------------------------------------


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("sampling", ["uniform", "block", "full"])
@pytest.mark.parametrize("backend", ["torch", "kernels", "sparse", "sparse plain"])
def test_lanes_equal_sequential_solves(prob, backend, sampling, fuse):
    """Lanes of deltas 2, 30 and 150 (the first freezes early) and a fourth
    warm-started at the third's solution (frozen after ``patience``
    steps): each lane is the sequential solve on its own stream, bit for
    bit, its gap included; ``saved`` is the frozen lanes' turns."""
    Xt, y, _ = prob
    design = _port_design(prob, backend.split()[0])
    yt = torch.from_numpy(y)
    max_iters = 40 if sampling == "full" else 400
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=max_iters, tol=1e-4, sampling=sampling,
                   backend=backend.split()[0], block_size=64, fuse_steps=fuse,
                   report_gap=True, sparse_kernel=False if backend == "sparse plain" else None)
    deltas = [2.0, 30.0, 150.0, 150.0]
    warm = engine.solve(LASSO, design, yt, cfg, StreamSampler(torch.zeros((0, 1))), None,
                        150.0, device="cpu") if sampling == "full" else None
    rng = np.random.default_rng(5)
    if sampling == "uniform":
        draws = [torch.from_numpy(rng.integers(0, 300, (max_iters, KAPPA))) for _ in deltas]
    else:
        n_blocks = -(-300 // 64)
        nb = min(max(KAPPA // 64, 1), n_blocks)
        draws = [torch.stack([torch.from_numpy(rng.permutation(n_blocks)[:nb])
                              for _ in range(max_iters)]) for _ in deltas]
    if warm is None:
        warm = engine.solve(LASSO, design, yt, cfg, StreamSampler(draws[2]), None, 150.0,
                            device="cpu")
    alpha0s = torch.zeros((4, 300))
    alpha0s[3] = warm.alpha
    seqs = [[] for _ in deltas]

    def on_step(state, active):
        for lane, a in enumerate(active):
            if a:
                seqs[lane].append(int(state.i_star[lane]))
            else:
                assert int(state.i_star[lane]) == -1

    res, saved = engine.solve_batched(LASSO, design, yt, cfg, LaneStreamSampler(draws), alpha0s,
                                      deltas, device="cpu", on_step=on_step)
    assert res.iterations[3] < max(res.iterations) and saved > 0
    for lane, d in enumerate(deltas):
        seq = []
        one = engine.solve(LASSO, design, yt, cfg, StreamSampler(draws[lane]), alpha0s[lane], d,
                           device="cpu", per_step=lambda s: seq.append(int(s.i_star)))
        assert (one.iterations, one.n_dots) == (res.iterations[lane], res.n_dots[lane])
        assert seq == seqs[lane]
        assert _bits(one.alpha, res.alpha[lane])
        assert _bits(one.objective, res.objective[lane])
        assert _bits(one.gap, res.gap[lane])
        assert bool(one.converged) == bool(res.converged[lane])
        assert int(one.active) == int(res.active[lane])
    assert res.effective_fuse_steps == (fuse if sampling == "uniform" else 1)


def test_saved_counts_frozen_lanes_per_turn(prob):
    """``saved`` grows by the frozen lanes' count each turn: three lanes of
    one delta on their own streams stop at their own steps, and ``saved``
    is what each was spared against the slowest."""
    Xt, y, _ = prob
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=300, tol=1e-4)
    rng = np.random.default_rng(2)
    draws = [torch.from_numpy(rng.integers(0, 300, (300, KAPPA))) for _ in range(3)]
    res, saved = engine.solve_batched(LASSO, X, yt, cfg, LaneStreamSampler(draws), None,
                                      [150.0] * 3, device="cpu")
    iters = res.iterations
    assert saved == sum(max(iters) - k for k in iters)


def test_lane_sampler_draws_every_lane_in_one_call():
    """A LaneSampler's step is one (L, kappa) draw whatever lanes are
    active, the same rows from the same seed; block ids are distinct a
    lane."""
    a = LaneSampler(7, 4, "cpu")
    b = LaneSampler(7, 4, "cpu")
    ra = a.uniform_lanes(50, 1000, [True, False, True, True])
    rb = b.uniform_lanes(50, 1000, [True] * 4)
    assert ra.shape == (4, 50) and torch.equal(ra, rb)
    assert int(ra.min()) >= 0 and int(ra.max()) < 1000
    blocks = a.blocks_lanes(3, 10, [True] * 4)
    assert blocks.shape == (4, 3)
    assert all(len(set(row.tolist())) == 3 for row in blocks)


def test_lane_stream_sampler_advances_active_lanes_only():
    draws = [torch.arange(6).view(3, 2) + 10 * lane for lane in range(3)]
    s = LaneStreamSampler(draws)
    assert s.uniform_lanes(2, 100, [True, False, True]).tolist() == [[0, 1], [0, 0], [20, 21]]
    assert s.uniform_lanes(2, 100, [True, True, False]).tolist() == [[2, 3], [10, 11], [0, 0]]
    assert s.uniform_lanes(2, 100, [False, True, True]).tolist() == [[0, 0], [12, 13], [22, 23]]
    assert s.uniform_lanes(2, 100, [True, False, False]).tolist() == [[4, 5], [0, 0], [0, 0]]
    with pytest.raises(RuntimeError, match="ran out"):
        s.uniform_lanes(2, 100, [True, False, False])
    with pytest.raises(ValueError, match="lanes asked"):
        s.uniform_lanes(2, 100, [True])


def test_lane_streams_from_reference():
    """convert.lane_streams_from_reference replays the reference's per-lane
    draws row by row."""
    streams = _lane_streams(1, 3, 300)[0]
    s = convert.lane_streams_from_reference([d[:5] for d in streams], "cpu")
    for t in range(5):
        rows = s.uniform_lanes(KAPPA, 300, [True, True, True])
        for lane in range(3):
            np.testing.assert_array_equal(rows[lane].numpy(), streams[lane][t])
    with pytest.raises(ValueError, match="values must lie"):
        convert.lane_streams_from_reference([d[:2] for d in streams], "cpu").uniform_lanes(
            KAPPA, 100, [True] * 3)


def test_default_lane_sampler_path_on_cpu(prob):
    """Without streams the path draws from per-chunk LaneSamplers: the same
    seed gives the same path, every point stays in its l1 ball, and the
    densest point's objective is the lowest."""
    Xt, y, _ = prob
    deltas = path.delta_grid(100.0, n_points=5)
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=MAX_ITERS, tol=1e-4, backend="kernels")
    a = path.fw_path_batched(Xt, y, deltas, cfg, seed=3, lane_width=2, device="cpu")
    b = path.fw_path_batched(Xt, y, deltas, cfg, seed=3, lane_width=2, device="cpu")
    assert [pt.iterations for pt in a.points] == [pt.iterations for pt in b.points]
    assert [pt.objective for pt in a.points] == [pt.objective for pt in b.points]
    assert [pt.reg for pt in a.points] == pytest.approx(list(deltas))
    for pt in a.points:
        assert pt.l1 <= pt.reg * (1 + 1e-4)
    assert a.points[-1].objective < a.points[0].objective
    assert a.saved_iters >= 0


def test_lane_kernels_run_plain_on_cpu(prob):
    """CPU tensors take the lane kernels' plain versions: no launch counted."""
    Xt, y, _ = prob
    before = launch_counts()
    engine.solve_batched(LASSO, Xt, y, FWConfig(delta=1.0, kappa=KAPPA, max_iters=30,
                                                backend="kernels"),
                         LaneSampler(0, 2, "cpu"), None, [1.0, 5.0], device="cpu")
    assert launch_counts() == before


def test_unported_lane_options_raise(prob, tmp_path):
    Xt, y, _ = prob
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=30)
    # checkpoint/resume is ported now (ROADMAP.md item 12): a snapshot a
    # chunk, and a resume from a directory without one starts fresh
    ck = tmp_path / "ckpt"
    done = path.fw_path_batched(Xt, y, [1.0, 2.0, 3.0], cfg, lane_width=2, device="cpu",
                                checkpoint_dir=str(ck))
    assert sorted(d.name for d in ck.iterdir()) == ["step_0000000001", "step_0000000002"]
    fresh = path.fw_path_batched(Xt, y, [1.0, 2.0, 3.0], cfg, lane_width=2, device="cpu",
                                 resume_from=str(tmp_path / "empty"))
    assert [pt.objective for pt in fresh.points] == [pt.objective for pt in done.points]

    class OtherOracle:
        needs_stats = True

    # the lasso, elastic-net and logistic oracles all have lanes now; an
    # oracle without ``tail_lanes`` is still refused
    with pytest.raises(NotImplementedError, match="tail_lanes"):
        engine.solve_batched(OtherOracle(), Xt, y, cfg, LaneSampler(0, 1, "cpu"), None, [1.0],
                             device="cpu")
    for oracle in (ENOracle(l2=1.0), LOGISTIC):
        res, _ = engine.solve_batched(oracle, Xt, y, cfg, LaneSampler(0, 1, "cpu"), None, [1.0],
                                      device="cpu")
        assert res.iterations[0] > 0
    # the step rules have lanes now (ROADMAP.md item 9a,
    # tests/test_torch_rule_lanes.py holds them)
    res, _ = engine.solve_batched(LASSO, Xt, y, FWConfig(delta=1.0, step_rule="away",
                                                         max_iters=30),
                                  LaneSampler(0, 1, "cpu"), None, [1.0], device="cpu")
    assert res.iterations[0] > 0
    # as the reference's: the distributed backend runs only through its drivers,
    # on a ShardedOperand (tests/test_torch_distributed.py runs them)
    with pytest.raises(ValueError, match="only runs inside repro_torch.distributed"):
        path.fw_path_batched(Xt, y, [1.0], FWConfig(delta=1.0, backend="distributed"),
                             device="cpu")


def test_batched_entry_points_need_a_card_by_default(prob):
    """Without a card the batched entry points raise unless given
    device='cpu' (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    Xt, y, _ = prob
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=30)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        path.fw_path_batched(Xt, y, [1.0], cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.solve_batched(LASSO, Xt, y, cfg, LaneSampler(0, 1, "cpu"), None, [1.0])
    with pytest.raises(RuntimeError):  # a CUDA generator, as TorchSampler's
        LaneSampler(0, 1)
