"""The port's logistic oracle (``repro_torch.core.fw_logistic``) against the
JAX reference's on the CPU, in one process, on the logistic problem of
``tests/test_engine.py`` (``_logistic_data``).

Both packages get the same numpy problem and the same index stream: the
reference's own, drawn inside ``jax.threefry_partitionable(False)`` (the
mode its goldens were pinned under, ROADMAP.md Queue 3 R1) and replayed
through ``convert.stream_from_reference`` (lanes:
``convert.lane_streams_from_reference``).

Tolerances, and why:
  * integer facts (iterations, n_dots, active, the support) exact: the
    stream, the argmax and the stopping rule determine them (the
    bisection's 20 probes compare a dot product with 0, so a rounding
    difference would move lam by 2^-20 of a step at most);
  * objectives at rtol 1e-6, the reference goldens' tolerance for
    summation-order differences (torch's sigmoid and logaddexp round like
    XLA's to an ulp or so, and the dots sum in another order);
  * the reference's own bars where it sets them (sparse against dense 1e-3,
    'full' sampling 1e-4), and the port's runs against the reference's;
  * the paths run 500 steps a point (the golden's length) and compare
    objectives and l1 at rtol 2e-6: the loss sums m transcendental terms
    (torch's sigmoid and logaddexp round otherwise than XLA's by an ulp),
    and the bisection's sign tests see the packages' ulp-level differences
    in phi', so the warm-started points drift apart with the run length
    (measured on this problem: at most 2e-7 sequential and 1.07e-6 batched
    at 500 steps; ~1e-5 at 1,500; at 300 steps the batched path's last
    point takes another vertex at a near-tie, 1.7e-4 apart);
  * ``fuse_steps=8`` against 1, and each batched lane against its
    sequential replay: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LOGISTIC as REF_LOGISTIC
from repro.core import FWConfig as RefConfig
from repro.core import engine as ref_engine
from repro.core import path as ref_path
from repro.core import vertex as ref_vertex
from repro.core.fw_logistic import logistic_solve as ref_logistic_solve
from repro.sparse import SparseBlockMatrix as RefMatrix

from repro_torch import convert
from repro_torch.core import (LOGISTIC, FWConfig, LaneStreamSampler, LogisticCo, LogisticOracle,
                              StreamSampler, engine, logistic_solve, path, vertex)
from repro_torch.core.fw_logistic import _loss
from repro_torch.kernels import launch_counts

SEED, KAPPA = 42, 40
GOLDEN = dict(iterations=500, n_dots=31500, active=37, objective=3.0054101943969727)
FIXED = dict(sampling="uniform", kappa=KAPPA, tol=0.0, patience=10**9)


def _logistic_data(m=120, p=80, seed=0, sparse_threshold=None):
    """tests/test_engine.py's ``_logistic_data``, in numpy: features
    (p, m) f32 and labels in {-1, +1}."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, p)).astype(np.float32)
    if sparse_threshold is not None:
        X[np.abs(X) < sparse_threshold] = 0.0
    w = np.zeros(p, np.float32)
    w[:5] = rng.standard_normal(5) * 2
    y = np.sign(X @ w + 0.1 * rng.standard_normal(m)).astype(np.float32)
    y[y == 0] = 1.0
    return np.ascontiguousarray(X.T), y


def _draw(n_steps, draw_fn, key=None):
    """The reference engine's stream: key, sub = split(key); draw(sub)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, draw_fn(sub)

        key = jax.random.PRNGKey(SEED) if key is None else key
        _, draws = jax.lax.scan(body, key, None, length=n_steps)
    return np.asarray(draws)


def _uniform(n_steps, p, kappa=KAPPA, key=None):
    return _draw(n_steps, lambda k: jax.random.randint(k, (kappa,), 0, p), key)


def _port_matrix(ref_mat):
    return convert.sparse_from_reference(np.asarray(ref_mat.values), np.asarray(ref_mat.rows),
                                         ref_mat.p, ref_mat.m, ref_mat.block_size,
                                         ref_mat.nnz_max, "cpu")


def _designs(Xt, backend, block_size=32):
    if backend == "sparse":
        ref_mat = RefMatrix.from_dense(Xt, block_size=block_size)
        return ref_mat, _port_matrix(ref_mat)
    return jnp.asarray(Xt), torch.from_numpy(Xt)


def _ref(design, y, backend, alpha0=None, at=None, **kw):
    """The reference's solve; ``at`` overrides cfg.delta."""
    with jax.threefry_partitionable(False):
        return ref_logistic_solve(design, jnp.asarray(y), RefConfig(backend=backend, **kw),
                                  jax.random.PRNGKey(SEED),
                                  None if alpha0 is None else jnp.asarray(alpha0), at)


def _port(design, y, backend, draws, alpha0=None, at=None, **kw):
    """The port's solve replaying ``draws``; ``at`` overrides cfg.delta."""
    return logistic_solve(design, torch.from_numpy(np.asarray(y)), FWConfig(backend=backend, **kw),
                          convert.stream_from_reference(draws, "cpu"),
                          None if alpha0 is None else torch.as_tensor(np.asarray(alpha0)),
                          at, device="cpu")


def _same_facts(res, ref, rtol=1e-6):
    assert (res.iterations, res.n_dots, int(res.active)) == (
        int(ref.iterations), int(ref.n_dots), int(ref.active))
    np.testing.assert_array_equal(np.nonzero(res.alpha.numpy())[0],
                                  np.nonzero(np.asarray(ref.alpha))[0])
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=rtol)


# --------------------------------------------------------------------------
# the reference's golden and its sibling runs (tests/test_engine.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend,ref_backend", [("torch", "xla"), ("kernels", "pallas")])
def test_golden_replays_the_reference(backend, ref_backend):
    """tests/test_engine.py:108-119: 500 iterations, 31,500 dots, 37 active,
    3.0054101943969727."""
    Xt, y = _logistic_data()
    kw = dict(FIXED, delta=20.0, max_iters=500)
    res = _port(torch.from_numpy(Xt), y, backend, _uniform(500, Xt.shape[0]), **kw)
    assert (res.iterations, res.n_dots, int(res.active)) == (
        GOLDEN["iterations"], GOLDEN["n_dots"], GOLDEN["active"])
    np.testing.assert_allclose(float(res.objective), GOLDEN["objective"], rtol=1e-6)
    _same_facts(res, _ref(jnp.asarray(Xt), y, ref_backend, **kw))


@pytest.mark.parametrize("sparse_kernel", [None, False])
def test_sparse_golden_replays_the_reference(sparse_kernel):
    """The golden's run on the block-ELL form of its design: the
    reference's sparse run's facts, K5's plain version or the plain ops."""
    Xt, y = _logistic_data()
    ref_mat, mat = _designs(Xt, "sparse")
    kw = dict(FIXED, delta=20.0, max_iters=500)
    res = _port(mat, y, "sparse", _uniform(500, Xt.shape[0]), sparse_kernel=sparse_kernel, **kw)
    _same_facts(res, _ref(ref_mat, y, "sparse", **kw))


def test_sparse_matches_dense_and_the_reference():
    """tests/test_engine.py:152-163: on the sparsified data the sparse
    objective is within 1e-3 of the dense one and l1 within delta; each
    run equals the reference's."""
    Xt, y = _logistic_data(sparse_threshold=0.7)
    ref_mat, mat = _designs(Xt, "sparse")
    kw = dict(delta=20.0, sampling="uniform", kappa=KAPPA, max_iters=1500, tol=1e-6)
    draws = _uniform(1500, Xt.shape[0])
    res_d = _port(torch.from_numpy(Xt), y, "torch", draws, **kw)
    res_s = _port(mat, y, "sparse", draws, **kw)
    assert abs(float(res_s.objective) - float(res_d.objective)) / max(
        abs(float(res_d.objective)), 1e-9) < 1e-3
    assert float(res_s.alpha.abs().sum()) <= 20.0 * (1 + 1e-4)
    _same_facts(res_d, _ref(jnp.asarray(Xt), y, "xla", **kw))
    _same_facts(res_s, _ref(ref_mat, y, "sparse", **kw))


def test_sparse_block_sampling_converges_as_the_reference():
    """tests/test_engine.py:165-173: 'block' sampling drives whole ELL
    blocks; the loss falls below half of chance, on the reference's run."""
    Xt, y = _logistic_data(sparse_threshold=0.7)
    ref_mat, mat = _designs(Xt, "sparse")
    kw = dict(delta=20.0, sampling="block", kappa=64, max_iters=2000, tol=1e-6)
    draws = _draw(2000, lambda k: jax.random.choice(k, ref_mat.nblocks, (2,), replace=False))
    res = _port(mat, y, "sparse", draws, **kw)
    assert float(res.objective) < 0.5 * y.shape[0] * np.log(2.0)
    _same_facts(res, _ref(ref_mat, y, "sparse", **kw))


@pytest.mark.parametrize("sampling", ["uniform", "full"])
def test_kernels_match_torch_as_pallas_matches_xla(sampling):
    """tests/test_engine.py:188-204: 'uniform' replays one stream on both
    backends, to 1e-6; 'full' is deterministic FW, to 1e-4; each run equals
    the reference's on its backend."""
    Xt, y = _logistic_data(p=300)
    kw = dict(delta=10.0, sampling=sampling, max_iters=800, tol=1e-6,
              **(dict(kappa=KAPPA) if sampling == "uniform" else dict(block_size=128)))
    draws = _uniform(800, 300) if sampling == "uniform" else None
    runs = {}
    for backend, ref_backend in (("torch", "xla"), ("kernels", "pallas")):
        sampler = (convert.stream_from_reference(draws, "cpu") if draws is not None
                   else StreamSampler(torch.zeros((0, 1), dtype=torch.long)))
        runs[backend] = logistic_solve(torch.from_numpy(Xt), torch.from_numpy(y),
                                       FWConfig(backend=backend, **kw), sampler, device="cpu")
        _same_facts(runs[backend], _ref(jnp.asarray(Xt), y, ref_backend, **kw),
                    rtol=1e-6 if sampling == "uniform" else 1e-4)
    rel = abs(float(runs["kernels"].objective) - float(runs["torch"].objective)) / max(
        abs(float(runs["torch"].objective)), 1e-9)
    assert rel < (1e-6 if sampling == "uniform" else 1e-4)


def test_delta_override_lowers_the_loss():
    """tests/test_engine.py:206-215: one solver serves several deltas, and a
    larger budget gives a lower loss, as the reference's runs."""
    Xt, y = _logistic_data()
    kw = dict(delta=1.0, sampling="uniform", kappa=KAPPA, max_iters=500, tol=1e-5)
    draws = _uniform(500, Xt.shape[0])
    objs = []
    for d in (2.0, 8.0, 20.0):
        res = _port(torch.from_numpy(Xt), y, "kernels", draws, at=d, **kw)
        _same_facts(res, _ref(jnp.asarray(Xt), y, "pallas", at=d, **kw))
        objs.append(float(res.objective))
    assert objs[0] >= objs[1] >= objs[2]


def test_warm_restart_stalls_as_the_reference():
    """tests/test_engine.py:371-387: a warm restart from a converged
    solution stops within a quarter of the cold run's iterations, on the
    reference's iterations."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((60, 40)).astype(np.float32)
    w0 = np.zeros(40, np.float32)
    w0[:3] = rng.standard_normal(3) * 2
    y = np.sign(X @ w0 + 0.05 * rng.standard_normal(60)).astype(np.float32)
    y[y == 0] = 1.0
    Xt = np.ascontiguousarray(X.T)
    kw = dict(delta=2.0, sampling="uniform", kappa=20, max_iters=6000, tol=1e-4, gap_rtol=1e-3)
    draws = _uniform(6000, 40, kappa=20)
    base = _port(torch.from_numpy(Xt), y, "kernels", draws, **kw)
    ref_base = _ref(jnp.asarray(Xt), y, "pallas", **kw)
    _same_facts(base, ref_base)
    assert bool(base.converged)
    warm = _port(torch.from_numpy(Xt), y, "kernels", draws, alpha0=base.alpha.numpy(), **kw)
    ref_warm = _ref(jnp.asarray(Xt), y, "pallas", alpha0=ref_base.alpha, **kw)
    assert bool(warm.converged) and warm.iterations <= base.iterations // 4
    assert warm.iterations == int(ref_warm.iterations)


@pytest.mark.parametrize("backend", ["torch", "sparse"])
def test_gap_bounds_suboptimality_as_the_reference(backend):
    """tests/test_engine.py:308-330: a short run's certified gap, with the
    logistic gradient, covers its suboptimality against a long run, and
    equals the reference's ``gap()`` at the same alpha."""
    Xt, y = _logistic_data()
    ref_design, design = _designs(Xt, backend)
    cfg_kw = dict(delta=8.0, kappa=KAPPA, tol=0.0, patience=10**9)
    draws = _uniform(6000, Xt.shape[0])
    rough = _port(design, y, backend, draws, max_iters=60, **cfg_kw)
    best = _port(design, y, backend, draws, max_iters=6000, **cfg_kw)
    gap = float(LOGISTIC.gap(design, torch.from_numpy(y), rough.alpha, 8.0,
                             FWConfig(backend=backend, **cfg_kw)))
    subopt = float(rough.objective) - float(best.objective)
    assert gap >= subopt - 1e-5 * max(abs(float(best.objective)), 1.0) and gap >= 0.0
    ref_gap = float(REF_LOGISTIC.gap(
        ref_design, jnp.asarray(y), jnp.asarray(rough.alpha.numpy()), 8.0,
        RefConfig(backend=backend if backend == "sparse" else "xla", **cfg_kw)))
    np.testing.assert_allclose(gap, ref_gap, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "kernels", "sparse"])
def test_fuse_steps_falls_back_bit_for_bit(backend):
    """tests/test_engine.py:484-493: the bisection has no fused form, so
    fuse_steps=8 runs the per-step loop: the same alpha, bit for bit, and
    no chunk launches."""
    Xt, y = _logistic_data()
    design = _designs(Xt, backend)[1]
    kw = dict(FIXED, delta=20.0, max_iters=200)
    draws = _uniform(200, Xt.shape[0])
    l1 = _port(design, y, backend, draws, **kw)
    before = launch_counts()
    l8 = _port(design, y, backend, draws, fuse_steps=8, **kw)
    assert launch_counts() == before
    assert l8.effective_fuse_steps == 1 and l8.iterations == l1.iterations == 200
    assert torch.equal(l8.alpha, l1.alpha)


# --------------------------------------------------------------------------
# the tail and its pieces against the reference's ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_column_dense_is_the_references(layout):
    Xt, y = _logistic_data(sparse_threshold=0.7)
    ref_design, design = _designs(Xt, layout)
    cfg = RefConfig(delta=1.0, backend="sparse" if layout == "sparse" else "xla")
    for i in (0, 17, 79):
        want = np.asarray(ref_vertex.column_dense(ref_design, jnp.int32(i), cfg))
        got = vertex.column_dense(design, torch.tensor(i))
        np.testing.assert_array_equal(got.numpy(), want)
    stacked = vertex.columns_dense(design, torch.tensor([79, 0, 17]))
    assert torch.equal(stacked[2], vertex.column_dense(design, torch.tensor(17)))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_tail_matches_the_references_line_search(layout):
    """``LogisticOracle.tail`` on one state against the reference's
    line_search, apply_coeff_update and update_co: lam, the stall flag and
    the new margin and coefficients."""
    from repro.core import engine as eng

    Xt, y = _logistic_data()
    ref_design, design = _designs(Xt, layout)
    p, m = Xt.shape
    beta = np.zeros(p, np.float32)
    beta[[2, 5, 40]] = [1.5, -0.5, 0.25]
    margin = (beta @ Xt).astype(np.float32)
    cfg = FWConfig(delta=8.0, backend="torch" if layout == "dense" else "sparse")
    ref_cfg = RefConfig(delta=8.0, backend="xla" if layout == "dense" else "sparse")
    for i_star, g in ((5, 3.5), (33, -2.25), (2, -1e-9)):
        delta_t = -8.0 * np.sign(np.float32(g))
        a_star = np.float32(beta[i_star])
        co = REF_LOGISTIC.init_co(jnp.asarray(y), jnp.asarray(margin), None, jnp.float32)
        lam, no_prog, aux = REF_LOGISTIC.line_search(
            ref_design, jnp.asarray(y), None, co, jnp.int32(i_star), jnp.float32(g),
            jnp.float32(g), jnp.float32(a_star), jnp.float32(delta_t), ref_cfg)
        rb, rs, _, _, rstall = eng.apply_coeff_update(
            jnp.asarray(beta), jnp.float32(1.0), jnp.float32(1.5), jnp.int32(0),
            jnp.float32(a_star), jnp.int32(i_star), lam, jnp.float32(delta_t), no_prog, ref_cfg)
        want_margin = REF_LOGISTIC.update_co(ref_design, None, None, co, None, None, None, None,
                                             lam, None, None, ref_cfg, aux).margin
        state = engine.EngineState(
            beta=torch.from_numpy(beta.copy()), scale=torch.tensor(1.0),
            co=LogisticCo(torch.from_numpy(margin)), maxabs=torch.tensor(1.5),
            step_inf=torch.tensor(0.0), stall=torch.tensor(0, dtype=torch.int32), n_dots=0, k=0,
            i_star=torch.tensor(-1))
        out = LOGISTIC.tail(design, torch.from_numpy(y), None, state, torch.tensor(i_star),
                            torch.tensor(np.float32(g)), torch.tensor(np.float32(g)),
                            torch.tensor(8.0), cfg)
        assert int(out[4]) == int(rstall)
        np.testing.assert_allclose(float(out[1]), float(rs), rtol=1e-6)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(rb), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out[5].margin.numpy(), np.asarray(want_margin), rtol=1e-5,
                                   atol=1e-6)


def test_loss_ignores_padded_samples():
    margin = torch.tensor([0.5, -1.0, 2.0, 3.0])
    y = torch.tensor([1.0, -1.0, 0.0, 0.0])
    want = float(np.log1p(np.exp(-0.5)) + np.log1p(np.exp(-1.0)))
    np.testing.assert_allclose(float(_loss(margin, y)), want, rtol=1e-6)


# --------------------------------------------------------------------------
# batched lanes and the paths
# --------------------------------------------------------------------------

LANE_MAX_ITERS = 500


def _lane_streams(n_chunks, lane_width, p):
    """The reference fw_path_batched's per-lane streams, chunk by chunk."""
    with jax.threefry_partitionable(False):
        key, chunks = jax.random.PRNGKey(0), []
        for _ in range(n_chunks):
            key, *subs = jax.random.split(key, lane_width + 1)
            chunks.append([_uniform(LANE_MAX_ITERS, p, key=s) for s in subs])
    return chunks


@pytest.mark.parametrize("backend,ref_backend", [("torch", "xla"), ("kernels", "pallas"),
                                                 ("sparse", "sparse")])
def test_fw_path_batched_matches_reference(backend, ref_backend):
    """The reference's batched logistic path (its family section's driver,
    benchmarks/table5_fw.py:213-221, in lanes of 2 here): point by point,
    integer facts exact, objectives and l1 at rtol 2e-6."""
    Xt, y = _logistic_data()
    ref_design, design = _designs(Xt, backend)
    deltas = np.geomspace(1.0, 20.0, 4)
    kw = dict(delta=1.0, sampling="uniform", kappa=KAPPA, max_iters=LANE_MAX_ITERS, tol=1e-4)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path_batched(ref_design, jnp.asarray(y), deltas,
                                       RefConfig(backend=ref_backend, **kw), seed=0, lane_width=2,
                                       oracle=REF_LOGISTIC)
    streams = _lane_streams(2, 2, Xt.shape[0])
    res = path.fw_path_batched(
        design, torch.from_numpy(y), deltas, FWConfig(backend=backend, **kw), lane_width=2,
        oracle=LOGISTIC, device="cpu",
        lane_sampler_fn=lambda c: convert.lane_streams_from_reference(streams[c], "cpu"))
    for got, want in zip(res.points, ref.points):
        assert (got.iterations, got.n_dots, got.active) == (
            want.iterations, want.n_dots, want.active)
        np.testing.assert_array_equal(got.alpha_nnz_idx, want.alpha_nnz_idx)
        np.testing.assert_allclose(got.objective, want.objective, rtol=2e-6)
        np.testing.assert_allclose(got.l1, want.l1, rtol=2e-6)
    assert res.saved_iters == ref.saved_iters


def test_sequential_path_loss_falls_as_the_reference():
    """tests/test_engine.py:289-297 (500 steps a point): the logistic loss
    falls as delta grows along ``fw_path``, point by point the
    reference's."""
    Xt, y = _logistic_data()
    deltas = np.geomspace(1.0, 20.0, 4)
    kw = dict(delta=1.0, sampling="uniform", kappa=KAPPA, max_iters=500, tol=1e-6)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path(jnp.asarray(Xt), jnp.asarray(y), deltas, RefConfig(**kw), seed=0,
                               oracle=REF_LOGISTIC)
    keys = _point_keys(len(deltas))
    res = path.fw_path(torch.from_numpy(Xt), torch.from_numpy(y), deltas,
                       FWConfig(backend="torch", **kw), oracle=LOGISTIC, device="cpu",
                       sampler_fn=lambda g: convert.stream_from_reference(
                           _uniform(500, Xt.shape[0], key=keys[g]), "cpu"))
    objs = [pt.objective for pt in res.points]
    assert objs == sorted(objs, reverse=True)
    for got, want in zip(res.points, ref.points):
        assert (got.iterations, got.active) == (want.iterations, want.active)
        np.testing.assert_allclose(got.objective, want.objective, rtol=2e-6)


def _point_keys(n):
    """The reference fw_path's keys of its n grid points (core/path.py:189:
    key, sub = split(key) a point, from PRNGKey(seed))."""
    keys = []
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(0)
        for _ in range(n):
            key, sub = jax.random.split(key)
            keys.append(sub)
    return keys


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("backend", ["torch", "kernels", "sparse", "sparse plain"])
def test_lanes_equal_sequential_solves(backend, fuse):
    """Each lane of ``solve_batched`` is the sequential logistic solve on its
    own stream, bit for bit (alpha, objective, gap, iterations, n_dots, the
    vertices), on an m that is no multiple of a vector width (m = 120), one
    lane freezing early; ``fuse_steps=8`` runs the per-step loop."""
    Xt, y = _logistic_data(sparse_threshold=0.7)
    design = _designs(Xt, backend.split()[0])[1]
    yt = torch.from_numpy(y)
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=200, tol=1e-4, backend=backend.split()[0],
                   fuse_steps=fuse, report_gap=True,
                   sparse_kernel=False if backend == "sparse plain" else None)
    deltas = [0.5, 8.0, 20.0]
    rng = np.random.default_rng(5)
    draws = [torch.from_numpy(rng.integers(0, Xt.shape[0], (200, KAPPA))) for _ in deltas]
    seqs = [[] for _ in deltas]

    def on_step(state, active):
        for lane, a in enumerate(active):
            if a:
                seqs[lane].append(int(state.i_star[lane]))
            else:
                assert int(state.i_star[lane]) == -1

    res, saved = engine.solve_batched(LOGISTIC, design, yt, cfg, LaneStreamSampler(draws), None,
                                      deltas, device="cpu", on_step=on_step)
    for lane, d in enumerate(deltas):
        seq = []
        one = engine.solve(LOGISTIC, design, yt, cfg, StreamSampler(draws[lane]), None, d,
                           device="cpu", per_step=lambda s: seq.append(int(s.i_star)))
        assert (one.iterations, one.n_dots) == (res.iterations[lane], res.n_dots[lane])
        assert seq == seqs[lane]
        assert _bits(one.alpha, res.alpha[lane])
        assert _bits(one.objective, res.objective[lane])
        assert _bits(one.gap, res.gap[lane])
    assert res.effective_fuse_steps == 1


def test_lane_tail_keeps_frozen_lanes():
    """A frozen lane's margin, scalars and coefficients are its inputs."""
    Xt, y = _logistic_data()
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    cfg = FWConfig(delta=1.0, kappa=KAPPA)
    states = engine.stack_states([
        engine.init_state(LOGISTIC, X, yt, torch.full((80,), 0.01 * (lane + 1)), cfg)
        for lane in range(3)])
    before = [t.clone() for t in (states.beta, states.scale, states.co.margin)]
    out = LOGISTIC.tail_lanes(X, yt, None, states, torch.tensor([3, -1, 7]),
                              torch.tensor([1.0, 0.0, -2.0]), torch.tensor([1.0, 0.0, -2.0]),
                              torch.tensor([4.0, 4.0, 4.0]), cfg, [True, False, True],
                              torch.tensor([0, 2], dtype=torch.int32))
    assert torch.equal(out[0][1], before[0][1]) and torch.equal(out[1][1], before[1][1])
    assert torch.equal(out[5].margin[1], before[2][1])
    assert not torch.equal(out[5].margin[0], before[2][0])


# --------------------------------------------------------------------------
# state carried across, the package surface
# --------------------------------------------------------------------------


def test_state_from_reference_carries_the_margin():
    Xt, y = _logistic_data()
    alpha0 = np.full(80, 0.02, np.float32)
    with jax.threefry_partitionable(False):
        st0 = ref_engine.init_state(REF_LOGISTIC, jnp.asarray(Xt), jnp.asarray(y),
                                    jax.random.PRNGKey(0), jnp.asarray(alpha0))
    arrays = {"beta": st0.beta, "scale": st0.scale, "co.margin": st0.co.margin,
              "maxabs": st0.maxabs, "step_inf": st0.step_inf, "stall": st0.stall,
              "n_dots": st0.n_dots, "k": st0.k}
    state = convert.state_from_reference(arrays, "cpu")
    assert isinstance(state.co, LogisticCo)
    mine = engine.init_state(LOGISTIC, torch.from_numpy(Xt), torch.from_numpy(y),
                             torch.from_numpy(alpha0))
    np.testing.assert_allclose(mine.co.margin.numpy(), state.co.margin.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_logistic_oracle_surface():
    o = LogisticOracle()
    assert o == LOGISTIC and (o.n_bisect, o.extra_dots) == (20, 23)
    assert (o.needs_stats, o.fused_kind, o.fused_needs_alpha) == (False, None, False)
    assert LogisticOracle(n_bisect=5).extra_dots == 8
    assert o.score_extra(None, None) is None
    y = torch.tensor([1.0, -1.0])
    w = o.cograd(LogisticCo(torch.tensor([0.0, 0.0])), y)
    assert w.tolist() == [0.5, -0.5]
