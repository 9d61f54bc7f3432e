"""The port's fused K-step chunk (``FWConfig.fuse_steps > 1``) against the
JAX reference on the CPU, in one process, on the ``small_problem``
geometry of ``tests/test_engine.py``.

On CPU tensors the 'kernels' backend runs the fused chunk's plain version
(``kernels/fused_step.dense_fused_chunk_plain``) and the replay's
(``fused_replay_plain``); 'torch' chunks through K unfused steps. Both get
the reference's own index stream, drawn inside
``jax.threefry_partitionable(False)`` as in ``tests/test_torch_engine.py``.

Tolerances, and why:
  * the chunk kernel against the reference's Pallas kernel (interpret mode)
    and its XLA mirror: i_star and no_progress exact; lam, delta_t and the
    residual at rtol/atol 1e-5, (S, F) at rtol 1e-4 -- the reference's own
    tolerances for its kernel against its mirror (gather-order rounding);
  * a fused solve against the reference's fused solve: integer facts exact,
    alpha at rtol 1e-6, the tolerance the reference's goldens use for
    BLAS-order differences;
  * fuse_steps=8 against fuse_steps=1 in the port: bit-identical, as the
    reference pins for itself -- the chunk's plain version runs the unfused
    step's own ops in the same order;
  * the replay against a per-step ``apply_coeff_update`` loop: bit-identical
    (it is that loop); against the reference's ``_fused_replay`` at rtol
    1e-6 (XLA may fuse the scalar ops differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FWConfig as RefConfig
from repro.core import LASSO as REF_LASSO
from repro.core import engine as ref_engine
from repro.core import path as ref_path
from repro.kernels import fused_step as ref_fs

from repro_torch import convert
from repro_torch.core import LASSO, FWConfig, engine, fw_solve, path
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import launch_counts

DELTA, KAPPA, SEED, K = 150.0, 60, 42, 8
PAIRS = [("torch", "xla"), ("kernels", "pallas")]
FIXED = dict(delta=DELTA, sampling="uniform", kappa=KAPPA, max_iters=300, tol=0.0,
             patience=10**9)


def _draw_stream(n_steps, p, key=None):
    """The reference engine's uniform stream from ``key`` (default
    PRNGKey(SEED)): key, sub = split(key); randint(sub)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (KAPPA,), 0, p)

        key = jax.random.PRNGKey(SEED) if key is None else key
        _, draws = jax.lax.scan(body, key, None, length=n_steps)
    return np.asarray(draws)


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    return np.ascontiguousarray(ds.X.T), ds.y


@pytest.fixture(scope="module")
def stream(prob):
    # 38 chunks of 8: a fused run of 300 steps draws the trailing chunk's
    # 4 masked steps too, as the reference does
    return _draw_stream(304, prob[0].shape[0])


def _ref_solve(Xt, y, backend, **kw):
    cfg = RefConfig(backend=backend, **kw)
    with jax.threefry_partitionable(False):
        return ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y), cfg,
                                jax.random.PRNGKey(SEED))


def _port_solve(Xt, y, backend, draws, **kw):
    X, yt = convert.problem_from_numpy(Xt, y, "cpu")
    return fw_solve(X, yt, FWConfig(backend=backend, **kw),
                    convert.stream_from_reference(draws, "cpu"), device="cpu")


# --------------------------------------------------------------------------
# 1. the chunk's plain version against the reference's kernel and mirror
# --------------------------------------------------------------------------


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_mirror"])
@pytest.mark.parametrize("k0,max_iters", [(0, 10**6), (60, 66)])
def test_chunk_matches_reference_kernel(prob, reference, k0, max_iters):
    """The inputs of tests/test_engine.py::test_megakernel_matches_xla_ref;
    (60, 66) puts a refresh (k = 63) and max_iters inside the chunk."""
    Xt, y = prob
    p, m = Xt.shape
    kappa = 32
    rng = np.random.default_rng(5)
    resid = rng.standard_normal(m).astype(np.float32)
    idx = rng.integers(0, p, (K, kappa)).astype(np.int32)
    zty = (Xt.astype(np.float64) @ y).astype(np.float32)
    zn2 = (Xt.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    scal = (3.0, 1.5, 0.0)
    kw = dict(eps_den=1e-12, gap_rtol=1e-6, refresh_every=64, max_iters=max_iters)
    ref_fn = (lambda *a, **k: ref_fs.dense_fused_chunk(*a, interpret=True, **k)) \
        if reference == "pallas_interpret" else ref_fs.dense_fused_chunk_ref
    want = ref_fn(jnp.asarray(Xt), jnp.asarray(y), jnp.asarray(resid),
                  tuple(jnp.float32(s) for s in scal), jnp.asarray(idx),
                  jnp.asarray(zty[idx]), jnp.asarray(zn2[idx]), None, jnp.int32(k0),
                  jnp.float32(40.0), oracle=REF_LASSO, **kw)
    before = launch_counts()
    got = fs.dense_fused_chunk(
        torch.from_numpy(Xt), torch.from_numpy(y), torch.from_numpy(resid),
        tuple(torch.tensor(s) for s in scal), torch.from_numpy(idx).long(),
        torch.from_numpy(zty[idx]), torch.from_numpy(zn2[idx]), k0, torch.tensor(40.0),
        oracle=LASSO, **kw)
    assert launch_counts() == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in ((got[1], want[1]), (got[2], want[2]), (got[4], want[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for g, w in zip(got[5][:2], want[5][:2]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)


# --------------------------------------------------------------------------
# 2-4. fused solves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("max_iters", [60, 300])
@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_fused_solve_matches_reference(prob, stream, backend, ref_backend, max_iters):
    """Neither 60 nor 300 is a multiple of K: the trailing chunk's masked
    steps leave the counters and the trajectory exact. alpha is held at
    rtol 1e-6 over the first 60 steps; at step 61 the two packages' scores
    near-tie (tests/test_torch_engine.py) and the trajectories part by
    rounding (alpha ~2.5e-5 apart at 300 steps, fused or not), so the
    300-step run is held to the golden's facts and objective."""
    Xt, y = prob
    kw = dict(FIXED, fuse_steps=K, max_iters=max_iters)
    ref = _ref_solve(Xt, y, ref_backend, **kw)
    res = _port_solve(Xt, y, backend, stream, **kw)
    assert int(ref.effective_fuse_steps) == res.effective_fuse_steps == K
    assert (res.iterations, res.n_dots) == (int(ref.iterations), int(ref.n_dots))
    assert (res.iterations, res.n_dots) == (max_iters, max_iters * KAPPA)
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=1e-6)
    if max_iters == 60:
        np.testing.assert_allclose(res.alpha.numpy(), np.asarray(ref.alpha), rtol=1e-6)
    else:
        assert np.nonzero(res.alpha.numpy())[0].tolist() == [70, 272]
        np.testing.assert_allclose(float(res.objective), 751729.4375, rtol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_fuse8_is_bit_identical_to_fuse1(prob, stream, backend):
    Xt, y = prob
    r1 = _port_solve(Xt, y, backend, stream, **FIXED)
    r8 = _port_solve(Xt, y, backend, stream, fuse_steps=K, **FIXED)
    assert (r1.effective_fuse_steps, r8.effective_fuse_steps) == (1, K)
    assert (r8.iterations, r8.n_dots) == (r1.iterations, r1.n_dots) == (300, 18000)
    assert torch.equal(r8.alpha, r1.alpha)
    assert float(r8.objective) == float(r1.objective)


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_converging_overshoot_is_bounded(prob, stream, backend, ref_backend):
    """The stopping rule is read between chunks: a stall stop overshoots by
    at most K-1 steps, and lands where the reference's fused run does."""
    Xt, y = prob
    kw = dict(delta=DELTA, sampling="uniform", kappa=KAPPA, max_iters=5000, tol=1e-4)
    r1 = _port_solve(Xt, y, backend, stream, **kw)
    r8 = _port_solve(Xt, y, backend, stream, fuse_steps=K, **kw)
    ref8 = _ref_solve(Xt, y, ref_backend, fuse_steps=K, **kw)
    assert bool(r1.converged) and bool(r8.converged)
    assert r1.iterations <= r8.iterations <= r1.iterations + K - 1
    assert (r8.iterations, r8.n_dots) == (int(ref8.iterations), int(ref8.n_dots))
    rel = abs(float(r8.objective) - float(r1.objective)) / abs(float(r1.objective))
    assert rel < 1e-6


def test_on_step_sees_each_chunks_vertices(prob, stream):
    """The hook is called once per chunk with the chunk's live vertices; in
    order they are the unfused run's sequence."""
    Xt, y = prob
    X, yt = convert.problem_from_numpy(Xt, y, "cpu")
    seqs = {}
    for fuse in (1, K):
        calls = []
        fw_solve(X, yt, FWConfig(backend="kernels", fuse_steps=fuse, **FIXED),
                 convert.stream_from_reference(stream, "cpu"), device="cpu",
                 on_step=lambda s: calls.append(s.i_star.view(-1).clone()))
        seqs[fuse] = calls
    assert len(seqs[1]) == 300 and len(seqs[K]) == 38
    assert [len(c) for c in seqs[K]] == [K] * 37 + [4]
    assert torch.equal(torch.cat(seqs[K]), torch.cat(seqs[1]))


# --------------------------------------------------------------------------
# 5. the replay
# --------------------------------------------------------------------------


def _records(p, seed):
    rng = np.random.default_rng(seed)
    i_stars = rng.integers(0, p, K)
    i_stars[5] = i_stars[2]  # a coordinate hit twice
    lams = (rng.random(K) * 0.5).astype(np.float32)
    lams[3] = 0.9  # 3e-6 * prod(1 - lam) falls below renorm_threshold here at the latest
    dts = np.where(rng.random(K) < 0.5, -DELTA, DELTA).astype(np.float32)
    nps = rng.random(K) < 0.3
    return i_stars, lams, dts, nps


def _replay_against_loop_and_reference(recs_np, scale0, k0):
    """The replay of ``recs_np`` (i_stars, lams, dts, nps) from ``scale0``
    over p = 300: bit for bit the per-step loop the unfused engine runs,
    and the reference's ``_fused_replay`` at rtol 1e-6. Returns the
    replay's outputs."""
    p = 300
    cfg = FWConfig(delta=DELTA, max_iters=300)
    rng = np.random.default_rng(1)
    beta0 = rng.standard_normal(p).astype(np.float32)
    i_stars, lams, dts, nps = recs_np
    n = i_stars.shape[0]
    start = dict(scale=np.float32(scale0), maxabs=np.float32(0.4), step_inf=np.float32(0.1),
                 stall=np.int32(2))
    t = {k: torch.tensor(v) for k, v in start.items()}
    recs = (torch.from_numpy(i_stars), torch.from_numpy(lams), torch.from_numpy(dts),
            torch.from_numpy(nps))
    got = fs.fused_replay(torch.from_numpy(beta0.copy()), t["scale"], t["maxabs"],
                          t["step_inf"], t["stall"], *recs, k0, cfg)
    # the per-step loop the unfused engine runs
    beta, scale, maxabs, step_inf, stall = (torch.from_numpy(beta0.copy()), t["scale"],
                                            t["maxabs"], t["step_inf"], t["stall"])
    for s in range(min(n, cfg.max_iters - k0)):
        i = recs[0][s]
        a_star = scale * beta[i]
        beta, scale, maxabs, step_inf, stall = engine.apply_coeff_update(
            beta, scale, maxabs, stall, a_star, i, recs[1][s], recs[2][s], recs[3][s], cfg)
    for g, w in zip(got, (beta, scale, maxabs, step_inf, stall)):
        assert torch.equal(g, w)
    # the reference's replay of the same records
    ref_cfg = RefConfig(delta=DELTA, max_iters=300, fuse_steps=n)
    s0 = ref_engine.init_state(REF_LASSO, jnp.zeros((p, 4)), jnp.zeros(4),
                               jax.random.PRNGKey(0), None, ref_cfg)
    s0 = s0._replace(beta=jnp.asarray(beta0), scale=jnp.float32(start["scale"]),
                     maxabs=jnp.float32(start["maxabs"]),
                     step_inf=jnp.float32(start["step_inf"]),
                     stall=jnp.int32(start["stall"]), k=jnp.int32(k0))
    rb, rs, rm, ri, rst, rk, _ = ref_engine._fused_replay(
        REF_LASSO, s0, ref_cfg, jnp.asarray(i_stars, jnp.int32), jnp.asarray(lams),
        jnp.asarray(dts), jnp.asarray(nps))
    assert int(rk) == min(k0 + n, 300) and int(rst) == int(got[4])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(rb), rtol=1e-6)
    for g, w in ((got[1], rs), (got[2], rm), (got[3], ri)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    return got


@pytest.mark.parametrize("k0", [0, 295])
def test_replay_matches_step_loop_and_reference(k0):
    """A renorm inside the chunk; k0 = 295 masks the last 3 records."""
    got = _replay_against_loop_and_reference(_records(300, 2), 3e-6, k0)
    assert float(got[1]) > 3e-6  # a renorm happened: without one the scale only shrinks


@pytest.mark.parametrize("wins,renorms", [((1, 6), (3,)), ((0, 3, 7), (0, 7))])
def test_replay_of_a_repeated_coordinate_across_renorms(wins, renorms):
    """One coordinate wins at each of ``wins`` and the scale renormalizes
    exactly at each of ``renorms`` (a renorm between two wins; and a third
    win, with renorms at the first and the last record): a later win must
    see the earlier win's coefficient, renormalized with the rest of beta
    (the CUDA replay forwards it in registers)."""
    rng = np.random.default_rng(3)
    i_stars = rng.permutation(300)[:K]
    i_stars[list(wins)] = i_stars[wins[0]]
    lams = (0.01 + 0.04 * rng.random(K)).astype(np.float32)
    for t in renorms:  # from a scale in [3e-6 * 0.95^7, 1]: under 1e-6 exactly here
        lams[t] = np.float32(0.9) if t == renorms[0] else np.float32(0.9999999)
    dts = np.where(rng.random(K) < 0.5, -DELTA, DELTA).astype(np.float32)
    nps = rng.random(K) < 0.3
    got = _replay_against_loop_and_reference((i_stars, lams, dts, nps), 3e-6, 0)
    scale = np.float32(3e-6)
    seen = []
    for t in range(K):  # the renorms happen at exactly these records
        new = np.float32(scale * np.float32(np.float32(1.0) - lams[t]))
        if new < np.float32(1e-6):
            seen.append(t)
            new = np.float32(1.0)
        scale = new
    assert tuple(seen) == renorms and float(got[1]) == float(scale)


# --------------------------------------------------------------------------
# 6. the path
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_fw_path_fused_matches_reference(prob, backend, ref_backend):
    """fw_path passes fuse_steps through: per point, the reference's fused
    path replayed from its own per-point streams."""
    Xt, y = prob
    max_iters, seed = 2000, 0
    deltas = ref_path.delta_grid(150.0, n_points=4)
    kw = dict(delta=1.0, kappa=KAPPA, max_iters=max_iters, tol=1e-4, fuse_steps=K)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path(jnp.asarray(Xt), jnp.asarray(y), deltas,
                               RefConfig(backend=ref_backend, **kw), seed=seed)
        key, streams = jax.random.PRNGKey(seed), []
        for _ in deltas:  # each point draws from a key split off the path's
            key, sub = jax.random.split(key)
            streams.append(_draw_stream(max_iters, Xt.shape[0], sub))
    res = path.fw_path(Xt, y, deltas, FWConfig(backend=backend, **kw), device="cpu",
                       sampler_fn=lambda g: convert.stream_from_reference(streams[g], "cpu"))
    assert len(res.points) == len(ref.points) == len(deltas)
    for got, want in zip(res.points, ref.points):
        assert (got.iterations, got.n_dots, got.active) == (
            want.iterations, want.n_dots, want.active)
        np.testing.assert_array_equal(got.alpha_nnz_idx, want.alpha_nnz_idx)
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
        np.testing.assert_allclose(got.l1, want.l1, rtol=1e-6)
        assert got.l1 <= got.reg * (1 + 1e-4)
    assert (res.total_iters, res.total_dots) == (ref.total_iters, ref.total_dots)
