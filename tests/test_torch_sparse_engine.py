"""The port's 'sparse' backend (``FWConfig(backend='sparse')`` on a
``SparseBlockMatrix``) against the JAX reference on the CPU, in one
process: solves, the fused K-step chunk (K7's plain version), the path.

Both packages get the same numpy problem and the reference's own index
stream, drawn inside ``jax.threefry_partitionable(False)`` (ROADMAP.md
Queue 3 R1) and replayed into the port with a ``StreamSampler``. The
sparse problems are the ``small_problem`` geometry of tests/test_engine.py:
stored densely as block-ELL (the reference's sparse golden), or sparsified
to 5% density and renormalized (tests/test_sparse.py's ``sparse_problem``,
p = 300 over 128-wide blocks: a partial tail block).

Tolerances, and why:
  * integer facts (iterations, n_dots, support) exact: the stream, the
    argmax and the stopping rule determine them;
  * vertex sequences exact up to their first difference, which must be a
    near-tie: two distinct sampled coordinates whose |scores| lie within
    RTOL_TIE * ||r|| (the packages sum a score's slot products in other
    orders);
  * objectives at rtol 1e-6, the tolerance of the reference's goldens;
  * the chunk against the reference's kernel and mirror as in
    tests/test_torch_fused.py: vertices and flags exact, lam, delta_t and
    the residual at rtol/atol 1e-5, (S, F) at rtol 1e-4;
  * fuse_steps=8 against fuse_steps=1 in the port: bit-identical (the
    chunk's plain version runs the unfused step's ops in its order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FWConfig as RefConfig
from repro.core import LASSO as REF_LASSO
from repro.core import engine as ref_engine
from repro.core import path as ref_path
from repro.core import vertex as ref_vertex
from repro.kernels import fused_step as ref_fs
from repro.kernels.fused_step.ref import sparse_fused_chunk_ref
from repro.obs import TelemetrySpec, ring_to_records
from repro.sparse import SparseBlockMatrix as RefMatrix

from repro_torch import convert
from repro_torch.core import LASSO, FWConfig, engine, fw_solve, path
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import launch_counts

DELTA, KAPPA, SEED, K = 150.0, 60, 42, 8
RTOL_OBJ, RTOL_TIE = 1e-6, 1e-4
FIXED = dict(sampling="uniform", max_iters=300, tol=0.0, patience=10**9)


def _draw_stream(n_steps, draw_fn, key=None):
    """The reference engine's stream: key, sub = split(key); draw(sub)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, draw_fn(sub)

        key = jax.random.PRNGKey(SEED) if key is None else key
        _, draws = jax.lax.scan(body, key, None, length=n_steps)
    return np.asarray(draws)


def _uniform(p, n_steps, key=None):
    return _draw_stream(n_steps, lambda k: jax.random.randint(k, (KAPPA,), 0, p), key)


@pytest.fixture(scope="module")
def golden(small_problem):
    """The reference's sparse golden problem: small_problem stored densely
    as block-ELL, 64-wide blocks."""
    ds = small_problem[2]
    Xt = np.ascontiguousarray(ds.X.T)
    return Xt, ds.y, RefMatrix.from_dense(Xt, block_size=64)


@pytest.fixture(scope="module")
def sparse(small_problem):
    """tests/test_sparse.py's sparse_problem: 5% density, unit columns."""
    rng = np.random.default_rng(7)
    Xt = np.ascontiguousarray(small_problem[2].X.T).copy()
    Xt[rng.random(Xt.shape) > 0.05] = 0.0
    norms = np.sqrt((Xt * Xt).sum(axis=1, keepdims=True))
    norms[norms < 1e-12] = 1.0
    Xt = (Xt / norms).astype(np.float32)
    return Xt, small_problem[2].y, RefMatrix.from_dense(Xt, block_size=128)


def _port(ref_mat):
    return convert.sparse_from_reference(np.asarray(ref_mat.values), np.asarray(ref_mat.rows),
                                         ref_mat.p, ref_mat.m, ref_mat.block_size,
                                         ref_mat.nnz_max, "cpu")


def _ref_run(ref_mat, y, alpha0=None, **kw):
    """Reference sparse solve with a telemetry ring of every step's vertex."""
    kw = dict(dict(delta=DELTA, kappa=KAPPA, backend="sparse"), **kw)
    cfg = RefConfig(telemetry=TelemetrySpec(capacity=kw["max_iters"]), **kw)
    with jax.threefry_partitionable(False):
        res = ref_engine.solve(REF_LASSO, ref_mat, jnp.asarray(y), cfg,
                               jax.random.PRNGKey(SEED),
                               None if alpha0 is None else jnp.asarray(alpha0))
    return res, np.asarray(ring_to_records(res.telemetry)["i_star"])


def _port_run(ref_mat, y, draws, alpha0=None, **kw):
    """Port sparse solve on the CPU replaying ``draws``; returns the result,
    the vertex sequence and each step's pre-step residual."""
    mat = _port(ref_mat)
    yt = torch.from_numpy(np.asarray(y, np.float32))
    kw = dict(dict(delta=DELTA, kappa=KAPPA, backend="sparse"), **kw)
    seq = []
    resid = [yt if alpha0 is None else yt - torch.from_numpy(alpha0) @ mat.to_dense()]

    def on_step(state):
        seq.extend(state.i_star.view(-1).tolist())
        resid.append(state.co.resid)

    sampler = None if draws is None else convert.stream_from_reference(draws, "cpu")
    res = fw_solve(mat, yt, FWConfig(**kw), sampler,
                   None if alpha0 is None else torch.from_numpy(alpha0), device="cpu",
                   on_step=on_step)
    return res, np.asarray(seq), resid


def _same_until_near_tie(Xt, seq, ref_seq, resid, idx_at):
    """Vertex sequences agree up to their first difference, which must be a
    near-tie on the port's pre-step residual. Returns that step (or None)."""
    n = min(len(seq), len(ref_seq))
    diff = np.nonzero(seq[:n] != ref_seq[:n])[0]
    if diff.size == 0:
        return None
    t = int(diff[0])
    idx = np.unique(idx_at(t))
    idx = idx[idx < Xt.shape[0]]
    r = resid[t].numpy().astype(np.float64)
    mags = np.sort(np.abs(Xt[idx].astype(np.float64) @ r))[::-1]
    assert mags[0] - mags[1] <= RTOL_TIE * np.linalg.norm(r), (
        f"vertex {seq[t]} vs reference {ref_seq[t]} at step {t} is no near-tie")
    return t


# --------------------------------------------------------------------------
# 1. the reference's sparse golden and solves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sparse_kernel", [None, False])
def test_sparse_golden(golden, sparse_kernel):
    """tests/test_engine.py::test_lasso_sparse_backend_golden from the
    reference's stream: 300 steps, objective 751729.375 at rtol 1e-6; the
    vertices equal the reference's sparse run's up to a near-tie after the
    25 steps of the converging run (at step 61, as on the dense backends)."""
    Xt, y, ref_mat = golden
    stream = _uniform(Xt.shape[0], 300)
    ref, ref_seq = _ref_run(ref_mat, y, **FIXED)
    before = launch_counts()
    res, seq, resid = _port_run(ref_mat, y, stream, sparse_kernel=sparse_kernel, **FIXED)
    assert launch_counts() == before  # CPU tensors: the plain versions
    assert (res.iterations, res.n_dots) == (int(ref.iterations), int(ref.n_dots)) == (300, 18000)
    np.testing.assert_allclose(float(res.objective), 751729.375, rtol=RTOL_OBJ)
    np.testing.assert_allclose(float(ref.objective), 751729.375, rtol=RTOL_OBJ)
    assert np.nonzero(res.alpha.numpy())[0].tolist() == [70, 272]
    t = _same_until_near_tie(Xt, seq, ref_seq, resid, lambda t: stream[t])
    assert t is None or t > 25


@pytest.mark.parametrize("sparse_kernel", [True, False])
@pytest.mark.parametrize("sampling", ["uniform", "block", "full"])
def test_sparse_solves_match_reference(sparse, sampling, sparse_kernel):
    """The port with its kernels on (their plain versions here) or off,
    against the reference with its Pallas kernels (interpret mode) or its
    XLA gathers. 'block' draws 2 of 3 blocks of 128, the third a tail."""
    Xt, y, ref_mat = sparse
    kw = dict(sampling=sampling, sparse_kernel=sparse_kernel, tol=1e-4, max_iters=300)
    if sampling == "block":
        kw.update(kappa=256, max_iters=80, tol=0.0, patience=10**9)
        cfg = RefConfig(delta=DELTA, **kw)
        draws = _draw_stream(80, lambda k: ref_vertex.sample_sparse_blocks(k, ref_mat, cfg))
        assert draws.shape == (80, 2) and (draws == 2).any()  # the tail block is drawn
        idx_at = lambda t: (draws[t][:, None] * 128 + np.arange(128)).reshape(-1)  # noqa: E731
    elif sampling == "uniform":
        draws = _uniform(Xt.shape[0], 300)
        idx_at = lambda t: draws[t]  # noqa: E731
    else:
        draws = None
        idx_at = lambda t: np.arange(Xt.shape[0])  # noqa: E731
    ref, ref_seq = _ref_run(ref_mat, y, **kw)
    res, seq, resid = _port_run(ref_mat, y, draws, **kw)
    assert (res.iterations, res.n_dots) == (int(ref.iterations), int(ref.n_dots))
    assert bool(res.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=RTOL_OBJ)
    _same_until_near_tie(Xt, seq, ref_seq, resid, idx_at)


def test_warm_start_and_report_gap(sparse):
    Xt, y, ref_mat = sparse
    alpha0 = np.zeros(Xt.shape[0], np.float32)
    alpha0[[int(np.argmax(np.abs(Xt @ y))), 7]] = [60.0, -40.0]  # l1 = 100 < delta
    stream = _uniform(Xt.shape[0], 300)
    kw = dict(max_iters=300, tol=1e-4, report_gap=True)
    ref, ref_seq = _ref_run(ref_mat, y, alpha0=alpha0, **kw)
    res, seq, resid = _port_run(ref_mat, y, stream, alpha0=alpha0, **kw)
    assert (res.iterations, res.n_dots) == (int(ref.iterations), int(ref.n_dots))
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=RTOL_OBJ)
    _same_until_near_tie(Xt, seq, ref_seq, resid, lambda t: stream[t])
    # the certified gap at the port's alpha, against float64 and against the
    # reference's oracle: a small difference of two large f32 terms, so held
    # to 1e-6 of their scale (tests/test_torch_engine.py)
    a64 = res.alpha.numpy().astype(np.float64)
    grad = -(Xt.astype(np.float64) @ (y - a64 @ Xt))
    scale = abs(a64 @ grad) + DELTA * np.abs(grad).max()
    exact = a64 @ grad + DELTA * np.abs(grad).max()
    want = REF_LASSO.gap(ref_mat, jnp.asarray(y), jnp.asarray(res.alpha.numpy()), DELTA)
    assert res.gap is not None and ref.gap is not None
    assert abs(float(res.gap) - exact) <= 1e-6 * scale
    assert abs(float(res.gap) - float(want)) <= 1e-6 * scale


def test_sparse_inputs_are_checked(sparse):
    Xt, y, ref_mat = sparse
    mat = _port(ref_mat)
    cfg = FWConfig(delta=DELTA, kappa=KAPPA, max_iters=3, backend="sparse")
    with pytest.raises(ValueError, match=r"y must be \(m,\)"):
        fw_solve(mat, torch.zeros(79), cfg, None, device="cpu")
    # a bf16 design solves (its state in bf16, its scalars in f32); its y
    # must share its dtype
    res = fw_solve(mat.astype(torch.bfloat16), torch.from_numpy(y).to(torch.bfloat16), cfg,
                   convert.stream_from_reference(_uniform(Xt.shape[0], 3), "cpu"), device="cpu")
    assert res.alpha.dtype == torch.bfloat16 and np.isfinite(float(res.objective))
    with pytest.raises(TypeError, match="one dtype"):
        fw_solve(mat.astype(torch.bfloat16), torch.from_numpy(y), cfg, None, device="cpu")
    values = mat.values.clone()
    values[1, 2, 0] = float("nan")
    with pytest.raises(ValueError, match="1 NaN"):
        fw_solve(dataclasses.replace(mat, values=values), torch.from_numpy(y), cfg, None,
                 device="cpu")


# --------------------------------------------------------------------------
# 2. the fused chunk (K7's plain version)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [80, 803, 16_087, 24_000, 38_000, 57_344])
def test_k7_plan_fits_shared_memory_and_keeps_the_grid_resident(m):
    """The CUDA K7's ring for every nnz_max from 1 to 1,000: the residual
    and every warp's stages (with their Metas) within the 224 KB of dynamic
    shared memory a block may take, so one block of 1024 threads an SM
    stays resident (with the runtime's 1 KB and the kernel's static
    scratch, within an SM's 228 KB); 4 stages a warp, each the pieces of a
    pair of features; a piece is a whole feature (up to 124 slots: 32
    16-byte chunks from any offset) or 96, 64 or 32 of its slots (lane k
    keeps slots k, k + 32, ... in order across pieces), in whole chunks
    from any of the 4 offsets a chunk may start it at. Up to the
    E2006-log1p m every nnz_max gets a ring, whole features at its nnz_max
    of 66; at m = M_MAX_SPARSE none fits and the residual alone fills
    512-thread blocks."""
    assert fs.M_MAX_SPARSE == 57_344
    for nnz_max in range(1, 1001):
        pl = fs.plan(m, nnz_max)
        smem = pl.smem_bytes(m)
        assert smem <= fs.SMEM_BYTES == 224 * 1024 and smem >= 4 * m
        assert smem + 1024 + 1024 <= 228 * 1024  # static scratch < 1 KB, the runtime's 1 KB
        if pl.depth:
            assert pl.threads == 1024 and pl.depth == fs.RING_DEPTH == 4
            assert (pl.slots == nnz_max <= 124
                    or (pl.slots in (96, 64, 32) and pl.slots < nnz_max))
            assert pl.stride % 4 == 0 and pl.slots + 3 <= pl.stride < pl.slots + 7
            assert -(-(3 + pl.slots) // 4) <= 32  # two 16-byte chunks a lane of a half-warp
            assert smem == 4 * (-(-m // 4) * 4) + 32 * 4 * 2 * (8 * pl.stride + 16)
        else:
            assert pl == fs.RingPlan(512, 0, 0, 0)
            assert smem == 4 * (-(-m // 4) * 4)
        if m <= 16_087:
            assert pl.depth == 4
    if m == 16_087:
        assert fs.plan(m, 66) == fs.RingPlan(1024, 4, 66, 72)
    if m == fs.M_MAX_SPARSE:
        assert fs.plan(m, 66).depth == 0


def test_k7_plan_refuses_m_past_shared_memory():
    with pytest.raises(ValueError, match="m <= 57344"):
        fs.plan(fs.M_MAX_SPARSE + 1, 66)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_mirror"])
@pytest.mark.parametrize("k0,max_iters", [(0, 10**6), (60, 66)])
def test_chunk_matches_reference_kernel(sparse, reference, k0, max_iters):
    """(60, 66) puts a refresh (k = 63) and max_iters inside the chunk."""
    Xt, y, ref_mat = sparse
    p, m = Xt.shape
    kappa = 32
    rng = np.random.default_rng(5)
    resid = rng.standard_normal(m).astype(np.float32)
    idx = rng.integers(0, p, (K, kappa)).astype(np.int32)
    zty = (Xt.astype(np.float64) @ y).astype(np.float32)
    zn2 = (Xt.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    scal = (3.0, 1.5, 0.0)
    kw = dict(eps_den=1e-12, gap_rtol=1e-6, refresh_every=64, max_iters=max_iters)
    ref_fn = (lambda *a, **k: ref_fs.sparse_fused_chunk(*a, interpret=True, **k)) \
        if reference == "pallas_interpret" else sparse_fused_chunk_ref
    want = ref_fn(ref_mat.values, ref_mat.rows, jnp.asarray(y), jnp.asarray(resid),
                  tuple(jnp.float32(s) for s in scal), jnp.asarray(idx),
                  jnp.asarray(zty[idx]), jnp.asarray(zn2[idx]), None, jnp.int32(k0),
                  jnp.float32(40.0), oracle=REF_LASSO, **kw)
    mat = _port(ref_mat)
    before = launch_counts()
    got = fs.sparse_fused_chunk(
        mat.values, mat.rows, torch.from_numpy(y), torch.from_numpy(resid),
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


@pytest.mark.parametrize("sparse_kernel", [None, False])
@pytest.mark.parametrize("problem", ["golden", "sparse"])
def test_fuse8_is_bit_identical_to_fuse1(request, problem, sparse_kernel):
    """On the CPU the fused sparse path (K7's plain version and the replay's
    with the kernels on, K unfused steps with them off) equals the unfused
    one bit for bit; 300 is not a multiple of K."""
    Xt, y, ref_mat = request.getfixturevalue(problem)
    stream = _uniform(Xt.shape[0], 304)
    kw = dict(FIXED, sparse_kernel=sparse_kernel)
    r1, s1, _ = _port_run(ref_mat, y, stream, **kw)
    r8, s8, _ = _port_run(ref_mat, y, stream, fuse_steps=K, **kw)
    assert (r1.effective_fuse_steps, r8.effective_fuse_steps) == (1, K)
    assert (r8.iterations, r8.n_dots) == (r1.iterations, r1.n_dots) == (300, 18000)
    np.testing.assert_array_equal(s8, s1)
    assert torch.equal(r8.alpha, r1.alpha)
    assert float(r8.objective) == float(r1.objective)


def test_fused_solve_matches_reference(golden):
    """The port's fused sparse solve against the reference's (its Pallas
    megakernel in interpret mode), over the 60 steps before the packages'
    near-tie: the same facts, alpha at rtol 1e-6."""
    Xt, y, ref_mat = golden
    kw = dict(FIXED, max_iters=60, fuse_steps=K, sparse_kernel=True)
    with jax.threefry_partitionable(False):
        ref = ref_engine.solve(REF_LASSO, ref_mat, jnp.asarray(y),
                               RefConfig(delta=DELTA, kappa=KAPPA, backend="sparse", **kw),
                               jax.random.PRNGKey(SEED))
    res, _, _ = _port_run(ref_mat, y, _uniform(Xt.shape[0], 64), **kw)
    assert int(ref.effective_fuse_steps) == res.effective_fuse_steps == K
    assert (res.iterations, res.n_dots) == (int(ref.iterations), int(ref.n_dots)) == (60, 3600)
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(ref.alpha), rtol=1e-6)
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=RTOL_OBJ)


# --------------------------------------------------------------------------
# 3. the path
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fuse_steps", [1, K])
def test_sparse_path_matches_reference(golden, fuse_steps):
    """Per point, the reference's sparse path replayed from its own
    per-point streams (each point's key split off the path's key), on the
    golden problem (tests/test_torch_fused.py's path: on the 5%-density
    problem the third point's stall stop is so close to its threshold that
    the reference's own 'xla' and sparse paths stop at different steps)."""
    Xt, y, ref_mat = golden
    max_iters = 2000
    deltas = ref_path.delta_grid(DELTA, n_points=4)
    kw = dict(delta=1.0, kappa=KAPPA, max_iters=max_iters, tol=1e-4, backend="sparse",
              fuse_steps=fuse_steps, report_gap=True)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path(ref_mat, jnp.asarray(y), deltas, RefConfig(**kw), seed=0)
        key, streams = jax.random.PRNGKey(0), []
        for _ in deltas:
            key, sub = jax.random.split(key)
            streams.append(_uniform(Xt.shape[0], max_iters, sub))
    res = path.fw_path(_port(ref_mat), torch.from_numpy(y), deltas, FWConfig(**kw),
                       device="cpu",
                       sampler_fn=lambda g: convert.stream_from_reference(streams[g], "cpu"))
    assert len(res.points) == len(ref.points) == len(deltas)
    for got, want in zip(res.points, ref.points):
        assert (got.iterations, got.n_dots, got.active) == (
            want.iterations, want.n_dots, want.active)
        np.testing.assert_array_equal(got.alpha_nnz_idx, want.alpha_nnz_idx)
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
        np.testing.assert_allclose(got.l1, want.l1, rtol=1e-6)
        assert got.l1 <= got.reg * (1 + 1e-4)
        assert abs(got.gap - want.gap) <= 1e-6 * got.reg * float(np.abs(Xt @ y).max())
    assert (res.total_iters, res.total_dots) == (ref.total_iters, ref.total_dots)
    np.testing.assert_allclose(
        path.lambda_grid(_port(ref_mat), torch.from_numpy(y), 5),
        ref_path.lambda_grid(ref_mat, jnp.asarray(y), 5), rtol=1e-6)


def test_sparse_path_on_default_samplers_is_reproducible(sparse):
    Xt, y, ref_mat = sparse
    deltas = path.delta_grid(100.0, n_points=3)
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=500, tol=1e-4, backend="sparse")
    a = path.fw_path(_port(ref_mat), y, deltas, cfg, seed=3, device="cpu")
    b = path.fw_path(_port(ref_mat), y, deltas, cfg, seed=3, device="cpu")
    assert [pt.objective for pt in a.points] == [pt.objective for pt in b.points]
    assert all(pt.l1 <= pt.reg * (1 + 1e-4) for pt in a.points)
    stats = engine.precompute_colstats(_port(ref_mat), torch.from_numpy(y))
    assert stats.zty.shape == (Xt.shape[0],)
