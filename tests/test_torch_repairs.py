"""Three faults of the port, repaired, against the JAX reference on the CPU:

- F1, bf16 designs: the reference's ``tests/test_sparse.py``
  ``test_solver_dtypes`` ported, with its own bars (float32: the sparse
  solve within rel 1e-4 of the dense solve's objective; bfloat16: a finite
  objective and ||alpha||_1 <= delta * (1 + 5e-2)), on 'sparse' and on the
  dense 'kernels' backend, beside the reference's solve of the same dtype;
  and the fused chunks' explicit route for bf16 (K unfused steps);
- F2, m past the fused kernels' shared-memory caps: the route to K
  unfused steps, decided from the design's shape and dtype alone;
- F3, the sparse warm start: ``sparse_matvec`` adds each row's
  contributions in one fixed order (that of a sequential scatter-add), so
  two calls give the same bits, within the reference's tolerance of its
  X @ alpha.

Both packages see the same problem and, for the solves, the reference's
own index stream (drawn in legacy threefry mode, ROADMAP.md Queue 3 R1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FWConfig as RefConfig
from repro.core import fw_solve as ref_solve
from repro.sparse import SparseBlockMatrix as RefMatrix
from repro.sparse import ops as ref_ops

from repro_torch import convert
from repro_torch.core import FWConfig, fw_solve, vertex
from repro_torch.kernels import fused_step as fs
from repro_torch.sparse import SparseBlockMatrix
from repro_torch.sparse import ops as sparse_ops

DELTA, KAPPA, SEED = 150.0, 60, 42
# the reference's, its tolerance on ||alpha||_1 / delta - 1 (float32: also
# on the objective's relative difference from the dense solve)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.fixture(scope="module")
def sparse_problem(small_problem):
    """tests/test_sparse.py's sparse_problem: 5% density, unit columns."""
    rng = np.random.default_rng(7)
    Xt = np.ascontiguousarray(small_problem[2].X.T).copy()
    Xt[rng.random(Xt.shape) > 0.05] = 0.0
    norms = np.sqrt((Xt * Xt).sum(axis=1, keepdims=True))
    norms[norms < 1e-12] = 1.0
    Xt = (Xt / norms).astype(np.float32)
    return Xt, small_problem[2].y.astype(np.float32), RefMatrix.from_dense(Xt, block_size=128)


def _stream(p, n_steps):
    """The reference engine's uniform index stream from PRNGKey(SEED)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (KAPPA,), 0, p)

        _, draws = jax.lax.scan(body, jax.random.PRNGKey(SEED), None, length=n_steps)
    return np.asarray(draws)


def _port_design(Xt, ref_mat, backend, dtype):
    if backend == "sparse":
        return convert.sparse_from_reference(np.asarray(ref_mat.values), np.asarray(ref_mat.rows),
                                             ref_mat.p, ref_mat.m, ref_mat.block_size,
                                             ref_mat.nnz_max, "cpu").astype(dtype)
    return torch.from_numpy(Xt).to(dtype)


# --------------------------------------------------------------------------
# F1: bf16 designs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["sparse", "kernels"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_solver_dtypes(sparse_problem, backend, dtype):
    """The reference's test_solver_dtypes on the port ('sparse', and the
    dense 'kernels' backend beside it), the reference's solve of the same
    design and dtype run beside it to the same bars. In bf16 the reported
    objective is bookkeeping of bf16 terms (0.5 y.y + 0.5 S - F, each with
    8 significant bits), so the bf16 iterates are also held to their true
    objective, 0.5 ||y - X alpha||^2 in float64: within 1e-2 of the
    float32 solve's, the port's and the reference's alike."""
    Xt, y, ref_mat = sparse_problem
    jdt, tdt, tol = DTYPES[dtype]
    kw = dict(delta=DELTA, sampling="uniform", kappa=KAPPA, max_iters=1500, tol=1e-6)
    ref_design = ref_mat.astype(jdt) if backend == "sparse" else jnp.asarray(Xt).astype(jdt)
    with jax.threefry_partitionable(False):
        ref = ref_solve(ref_design, jnp.asarray(y).astype(jdt),
                        RefConfig(backend="sparse" if backend == "sparse" else "xla", **kw),
                        jax.random.PRNGKey(SEED))
        ref_x = ref_solve(jnp.asarray(Xt), jnp.asarray(y), RefConfig(**kw),
                          jax.random.PRNGKey(SEED))
    stream = convert.stream_from_reference(_stream(Xt.shape[0], 1500), "cpu")
    res = fw_solve(_port_design(Xt, ref_mat, backend, tdt), torch.from_numpy(y).to(tdt),
                   FWConfig(backend=backend, **kw), stream, device="cpu")
    assert res.alpha.dtype == tdt and res.objective.dtype == tdt
    want = float(ref_x.objective)
    for objective, alpha in ((float(res.objective), res.alpha.float().numpy()),
                             (float(ref.objective), np.asarray(ref.alpha.astype(jnp.float32)))):
        assert np.isfinite(objective)
        assert np.abs(alpha).sum() <= DELTA * (1 + tol)
        if dtype == "bfloat16":
            r = y.astype(np.float64) - alpha.astype(np.float64) @ Xt.astype(np.float64)
            assert abs(0.5 * r @ r - want) <= 1e-2 * abs(want)
    if dtype == "float32":
        assert abs(float(res.objective) - want) / abs(want) < tol


@pytest.mark.parametrize("backend", ["sparse", "kernels"])
def test_bf16_fused_chunks_run_unfused_steps(sparse_problem, backend):
    """fuse_steps = 8 on a bf16 design: K4/K7 run float32 only, so each
    chunk is K unfused steps on the same backend's kernels (the explicit
    route of ``vertex.use_fused_kernel``), bit for bit the unfused solve
    over a fixed run of 40 steps."""
    Xt, y, ref_mat = sparse_problem
    X = _port_design(Xt, ref_mat, backend, torch.bfloat16)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    stream = _stream(Xt.shape[0], 40)
    runs = {}
    for fuse in (1, 8):
        cfg = FWConfig(delta=DELTA, kappa=KAPPA, max_iters=40, tol=0.0, patience=10**9,
                       backend=backend, fuse_steps=fuse)
        assert not vertex.use_fused_kernel(cfg, X)
        runs[fuse] = fw_solve(X, yb, cfg, convert.stream_from_reference(stream, "cpu"),
                              device="cpu")
    assert runs[8].effective_fuse_steps == 8 and runs[8].iterations == 40
    assert torch.equal(runs[1].alpha, runs[8].alpha)
    assert torch.equal(runs[1].objective, runs[8].objective)


def test_mixed_dtypes_are_refused(sparse_problem):
    Xt, y, _ = sparse_problem
    with pytest.raises(TypeError, match="one dtype"):
        fw_solve(torch.from_numpy(Xt).to(torch.bfloat16), torch.from_numpy(y),
                 FWConfig(delta=DELTA, kappa=KAPPA), None, device="cpu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fw_solve(torch.from_numpy(Xt).double(), torch.from_numpy(y).double(),
                 FWConfig(delta=DELTA, kappa=KAPPA), None, device="cpu")


# --------------------------------------------------------------------------
# F2: m past the fused kernels' caps
# --------------------------------------------------------------------------


def _meta_design(layout, m, dtype=torch.float32):
    """A design of m samples with no storage (meta tensors): the route is
    decided from its shape and dtype alone."""
    if layout == "dense":
        return torch.empty((4, m), dtype=dtype, device="meta")
    vals = torch.empty((1, 4, 3), dtype=dtype, device="meta")
    return SparseBlockMatrix(vals, torch.empty((1, 4, 3), dtype=torch.int32, device="meta"),
                             4, m, 4, 3)


@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("layout,cap", [("dense", fs.M_MAX), ("sparse", fs.M_MAX_SPARSE)])
def test_fused_route_at_the_cap(layout, cap, past):
    """The fused kernel up to its layout's cap (M_MAX = 24,576 dense,
    M_MAX_SPARSE = 57,344 sparse); at cap + 1 the chunk is K unfused steps;
    a bf16 design never takes the kernel; the plain backends never do."""
    X = _meta_design(layout, cap + past)
    backend = "kernels" if layout == "dense" else "sparse"
    assert vertex.use_fused_kernel(FWConfig(delta=1.0, backend=backend), X) is (past == 0)
    assert not vertex.use_fused_kernel(FWConfig(delta=1.0, backend=backend),
                                       _meta_design(layout, cap + past, torch.bfloat16))
    plain = dict(backend="torch") if layout == "dense" else dict(backend="sparse",
                                                                 sparse_kernel=False)
    assert not vertex.use_fused_kernel(FWConfig(delta=1.0, **plain), X)
    assert vertex.fused_kernel_fits(layout == "sparse", cap + past, torch.float32) is (past == 0)


def test_fused_solve_past_the_cap_is_the_unfused_solve():
    """A fused solve at m = M_MAX + 1 on the CPU: effective_fuse_steps 8,
    bit for bit the unfused solve (a fixed run of 24 steps)."""
    g = torch.Generator().manual_seed(0)
    m = fs.M_MAX + 1
    X = torch.randn((64, m), generator=g)
    y = torch.randn(m, generator=g)
    stream = torch.randint(0, 64, (24, 16), generator=g)
    runs = {}
    for fuse in (1, 8):
        cfg = FWConfig(delta=20.0, kappa=16, max_iters=24, tol=0.0, patience=10**9,
                       backend="kernels", fuse_steps=fuse)
        runs[fuse] = fw_solve(X, y, cfg, vertex.StreamSampler(stream), device="cpu")
    assert runs[8].effective_fuse_steps == 8
    assert torch.equal(runs[1].alpha, runs[8].alpha)


# --------------------------------------------------------------------------
# F3: the sparse warm start's fixed order
# --------------------------------------------------------------------------


def _index_add_matvec(mat, beta):
    """X @ alpha as one sequential scatter-add over the nonzero features'
    slots (the route before F3's repair; sequential on the CPU)."""
    nz = torch.nonzero(beta).view(-1)
    vals = mat.values.reshape(-1, mat.nnz_max).index_select(0, nz).float()
    rows = mat.rows.reshape(-1, mat.nnz_max).index_select(0, nz).view(-1)
    out = torch.zeros(mat.m, dtype=torch.float32)
    return out.index_add_(0, rows, (vals * beta.float()[nz][:, None]).view(-1)).to(beta.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_nonzero", [0, 1, 7, 300])
def test_sparse_matvec_adds_in_a_fixed_order(sparse_problem, n_nonzero, dtype):
    """Two calls give the same bits, which are the sequential scatter-add's
    (each row's contributions in feature order), and the reference's X @
    alpha within its f32 summation tolerance."""
    Xt, _, ref_mat = sparse_problem
    mat = _port_design(Xt, ref_mat, "sparse", dtype)
    rng = np.random.default_rng(n_nonzero)
    alpha = np.zeros(Xt.shape[0], np.float32)
    alpha[rng.choice(Xt.shape[0], n_nonzero, replace=False)] = rng.standard_normal(n_nonzero)
    beta = torch.from_numpy(alpha).to(dtype)
    a, b = sparse_ops.sparse_matvec(mat, beta), sparse_ops.sparse_matvec(mat, beta)
    assert a.dtype == dtype and a.shape == (Xt.shape[1],)
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(a, _index_add_matvec(mat, beta))
    if dtype == torch.float32:
        want = np.asarray(ref_ops.sparse_matvec(ref_mat, jnp.asarray(alpha)))
        scale = np.abs(Xt).T @ np.abs(alpha) + 1e-30
        assert np.all(np.abs(a.numpy() - want) <= 1e-6 * scale)


def test_sparse_matvec_rows_shared_by_many_features():
    """Many features sharing the same rows (the warm start's collisions),
    with stored zeros: the fixed-order sum is the sequential one."""
    g = torch.Generator().manual_seed(5)
    p, m = 500, 7
    X = torch.randn((p, m), generator=g)
    X[torch.rand((p, m), generator=g) < 0.3] = 0.0
    mat = SparseBlockMatrix.from_dense(X.numpy(), block_size=128)
    mat = dataclasses.replace(mat, values=mat.values * (torch.rand(mat.values.shape,
                                                                   generator=g) < 0.9))
    beta = torch.randn(p, generator=g)
    assert torch.equal(sparse_ops.sparse_matvec(mat, beta), _index_add_matvec(mat, beta))
