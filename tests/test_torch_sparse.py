"""The port's block-ELL sparse design (``repro_torch.sparse``, the data
proxies, and the plain versions of K5 and K6) against the JAX reference on
the CPU, in one process, from numpy inputs made from a seed.

Shapes are ragged on purpose: p is not a multiple of the block size (the
padded tail block is always there) and nnz_max is odd.

Tolerances, and why:
  * storage arrays, COO triplets, shapes, byte counts and densities are
    bit-identical: both packages run the same numpy code;
  * the f32 scores and column statistics within RTOL_SUM of their
    Cauchy-Schwarz scale ||z_i|| * ||r|| (||z_i||^2 for znorm2): both
    packages sum a feature's slot products, in orders that may differ by
    rounding (XLA's reduce against torch's);
  * argmax indices exact (the inputs have no near-ties); the residual
    update and the column accessors exact (the same ops in the same
    order); the matvecs at rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import proxies as ref_proxies
from repro.kernels.sparse_colstats.sparse_colstats import sparse_colstats_fused
from repro.kernels.sparse_grad.ref import sparse_sampled_scores_ref
from repro.kernels.sparse_grad.sparse_grad import sparse_sampled_scores
from repro.sparse import SparseBlockMatrix as RefMatrix
from repro.sparse import ops as ref_ops

from repro_torch import convert
from repro_torch.data import proxies
from repro_torch.kernels import launch_counts
from repro_torch.kernels import sparse_colstats as k6
from repro_torch.kernels import sparse_grad as k5
from repro_torch.sparse import SparseBlockMatrix
from repro_torch.sparse import ops

RTOL_SUM = 1e-5
# (p, m, block_size, density): p never a multiple of block_size
SHAPES = [(300, 80, 128, 0.06), (777, 50, 256, 0.07), (130, 41, 64, 0.2)]


def _pair(p, m, density, seed, block_size, nnz_max=None):
    """A column-sparse dense Xt, its reference and port matrices, and r."""
    rng = np.random.default_rng(seed)
    Xt = rng.standard_normal((p, m)).astype(np.float32)
    Xt[rng.random((p, m)) > density] = 0.0
    ref = RefMatrix.from_dense(Xt, block_size=block_size, nnz_max=nnz_max)
    mat = SparseBlockMatrix.from_dense(Xt, block_size=block_size, nnz_max=nnz_max)
    r = rng.standard_normal(m).astype(np.float32)
    return Xt, ref, mat, r


def _scale(Xt, r):
    """Per-feature Cauchy-Schwarz scale ||z_i|| * ||r||."""
    return np.linalg.norm(Xt.astype(np.float64), axis=1) * np.linalg.norm(r) + 1e-30


def _same_arrays(mat, ref):
    assert torch.equal(mat.values, torch.from_numpy(np.array(ref.values)))
    assert torch.equal(mat.rows, torch.from_numpy(np.array(ref.rows)))
    assert (mat.p, mat.m, mat.block_size, mat.nnz_max) == (ref.p, ref.m, ref.block_size,
                                                          ref.nnz_max)


# --------------------------------------------------------------------------
# 1. storage
# --------------------------------------------------------------------------


@pytest.mark.parametrize("p,m,bs,density", SHAPES)
def test_matrix_matches_reference(p, m, bs, density):
    Xt, ref, mat, _ = _pair(p, m, density, seed=p, block_size=bs)
    _same_arrays(mat, ref)
    assert mat.nnz_max % 2 == 1 or p != 300  # an odd ELL width in the first case
    assert (mat.shape, mat.nblocks, mat.p_padded, mat.nbytes) == (
        ref.shape, ref.nblocks, ref.p_padded, ref.nbytes)
    assert mat.p_padded > p and mat.dtype == torch.float32
    assert mat.density() == ref.density()
    assert torch.equal(mat.to_dense(), torch.from_numpy(np.asarray(ref.to_dense())))
    assert torch.equal(mat.to_dense(), torch.from_numpy(Xt))
    # from_coo_torch on the CPU gives from_coo's arrays
    feat, samp = np.nonzero(Xt)
    dev = SparseBlockMatrix.from_coo_torch(
        torch.from_numpy(samp), torch.from_numpy(feat), torch.from_numpy(Xt[feat, samp]),
        (m, p), block_size=bs)
    _same_arrays(dev, ref)


@pytest.mark.parametrize("grow", [dict(nblocks=5), dict(nnz_max=40), dict(nblocks=4, nnz_max=33)])
def test_pad_geometry_matches_reference(grow):
    _, ref, mat, _ = _pair(300, 80, 0.06, seed=1, block_size=128)
    _same_arrays(mat.pad_geometry(**grow), ref.pad_geometry(**grow))
    assert mat.pad_geometry() is mat
    with pytest.raises(ValueError, match="cannot shrink"):
        mat.pad_geometry(nblocks=mat.nblocks - 1)
    with pytest.raises(ValueError, match="cannot shrink"):
        mat.pad_geometry(nnz_max=mat.nnz_max - 1)


@pytest.mark.parametrize("constructor", ["from_coo", "from_coo_torch"])
def test_budget_and_range_errors_match(constructor):
    rng = np.random.default_rng(2)
    Xt = rng.standard_normal((64, 32)).astype(np.float32)
    Xt[rng.random(Xt.shape) > 0.5] = 0.0
    feat, samp = np.nonzero(Xt)
    vals = Xt[feat, samp]
    required = int((Xt != 0).sum(axis=1).max())

    def build(r, c, v, shape, **kw):
        if constructor == "from_coo":
            return SparseBlockMatrix.from_coo(r, c, v, shape, **kw)
        return SparseBlockMatrix.from_coo_torch(torch.as_tensor(r), torch.as_tensor(c),
                                                torch.as_tensor(v), shape, **kw)

    for fn in (lambda: build(samp, feat, vals, (32, 64), block_size=64, nnz_max=required - 1),
               lambda: RefMatrix.from_coo(samp, feat, vals, (32, 64), block_size=64,
                                          nnz_max=required - 1)):
        with pytest.raises(ValueError, match=f"nnz budget {required - 1} too small"):
            fn()
    ok = build(samp, feat, vals, (32, 64), block_size=64, nnz_max=required)
    _same_arrays(ok, RefMatrix.from_coo(samp, feat, vals, (32, 64), block_size=64,
                                        nnz_max=required))
    with pytest.raises(ValueError, match="out of range"):
        build(np.array([5]), np.array([0]), np.array([1.0], np.float32), (4, 8))
    with pytest.raises(ValueError, match="out of range"):
        build(np.array([0]), np.array([9]), np.array([1.0], np.float32), (4, 8))


def test_sparse_from_reference_and_astype():
    _, ref, mat, _ = _pair(130, 41, 0.2, seed=3, block_size=64)
    got = convert.sparse_from_reference(np.asarray(ref.values), np.asarray(ref.rows), ref.p,
                                        ref.m, ref.block_size, ref.nnz_max, "cpu")
    _same_arrays(got, ref)
    bf = mat.astype(torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf.nbytes == mat.nbytes * 6 // 8
    with pytest.raises(ValueError, match="nblocks"):
        convert.sparse_from_reference(np.asarray(ref.values), np.asarray(ref.rows), ref.p,
                                      ref.m, 32, ref.nnz_max, "cpu")


# --------------------------------------------------------------------------
# 2. data proxies
# --------------------------------------------------------------------------


def test_sparse_coo_matches_reference():
    got = proxies.make_sparse_coo(40, 3000, 0.01, 12, seed=5)
    want = ref_proxies.make_sparse_coo(40, 3000, 0.01, 12, seed=5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,scale", [("e2006-log1p", 0.001), ("e2006-tfidf", 0.01)])
def test_sparse_proxy_matches_reference(name, scale):
    got = proxies.make_sparse_proxy(name, scale=scale, seed=1, block_size=128)
    want = ref_proxies.make_sparse_proxy(name, scale=scale, seed=1, block_size=128)
    _same_arrays(got.mat, want.mat)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.coef, want.coef)
    assert got.name == want.name


def test_dense_proxy_and_budget_match_reference():
    got = proxies.make_proxy("pyrim", scale=0.01, seed=2)
    want = ref_proxies.make_proxy("pyrim", scale=0.01, seed=2)
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_array_equal(got.y, want.y)
    for name in proxies.PROXY_SPECS:
        assert proxies.dense_proxy_bytes(name, 0.5) == ref_proxies.dense_proxy_bytes(name, 0.5)
    with pytest.raises(MemoryError, match="make_sparse_proxy"):
        proxies.make_proxy("e2006-log1p")


def test_device_generator_follows_the_recipe():
    """make_sparse_wide_problem draws other numbers than numpy, with the
    same construction: unit-norm columns, ~col_density*p entries a row,
    centered y = X coef + small noise."""
    m, p = 60, 5000
    mat, y, coef = proxies.make_sparse_wide_problem(m, p, 0.002, 8, seed=4, device="cpu",
                                                    block_size=256)
    again = proxies.make_sparse_wide_problem(m, p, 0.002, 8, seed=4, device="cpu",
                                             block_size=256)[0]
    assert torch.equal(mat.values, again.values) and torch.equal(mat.rows, again.rows)
    X = mat.to_dense().double()
    norms = torch.linalg.vector_norm(X, dim=1)
    assert torch.allclose(norms[norms > 0], torch.ones(()).double(), atol=1e-6)
    per_row = (X != 0).sum(dim=0)
    assert int(per_row.min()) >= 9 and int(per_row.max()) <= 10  # 10 draws, few repeats
    assert int((coef != 0).sum()) == 8 and abs(float(y.mean())) < 1e-5
    noise = y.double() - (coef.double() @ X - float((coef.double() @ X).mean()))
    assert float(noise.abs().max()) < 0.3


# --------------------------------------------------------------------------
# 3. ops and the plain versions of K5 and K6
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,m,bs,density", SHAPES)
def test_block_scores_match_reference_kernel(p, m, bs, density, dtype):
    """K5's plain version at width bs against the reference's Pallas kernel
    in interpret mode and its XLA mirror, the tail block included."""
    Xt, ref, mat, r = _pair(p, m, density, seed=11, block_size=bs)
    if dtype == "bfloat16":  # values exactly representable in bf16, for both
        Xt = torch.from_numpy(Xt).to(torch.bfloat16).float().numpy()
        ref = RefMatrix.from_dense(Xt, block_size=bs).astype(jnp.bfloat16)
        mat = SparseBlockMatrix.from_dense(Xt, block_size=bs).astype(torch.bfloat16)
    blk = np.array([mat.nblocks - 1, 0, mat.nblocks - 1], np.int32)  # tail twice
    before = launch_counts()
    got = ops.sparse_block_scores(mat, torch.from_numpy(r), torch.from_numpy(blk)).numpy()
    assert launch_counts() == before  # CPU tensors: the plain version
    feats = (blk[:, None] * bs + np.arange(bs)).reshape(-1)
    scale = np.concatenate([_scale(Xt, r), np.ones(mat.p_padded - p)])[feats]
    pallas = sparse_sampled_scores(ref.values, ref.rows, jnp.asarray(r), jnp.asarray(blk),
                                   interpret=True)
    mirror = sparse_sampled_scores_ref(ref.values, ref.rows, jnp.asarray(r), jnp.asarray(blk))
    for want in (pallas, mirror):
        assert np.all(np.abs(got - np.asarray(want)) <= RTOL_SUM * scale)
    assert np.all(got[feats >= p] == 0)  # padded features score exactly 0
    plain = ops.sparse_block_scores(mat, torch.from_numpy(r), torch.from_numpy(blk),
                                    use_kernel=False)
    assert torch.equal(plain, torch.from_numpy(got))


@pytest.mark.parametrize("p,m,bs,density", SHAPES)
def test_width_one_scores_match_the_gather(p, m, bs, density):
    """K5 at width 1 computes the reference's XLA gather scores of uniform
    sampling, duplicate draws included."""
    Xt, ref, mat, r = _pair(p, m, density, seed=12, block_size=bs)
    idx = np.random.default_rng(0).integers(0, p, 97).astype(np.int32)
    idx[5] = idx[9]
    got = ops.sparse_gather_scores(mat, torch.from_numpy(r), torch.from_numpy(idx)).numpy()
    want = np.asarray(ref_ops.sparse_gather_scores(ref, jnp.asarray(r), jnp.asarray(idx)))
    assert np.all(np.abs(got - want) <= RTOL_SUM * _scale(Xt, r)[idx])
    pallas = sparse_sampled_scores(ref.values.reshape(-1, 1, ref.nnz_max),
                                   ref.rows.reshape(-1, 1, ref.nnz_max), jnp.asarray(r),
                                   jnp.asarray(idx), interpret=True)
    assert np.all(np.abs(got - np.asarray(pallas)) <= RTOL_SUM * _scale(Xt, r)[idx])
    assert torch.equal(torch.from_numpy(got), k5.sparse_sampled_scores(
        mat.values, mat.rows, torch.from_numpy(r), torch.from_numpy(idx), 1))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_vertices_match_reference(use_kernel):
    Xt, ref, mat, r = _pair(300, 80, 0.06, seed=13, block_size=128)
    rt, rj = torch.from_numpy(r), jnp.asarray(r)
    blk = np.array([2, 0], np.int32)
    idx = np.random.default_rng(1).integers(0, 300, 60).astype(np.int32)
    for got, want in (
        (ops.sparse_fw_vertex(mat, rt, torch.from_numpy(blk), use_kernel=use_kernel),
         ref_ops.sparse_fw_vertex(ref, rj, jnp.asarray(blk))),
        (ops.sparse_gather_vertex(mat, rt, torch.from_numpy(idx), use_kernel=use_kernel),
         ref_ops.sparse_gather_vertex(ref, rj, jnp.asarray(idx))),
    ):
        assert int(got[0]) == int(want[0])
        assert abs(float(got[1]) - float(want[1])) <= RTOL_SUM * _scale(Xt, r)[int(want[0])]
    # the padded tail never wins, even when every real score is 0
    i, g = ops.sparse_fw_vertex(mat, torch.zeros(80), torch.tensor([2]), use_kernel=use_kernel)
    assert int(i) == 256 and float(g) == 0.0
    # a score shift reaches the selection (the elastic-net's hook)
    shift = lambda ids: (ids == 5).float() * 1e6  # noqa: E731
    i, _, sel = ops.sparse_fw_vertex_general(mat, rt, torch.from_numpy(blk), extra_fn=shift,
                                             use_kernel=use_kernel)
    assert int(i) == 5 and float(sel) > 1e5


@pytest.mark.parametrize("p,m,bs,density", SHAPES)
def test_colstats_match_reference_kernel(p, m, bs, density):
    """K6's plain version against the reference's Pallas kernel in
    interpret mode (its padded output sliced) and its XLA branch."""
    Xt, ref, mat, y = _pair(p, m, density, seed=14, block_size=bs)
    zty, zn2 = ops.sparse_colstats(mat, torch.from_numpy(y))
    pz, pn = sparse_colstats_fused(ref.values, ref.rows, jnp.asarray(y), interpret=True)
    xz, xn = ref_ops.sparse_colstats(ref, jnp.asarray(y))
    n2 = (Xt.astype(np.float64) ** 2).sum(axis=1) + 1e-30
    for wz, wn in ((np.asarray(pz)[:p], np.asarray(pn)[:p]), (xz, xn)):
        assert np.all(np.abs(zty.numpy() - np.asarray(wz)) <= RTOL_SUM * _scale(Xt, y))
        assert np.all(np.abs(zn2.numpy() - np.asarray(wn)) <= RTOL_SUM * n2)
    for a, b in zip((zty, zn2), ops.sparse_colstats(mat, torch.from_numpy(y),
                                                    use_kernel=False)):
        assert torch.equal(a, b)
    assert zty.shape == (p,)
    assert torch.equal(zty, k6.sparse_colstats(mat.values, mat.rows, torch.from_numpy(y), p)[0])


def _rows_as_k6_reads(values, rows):
    """The row slots as the CUDA K6 reads them: a chunk of 4 slots whose
    values are all 0 is never fetched and reads as row 0."""
    chunks = rows.reshape(-1, 4).clone()
    chunks[(values.reshape(-1, 4) == 0).all(dim=1)] = 0
    return chunks.view(rows.shape)


@pytest.mark.parametrize("p,m,bs,density", SHAPES)
def test_colstats_with_stored_zeros_match_reference(p, m, bs, density):
    """K6's plain version on a matrix that stores explicit zeros among a
    feature's slots (feature 3 starts with a run of 8), on its own row
    slots and on them as the kernel reads them, against the reference's
    Pallas kernel (interpret mode) and XLA branch on the same COO input."""
    rng = np.random.default_rng(p + 7)
    Xt = rng.standard_normal((p, m)).astype(np.float32)
    Xt[rng.random((p, m)) > density] = 0.0
    Xt[3, 1:9] = 0.0
    feat, row = np.nonzero(Xt)
    zf, zr = np.nonzero(Xt[:, 1:] == 0)  # explicit zeros, never at row 0
    pick = rng.random(zf.size) < 0.3 * density
    run = np.arange(1, 9)  # feature 3: 8 stored zeros, then its nonzeros
    rows_ = np.concatenate([run, row, zr[pick] + 1])
    feats = np.concatenate([np.full(8, 3), feat, zf[pick]])
    vals = np.concatenate([np.zeros(8, np.float32), Xt[feat, row], np.zeros(pick.sum(), np.float32)])
    keep = np.ones(rows_.size, bool)
    keep[8:][(feats[8:] == 3) & (rows_[8:] < 9)] = False  # no duplicate of the run
    order = rng.permutation(rows_.size - 8) + 8  # zeros interleaved with the nonzeros
    order = np.concatenate([np.arange(8), order])
    rows_, feats, vals = rows_[order], feats[order], vals[order]
    keep = keep[order]
    rows_, feats, vals = rows_[keep], feats[keep], vals[keep]
    ref = RefMatrix.from_coo(rows_, feats, vals, (m, p), block_size=bs)
    mat = SparseBlockMatrix.from_coo(rows_, feats, vals, (m, p), block_size=bs)
    _same_arrays(mat, ref)
    read = _rows_as_k6_reads(mat.values, mat.rows)
    assert not torch.equal(read, mat.rows)  # some zero-valued slots had rows
    y = rng.standard_normal(m).astype(np.float32)
    pz, pn = sparse_colstats_fused(ref.values, ref.rows, jnp.asarray(y), interpret=True)
    xz, xn = ref_ops.sparse_colstats(ref, jnp.asarray(y))
    got = k6.sparse_colstats(mat.values, mat.rows, torch.from_numpy(y), p)
    got_read = k6.sparse_colstats(mat.values, read, torch.from_numpy(y), p)
    n2 = (Xt.astype(np.float64) ** 2).sum(axis=1) + 1e-30
    for wz, wn in ((np.asarray(pz)[:p], np.asarray(pn)[:p]), (xz, xn)):
        for zty, zn2 in (got, got_read):
            assert np.all(np.abs(zty.numpy() - np.asarray(wz)) <= RTOL_SUM * _scale(Xt, y))
            assert np.all(np.abs(zn2.numpy() - np.asarray(wn)) <= RTOL_SUM * n2)
    assert torch.equal(got[0], got_read[0]) and torch.equal(got[1], got_read[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [80, 16_087, 57_344, 60_000])
@pytest.mark.parametrize("nnz_max", [1, 13, 66, 67])
def test_k6_plan_fits_shared_memory(nnz_max, m, dtype):
    """The CUDA K6's tiling: tiles of 32 or 64 features (whole 16-byte
    units of values and of rows), at least one value tile in flight beside
    the one summed and the rows' lag (1 or 2 tiles), y staged up to the
    E2006-log1p m and read through L2 past it, and all of it (the 8 static
    mbarriers too) within the 227 KB of shared memory a block may take on
    an H100."""
    elem = torch.empty((), dtype=dtype).element_size()
    pl = k6.plan(m, nnz_max, elem)
    assert pl.tile_feats in (32, 64)
    assert (pl.tile_feats * nnz_max * elem) % 16 == 0 and (pl.tile_feats * nnz_max * 4) % 16 == 0
    assert pl.lag in (1, 2) and pl.lag + 2 <= pl.stages <= k6.MAX_STAGES
    assert pl.smem_bytes(nnz_max, elem) <= k6.SMEM_BYTES
    assert pl.smem_bytes(nnz_max, elem) + 8 * k6.MAX_STAGES <= 227 * 1024
    assert (pl.y_bytes >= 4 * m and pl.y_bytes % 128 == 0) if pl.y_bytes else True
    assert (pl.y_bytes > 0) == (m <= 16_087)


def test_columns_and_residual_update_match_reference():
    Xt, ref, mat, r = _pair(300, 80, 0.06, seed=15, block_size=128)
    rng = np.random.default_rng(2)
    y = rng.standard_normal(80).astype(np.float32)
    for i in (0, 137, 299):
        vals, rows = ops.sparse_column(mat, torch.tensor(i))
        wv, wr = ref_ops.sparse_column(ref, jnp.asarray(i))
        assert torch.equal(vals, torch.from_numpy(np.asarray(wv)))
        assert torch.equal(rows, torch.from_numpy(np.asarray(wr)))
        assert torch.equal(ops.sparse_column_dense(mat, i), torch.from_numpy(Xt[i]))
        lam, dt = np.float32(0.3), np.float32(-150.0)
        got = ops.sparse_residual_update(torch.from_numpy(r), torch.from_numpy(y), vals, rows,
                                         torch.tensor(lam), torch.tensor(dt))
        want = ref_ops.sparse_residual_update(jnp.asarray(r), jnp.asarray(y), wv, wr,
                                              jnp.asarray(lam), jnp.asarray(dt))
        assert torch.equal(got, torch.from_numpy(np.asarray(want)))


def test_matvecs_match_reference():
    Xt, ref, mat, r = _pair(300, 80, 0.06, seed=16, block_size=128)
    beta = np.zeros(300, np.float32)
    beta[[3, 70, 272, 299]] = [1.5, -2.0, 0.25, 4.0]
    got = ops.sparse_matvec(mat, torch.from_numpy(beta)).numpy()
    want = np.asarray(ref_ops.sparse_matvec(ref, jnp.asarray(beta)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, beta @ Xt, rtol=1e-5, atol=1e-5)
    want_t = np.asarray(ref_ops.sparse_transpose_matvec(ref, jnp.asarray(r)))
    for use_kernel in (True, False):  # K6's plain version, and the products alone
        got_t = ops.sparse_transpose_matvec(mat, torch.from_numpy(r),
                                            use_kernel=use_kernel).numpy()
        assert got_t.shape == (300,)
        assert np.all(np.abs(got_t - want_t) <= RTOL_SUM * _scale(Xt, r))
    assert not ops.sparse_matvec(mat, torch.zeros(300)).any()
