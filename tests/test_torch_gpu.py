"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips itself without a card.

This file imports neither JAX nor the reference, so it also runs where
only the port is installed; on such a machine run it without the repo's
conftest (which builds JAX fixtures):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: dot products summed in another order than the plain version
(cuBLAS, or torch's reduction over a sparse feature's slots) differ by
rounding, within RTOL_SUM of their Cauchy-Schwarz scale; the argmax, the
residual update and the fused chunk's replay are bit-exact. The fused
chunks' records (K4 and K7): vertices and stall flags exact (the inputs
have no near-ties), lam within RTOL_SUM, the residual within RTOL_SUM of
||y||. A sparse solve on the kernels against one on the plain ops:
objectives within RTOL_SUM.
"""
import dataclasses

import pytest
import torch

from repro_torch.core import LASSO, FWConfig
from repro_torch.kernels import colstats as cs
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import fw_grad as fw
from repro_torch.kernels import launch_counts
from repro_torch.kernels import residual_update as ru

RTOL_SUM = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colstats", "fw_vertex", "residual_update",
                                    "dense_fused_chunk", "fused_replay"])
def test_kernel_matches_plain_on_the_card(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    before = launch_counts()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    X = torch.randn((1000, 803), generator=g, device="cuda")
    r = torch.randn(803, generator=g, device="cuda")
    scale = float(torch.linalg.vector_norm(X, dim=1).max() * torch.linalg.vector_norm(r))
    if kernel == "colstats":
        for got, want in zip(cs.colstats(X, r), cs.colstats_plain(X, r)):
            assert float((got - want).abs().max()) <= RTOL_SUM * scale
    elif kernel == "fw_vertex":
        blk = torch.randint(0, 8, (4,), generator=g, device="cuda")
        got = fw.sampled_scores(X, r, blk, 128)
        assert float((got - fw.sampled_scores_plain(X, r, blk, 128)).abs().max()) <= RTOL_SUM * scale
        i, v = fw.vertex_argmax(got, blk, 128, 1000)
        i_p, v_p = fw.argmax_plain(got, blk, 128, 1000)
        assert int(i) == int(i_p) and float(v) == float(v_p)
    elif kernel == "residual_update":
        lam, dt = torch.tensor(0.3, device="cuda"), torch.tensor(-2.0, device="cuda")
        assert torch.equal(ru.residual_update(r, r * 2, r * 3, lam, dt),
                           ru.residual_update_plain(r, r * 2, r * 3, lam, dt))
    elif kernel == "dense_fused_chunk":
        X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
        idx = torch.randint(0, 1000, (8, 300), generator=g, device="cuda")
        zero = torch.zeros((), device="cuda")
        args = (X, r, r, (zero, zero, zero), idx, (X @ r)[idx], (X * X).sum(1)[idx], 60,
                torch.tensor(20.0, device="cuda"))
        kw = dict(oracle=LASSO, eps_den=1e-12, gap_rtol=1e-6, refresh_every=64,
                  max_iters=66)
        got, want = fs.dense_fused_chunk(*args, **kw), fs.dense_fused_chunk_plain(*args, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
        assert float((got[1] - want[1]).abs().max()) <= RTOL_SUM
        assert float((got[4] - want[4]).abs().max()) <= RTOL_SUM * float(
            torch.linalg.vector_norm(r))
    else:
        cfg = FWConfig(delta=20.0, max_iters=100)
        beta = torch.randn(1000, generator=g, device="cuda")
        recs = (torch.randint(0, 1000, (8,), generator=g, device="cuda"),
                torch.linspace(0.1, 0.8, 8, device="cuda"),
                torch.full((8,), -20.0, device="cuda"), torch.rand(8, device="cuda") < 0.5)
        start = (torch.tensor(3e-6, device="cuda"), torch.tensor(0.5, device="cuda"),
                 torch.tensor(0.1, device="cuda"), torch.tensor(1, dtype=torch.int32,
                                                                 device="cuda"))
        got = fs.fused_replay(beta.clone(), *start, *recs, 0, cfg)
        want = fs.fused_replay_plain(beta.clone(), *start, *recs, 0, cfg)
        assert all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(got, want))
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    assert sum(launched.values()) >= 1  # the kernel ran, not the plain version


def _sparse_problem(p=1000, m=803, density=0.02, block_size=128):
    """A ragged block-ELL matrix on the card: p not a multiple of the block
    size, odd m, unit-norm features."""
    from repro_torch.sparse import SparseBlockMatrix

    g = torch.Generator(device="cpu")
    g.manual_seed(1)
    X = torch.randn((p, m), generator=g)
    X[torch.rand((p, m), generator=g) > density] = 0.0
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True).clamp_min(1e-12)
    y = torch.randn(m, generator=g)
    return SparseBlockMatrix.from_dense(X, block_size=block_size).to("cuda"), y.cuda(), X.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sparse_sampled_scores", "sparse_colstats",
                                    "sparse_fused_chunk", "sparse_solve",
                                    "sparse_transpose_matvec"])
def test_sparse_kernel_matches_plain_on_the_card(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import fw_solve
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import sparse_colstats as sc
    from repro_torch.kernels import sparse_grad as sg

    before = launch_counts()
    mat, y, X = _sparse_problem()
    scale = float(torch.linalg.vector_norm(y))  # unit-norm features
    if kernel == "sparse_sampled_scores":
        for dt in (torch.float32, torch.bfloat16):
            vals = mat.values.to(dt)
            for blk, bs in ((torch.tensor([7, 0, 7], device="cuda"), 128),
                            (torch.randint(0, 1000, (300,), device="cuda"), 1)):
                got = sg.sparse_sampled_scores(vals, mat.rows, y, blk, bs)
                want = sg.sparse_sampled_scores_plain(vals, mat.rows, y, blk, bs)
                assert float((got - want).abs().max()) <= RTOL_SUM * scale
                feats = fw.block_indices(blk, bs)
                assert bool((got[feats >= 1000] == 0).all())
    elif kernel == "sparse_colstats":
        got = sc.sparse_colstats(mat.values, mat.rows, y, mat.p)
        want = sc.sparse_colstats_plain(mat.values, mat.rows, y, mat.p)
        assert float((got[0] - want[0]).abs().max()) <= RTOL_SUM * scale
        assert float((got[1] - want[1]).abs().max()) <= RTOL_SUM
    elif kernel == "sparse_transpose_matvec":  # K6's sweep against the plain products
        from repro_torch.sparse import ops

        got = ops.sparse_transpose_matvec(mat, y)
        want = ops.sparse_transpose_matvec(mat, y, use_kernel=False)
        assert float((got - want).abs().max()) <= RTOL_SUM * scale
    elif kernel == "sparse_fused_chunk":
        idx = torch.randint(0, 1000, (8, 300), device="cuda")
        zero = torch.zeros((), device="cuda")
        args = (mat.values, mat.rows, y, y, (zero, zero, zero), idx, (X @ y)[idx],
                (X * X).sum(1)[idx], 60, torch.tensor(20.0, device="cuda"))
        kw = dict(oracle=LASSO, eps_den=1e-12, gap_rtol=1e-6, refresh_every=64, max_iters=66)
        got, want = fs.sparse_fused_chunk(*args, **kw), fs.sparse_fused_chunk_plain(*args, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
        assert float((got[1] - want[1]).abs().max()) <= RTOL_SUM
        assert float((got[4] - want[4]).abs().max()) <= RTOL_SUM * scale
    else:  # a fused and an unfused sparse solve, kernels against plain ops
        for fuse in (1, 8):
            res = [fw_solve(mat, y, FWConfig(delta=5.0, kappa=100, max_iters=40, tol=0.0,
                                             patience=10**9, backend="sparse",
                                             fuse_steps=fuse, sparse_kernel=sk),
                            TorchSampler(3, "cuda"), device="cuda")
                   for sk in (None, False)]
            assert res[0].iterations == res[1].iterations == 40
            assert abs(float(res[0].objective) - float(res[1].objective)) <= RTOL_SUM * abs(
                float(res[1].objective))
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    assert launched.get(kernel, 1) >= 1 and sum(launched.values()) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_fused_chunk_launches_at_a_larger_m_after_a_smaller_one(layout):
    """The chunk's grid is cached per m; a query at a small m must not lower
    the kernel's shared memory limit below a later launch at a larger,
    already cached m (it did: "too many blocks in cooperative launch")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.sparse import SparseBlockMatrix

    kw = dict(oracle=LASSO, eps_den=1e-12, gap_rtol=1e-6, refresh_every=64, max_iters=10**6)
    zero = torch.zeros((), device="cuda")
    for m in (12_000, 80, 12_000):
        g = torch.Generator(device="cpu")
        g.manual_seed(m)
        X = torch.randn((300, m), generator=g)
        X[torch.rand((300, m), generator=g) > 50 / m] = 0.0
        X = (X / torch.linalg.vector_norm(X, dim=1, keepdim=True).clamp_min(1e-12)).cuda()
        y = torch.randn(m, generator=g).cuda()
        idx = torch.randint(0, 300, (2, 64), generator=g).cuda()
        stats = ((X @ y)[idx], (X * X).sum(1)[idx])
        if layout == "dense":
            head, fn = (X,), fs.dense_fused_chunk
        else:
            mat = SparseBlockMatrix.from_dense(X.cpu()).to("cuda")
            head, fn = (mat.values, mat.rows), fs.sparse_fused_chunk
        out = fn(*head, y, y, (zero, zero, zero), idx, *stats, 0,
                 torch.tensor(5.0, device="cuda"), **kw)
        assert out[0].shape == (2,) and bool(torch.isfinite(out[4]).all())


@pytest.mark.gpu
def test_sparse_kernels_launch_on_a_second_card():
    """K5, K6 and K7 at an m whose shared-memory residual needs the opt-in
    limit launch on a second card after the first: each device sets the
    limit for itself (a cache shared across devices left the second
    without it)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.kernels import sparse_colstats as sc
    from repro_torch.kernels import sparse_grad as sg

    mat0, y0, X0 = _sparse_problem(p=300, m=16_087, density=0.002)
    scale = float(torch.linalg.vector_norm(y0))
    zero = torch.zeros(())
    kw = dict(oracle=LASSO, eps_den=1e-12, gap_rtol=1e-6, refresh_every=64, max_iters=10**6)
    for dev in ("cuda:0", "cuda:1"):
        mat, y, X = mat0.to(dev), y0.to(dev), X0.to(dev)
        blk = torch.arange(300, device=dev)
        got = sg.sparse_sampled_scores(mat.values, mat.rows, y, blk, 1)
        want = sg.sparse_sampled_scores_plain(mat.values, mat.rows, y, blk, 1)
        assert float((got - want).abs().max()) <= RTOL_SUM * scale
        got = sc.sparse_colstats(mat.values, mat.rows, y, mat.p)[0]
        want = sc.sparse_colstats_plain(mat.values, mat.rows, y, mat.p)[0]
        assert float((got - want).abs().max()) <= RTOL_SUM * scale
        idx = blk.view(2, 150)
        z = zero.to(dev)
        out = fs.sparse_fused_chunk(mat.values, mat.rows, y, y, (z, z, z), idx, (X @ y)[idx],
                                    (X * X).sum(1)[idx], 0, torch.tensor(5.0, device=dev), **kw)
        assert out[0].device == torch.device(dev) and bool(torch.isfinite(out[4]).all())


def _ell(p, m, nnz_max, dtype, seed, block_size=128):
    """Block-ELL arrays on the card: feature f holds 0-nnz_max stored slots
    first, padding (value 0 at row 0) after, the tail features past p all
    padding; about one stored slot in ten holds an explicit 0 at its row."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pp = -(-p // block_size) * block_size
    count = torch.randint(0, nnz_max + 1, (pp, 1), generator=g, device="cuda")
    stored = torch.arange(nnz_max, device="cuda")[None, :] < count
    stored[p:] = False
    vals = torch.randn((pp, nnz_max), generator=g, device="cuda") * stored
    vals[(torch.rand((pp, nnz_max), generator=g, device="cuda") < 0.1) & stored] = 0.0
    rows = torch.randint(0, m, (pp, nnz_max), generator=g, device="cuda",
                         dtype=torch.int32) * stored
    shape = (pp // block_size, block_size, nnz_max)
    return vals.to(dtype).view(shape), rows.view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nnz_max,m,p", [
    (1, 803, 1000), (13, 803, 1000), (67, 803, 1000),  # a ragged tail past the last tile
    (67, 803, 300_001),  # many tiles a block: the ring wraps many times
    (13, 60_000, 20_000),  # y past the staging budget, read through L2
])
def test_sparse_colstats_edge_cases_on_the_card(nnz_max, m, p, dtype):
    """K6 against its plain version on stored zeros, odd nnz_max, f32 and
    bf16 and an unstaged y; two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import sparse_colstats as sc

    vals, rows = _ell(p, m, nnz_max, getattr(torch, dtype), seed=nnz_max + m)
    y = torch.randn(m, device="cuda")
    before = sc.sparse_colstats.launches
    zty, zn2 = sc.sparse_colstats(vals, rows, y, p)
    again = sc.sparse_colstats(vals, rows, y, p)
    want_z, want_n = sc.sparse_colstats_plain(vals, rows, y, p)
    assert sc.sparse_colstats.launches == before + 2
    assert torch.equal(zty, again[0]) and torch.equal(zn2, again[1])
    norms = want_n.sqrt() * float(torch.linalg.vector_norm(y))
    assert bool(((zty - want_z).abs() <= RTOL_SUM * norms).all())
    assert bool(((zn2 - want_n).abs() <= RTOL_SUM * want_n).all())


def _argmax_case(n, bs, kind, sms):
    """Scores of n sampled coordinates on the card, their sampled block
    ids, p_valid, and the expected winner's position (None: the plain
    version decides). Width 1: distinct random ids, the 5 largest masked;
    wider: every block in order ('full' sampling), the last 29 masked."""
    g = torch.Generator(device="cuda")
    g.manual_seed(n + bs)
    nb = n // bs
    if bs == 1:
        blk = torch.randperm(max(nb, 40_000), generator=g, device="cuda")[:nb]
        p_valid = int(blk.max()) - 4
    else:
        blk = torch.arange(nb, device="cuda")
        p_valid = n - 29
    scores = torch.randn(n, generator=g, device="cuda")
    ok = fw.block_indices(blk, bs) < p_valid
    valid = ok.nonzero().view(-1)
    want = None
    if kind == "tie across blocks":  # block 0's last score and block 1's first
        blocks, chunk = fw.argmax_grid(n, sms)
        a, b = (chunk - 1, chunk) if blocks > 1 else (n // 3, n - 1)
        scores[a], scores[b] = 50.0, -50.0
        want = a if bool(ok[a]) and bool(ok[b]) and a != b else None
    elif kind == "nan" and valid.numel():
        want = int(valid[valid.numel() // 2])
        scores[want] = float("nan")
        scores[int(valid[-1])] = float("nan")
    elif kind == "all masked":
        p_valid = 0
        want = 0
    return scores, blk, p_valid, want


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "tie across blocks", "nan", "all masked"])
@pytest.mark.parametrize("n,bs", [(1, 1), (31, 1), (1025, 1), (2047, 1), (2049, 1),
                                  (42_723, 1), (4_272_256, 128)])
def test_vertex_argmax_edge_cases_on_the_card(n, bs, kind):
    """The grid-wide argmax is bit-exact against its plain version, one
    launch a call, at n on either side of one block's share of scores
    (256 threads x 8) and at n = p under 'full' sampling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scores, blk, p_valid, want = _argmax_case(n, bs, kind, sms)
    before = fw.vertex_argmax.launches
    i, v = fw.vertex_argmax(scores, blk, bs, p_valid)
    i_p, v_p = fw.argmax_plain(scores, blk, bs, p_valid)
    assert fw.vertex_argmax.launches == before + 1
    assert int(i) == int(i_p)
    assert torch.equal(v.view(1), v_p.view(1)) or (bool(v.isnan()) and bool(v_p.isnan()))
    if want is not None:
        assert int(i) == int(fw.block_indices(blk, bs)[want])
    i2, v2 = fw.vertex_argmax(scores, blk, bs, p_valid)  # the counter was reset
    assert int(i2) == int(i)


def _distinct_ell(p, m, nnz_max, seed, extra_blocks=0, block_size=128):
    """A unit-norm ``SparseBlockMatrix`` on the card laid out as ``_ell``'s
    slots (stored zeros, padding), with distinct rows within a feature (as
    ``from_coo`` makes them); and the same arrays with ``extra_blocks``
    blocks of padding features appended."""
    from repro_torch.sparse import SparseBlockMatrix

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pp = -(-p // block_size) * block_size
    count = torch.randint(0, nnz_max + 1, (pp, 1), generator=g, device="cuda")
    stored = torch.arange(nnz_max, device="cuda")[None, :] < count
    stored[p:] = False
    vals = torch.randn((pp, nnz_max), generator=g, device="cuda") * stored
    vals[(torch.rand((pp, nnz_max), generator=g, device="cuda") < 0.1) & stored] = 0.0
    vals /= torch.linalg.vector_norm(vals, dim=1, keepdim=True).clamp_min(1e-30)
    rows = torch.rand((pp, m), generator=g, device="cuda").topk(nnz_max, dim=1).indices.int()
    shape = (pp // block_size, block_size, nnz_max)
    vals, rows = vals.view(shape), (rows * stored).view(shape)
    pad = torch.zeros((extra_blocks, block_size, nnz_max), device="cuda")
    ext = SparseBlockMatrix(torch.cat([vals, pad]), torch.cat([rows, pad.int()]),
                            (pp // block_size + extra_blocks) * block_size, m, block_size,
                            nnz_max)
    return SparseBlockMatrix(vals, rows, p, m, block_size, nnz_max), ext


@pytest.mark.gpu
@pytest.mark.parametrize("case,nnz_max,m,K,kappa", [
    ("odd/even ids, repeats, padded ids", 66, 803, 8, 301),
    ("nnz_max=1", 1, 803, 8, 301),
    ("nnz_max=13", 13, 803, 8, 301),
    ("a feature in 4 pieces", 300, 803, 8, 301),
    ("pieces of 32 slots", 66, 30_000, 8, 301),
    ("no ring: m = M_MAX_SPARSE", 66, 57_344, 8, 301),
    ("K=1", 66, 803, 1, 301),
    ("kappa below the grid's warps", 66, 803, 8, 7),
])
def test_sparse_fused_chunk_edge_cases_on_the_card(case, nnz_max, m, K, kappa):
    """K7 at its ring's edges (chip_smoke.py's sparse_chunk_edge_cases): two
    launches bitwise equal; against its plain version (run on a copy with
    padding appended, so that ids past the arrays, which the kernel scores 0
    without a read, have slots there), vertices and flags exact, lam within
    RTOL_SUM, the residual within RTOL_SUM of ||y||."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import sparse_colstats as sc

    p = 1000
    mat, ext = _distinct_ell(p, m, nnz_max, seed=nnz_max + m + K + kappa, extra_blocks=2)
    g = torch.Generator(device="cuda")
    g.manual_seed(kappa)
    idx = torch.randint(0, p, (K, kappa), generator=g, device="cuda")
    if case.startswith("odd/even"):
        n_feat = 1024
        idx[0, :10] = torch.tensor([3, 4, 7, 7, 10, 4, n_feat + 5, 1001, n_feat + 200, 1023],
                                   device="cuda")
        idx[1, :4] = torch.tensor([7, 4, n_feat + 5, 1002], device="cuda")
        idx[2, -3:] = torch.tensor([7, 7, n_feat + 127], device="cuda")
    y = torch.randn(m, generator=g, device="cuda")
    y *= 3.0 / torch.linalg.vector_norm(y)
    zty, zn2 = sc.sparse_colstats_plain(ext.values, ext.rows, y, ext.p)
    zero = torch.zeros((), device="cuda")
    tail = (y, y, (zero, zero, zero), idx, zty[idx], zn2[idx], 0, torch.tensor(20.0,
                                                                               device="cuda"))
    kw = dict(oracle=LASSO, eps_den=1e-12, gap_rtol=1e-6, refresh_every=64, max_iters=10**6)
    before = fs.sparse_fused_chunk.launches
    got = fs.sparse_fused_chunk(mat.values, mat.rows, *tail, **kw)
    again = fs.sparse_fused_chunk(mat.values, mat.rows, *tail, **kw)
    assert fs.sparse_fused_chunk.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got[:5] + got[5], again[:5] + again[5]))
    want = fs.sparse_fused_chunk_plain(ext.values, ext.rows, *tail, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    assert float((got[1] - want[1]).abs().max()) <= RTOL_SUM
    assert float((got[4] - want[4]).abs().max()) <= RTOL_SUM * 3.0


def _replay_case(case):
    """Records and a chunk start for the replay's edges (chip_smoke.py's
    replay_edge_cases): the start, (i_stars, lams, dts, nps), k0 and the
    final scale expected to be 1 (a renorm at the last live record) or not."""
    g = torch.Generator(device="cuda")
    g.manual_seed(len(case))
    p = 100_000
    K = 40 if case == "K=40" else 8
    i_stars = torch.randint(0, p, (K,), generator=g, device="cuda")
    lo, hi = (0.01, 0.1) if K == 40 else (0.05, 0.15)
    lams = lo + (hi - lo) * torch.rand(K, generator=g, device="cuda")
    dts = torch.where(torch.rand(K, generator=g, device="cuda") < 0.5, -50.0, 50.0)
    nps = torch.rand(K, generator=g, device="cuda") < 0.3
    scale, k0, renorm_last = 1.0, 0, False
    if case == "3 wins":
        i_stars[4] = i_stars[6] = i_stars[1]
    elif case == "K=40":
        i_stars[35] = i_stars[39] = i_stars[3]
        lams[36] = 0.9999995  # a renorm in the second batch of 32
    else:  # renorms at the first and the last record; masked: the last 3 skipped
        i_stars[3] = i_stars[7] = i_stars[0]
        lams[0], lams[7], scale = 0.75, 0.9999999, 3e-6
        k0, renorm_last = (995, False) if case == "masked tail" else (0, True)
    start = (torch.tensor(scale, device="cuda"), torch.tensor(0.4, device="cuda"),
             torch.tensor(0.1, device="cuda"), torch.tensor(2, dtype=torch.int32, device="cuda"))
    return p, start, (i_stars, lams, dts, nps), k0, renorm_last


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["3 wins", "renorm first and last", "masked tail", "K=40"])
def test_fused_replay_edge_cases_on_the_card(case):
    """The replay bit for bit against its plain version, one launch: a
    coordinate that wins 3 times (forwarded in registers), renorms at the
    first and the last record, a masked tail (k0 near max_iters), and 40
    records (two batches) with repeats across them and a renorm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    cfg = FWConfig(delta=50.0, max_iters=1000)
    p, start, recs, k0, renorm_last = _replay_case(case)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    beta = torch.randn(p, generator=g, device="cuda")
    before = fs.fused_replay.launches
    got = fs.fused_replay(beta.clone(), *start, *recs, k0, cfg)
    want = fs.fused_replay_plain(beta.clone(), *start, *recs, k0, cfg)
    assert fs.fused_replay.launches == before + 1
    assert all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(got, want))
    assert (float(got[1]) == 1.0) == renorm_last


def _bits_equal(a, b):
    """Equal bits, NaN at the same places (a NaN's payload not compared)."""
    a, b = a.reshape(-1), b.reshape(-1)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    iv = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(na, nb) and torch.equal(a.view(iv)[~na], b.view(iv)[~nb])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "lam clamped at 1", "lam clamped at 0",
                                  "renorm", "nan score"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_step_tail_matches_plain_on_the_card(layout, dtype, case):
    """The step's one-launch tail against step_tail_plain, bit for bit (the
    sparse winner's stored rows include row 0, then padding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import step_tail as st

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    p, m, i = 1000, 803, 5
    if layout == "dense":
        mat = torch.randn((p, m), generator=g, device="cuda").to(dt)
    else:
        sp, _, _ = _sparse_problem()
        vals, rows = sp.values.view(-1, sp.nnz_max).clone(), sp.rows.view(-1, sp.nnz_max).clone()
        vals[i], rows[i] = 0.0, 0
        vals[i, :3] = torch.tensor([1.5, -0.5, 2.0], device="cuda")
        rows[i, :3] = torch.tensor([17, 0, 400], dtype=torch.int32, device="cuda")
        mat = (vals.view(sp.values.shape).to(dt), rows.view(sp.rows.shape))
    kw = dict(scale=1.0, s_quad=30.0, f_lin=10.0, g=-7.5, zty=None, zn2=None)
    kw.update({"lam clamped at 1": dict(s_quad=0.0, f_lin=0.0, zty=7.5, zn2=1e-3),
               "lam clamped at 0": dict(f_lin=77.5), "renorm": dict(scale=1.2e-6),
               "nan score": dict(g=float("nan"))}.get(case, {}))
    zty = torch.randn(p, generator=g, device="cuda")
    zn2 = torch.rand(p, generator=g, device="cuda") + 0.5
    if kw["zty"] is not None:
        zty[i], zn2[i] = kw["zty"], kw["zn2"]

    def t(v):
        return torch.tensor(v, device="cuda").to(dt)

    beta = torch.randn(p, generator=g, device="cuda").to(dt)
    args = (t(kw["scale"]), t(2.0), torch.tensor(3, dtype=torch.int32, device="cuda"),
            torch.randn(m, generator=g, device="cuda").to(dt), t(kw["s_quad"]), t(kw["f_lin"]),
            torch.randn(m, generator=g, device="cuda").to(dt), zty.to(dt), zn2.to(dt),
            torch.tensor(i, device="cuda"), torch.tensor(kw["g"], device="cuda"),
            torch.tensor(5.0, device="cuda"), FWConfig(delta=5.0))
    before = st.step_tail.launches
    got = st.step_tail(mat, beta.clone(), *args)
    again = st.step_tail(mat, beta.clone(), *args)
    want = st.step_tail_plain(mat, beta.clone(), *args)
    assert st.step_tail.launches == before + 2
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert all(_bits_equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_fused_solve_past_the_cap_on_the_card(layout):
    """F2: fuse_steps = 8 at m = cap + 1 runs as K unfused steps on the
    kernels (a tail launch a step, no chunk launch), bit for bit the
    unfused solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import fw_solve
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.sparse import SparseBlockMatrix

    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    if layout == "dense":
        m, backend = fs.M_MAX + 1, "kernels"
        X = torch.randn((2048, m), generator=g, device="cuda")
    else:
        m, backend = fs.M_MAX_SPARSE + 1, "sparse"
        nnz = 24
        rows = torch.randint(0, m, (2048, nnz), generator=g, device="cuda", dtype=torch.int32)
        rows = torch.sort(rows, dim=1).values  # a feature's rows distinct (duplicates zeroed)
        keep = torch.ones_like(rows, dtype=torch.bool)
        keep[:, 1:] = rows[:, 1:] != rows[:, :-1]
        vals = torch.randn((2048, nnz), generator=g, device="cuda") * keep
        X = SparseBlockMatrix(vals.view(16, 128, nnz), (rows * keep).view(16, 128, nnz), 2048, m,
                              128, nnz)
    y = torch.randn(m, generator=g, device="cuda")
    res = {}
    for fuse in (1, 8):
        before = launch_counts()
        res[fuse] = fw_solve(X, y, FWConfig(delta=20.0, kappa=64, max_iters=40, tol=0.0,
                                            patience=10**9, backend=backend, fuse_steps=fuse),
                             TorchSampler(2, "cuda"), device="cuda")
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        assert launched["step_tail"] == 40
        assert launched["dense_fused_chunk"] == launched["sparse_fused_chunk"] == 0
    assert res[8].effective_fuse_steps == 8
    assert _bits_equal(res[1].alpha, res[8].alpha)


@pytest.mark.gpu
def test_sparse_matvec_is_deterministic_on_the_card():
    """F3: the warm start's X @ alpha, with many features sharing rows,
    gives equal bits on two calls, and the CPU's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.sparse import ops

    mat, _, _ = _sparse_problem(p=20_000, m=97, density=0.2)
    g = torch.Generator(device="cpu")
    g.manual_seed(8)
    beta = torch.randn(mat.p, generator=g) * (torch.rand(mat.p, generator=g) < 0.5)
    a = ops.sparse_matvec(mat, beta.cuda())
    b = ops.sparse_matvec(mat, beta.cuda())
    assert _bits_equal(a, b)
    assert _bits_equal(a.cpu(), ops.sparse_matvec(mat.to("cpu"), beta))


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("backend", ["kernels", "sparse"])
def test_bf16_solves_on_the_card(backend, fuse):
    """F1: a bf16 design solves on the card's kernels (fused: K unfused
    steps), feasible within the reference's 5e-2, its objective finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import fw_solve
    from repro_torch.core.vertex import TorchSampler

    mat, y, X = _sparse_problem()
    design = X.to(torch.bfloat16) if backend == "kernels" else mat.astype(torch.bfloat16)
    before = launch_counts()
    res = fw_solve(design, y.to(torch.bfloat16),
                   FWConfig(delta=5.0, kappa=100, max_iters=200, tol=1e-4, backend=backend,
                            fuse_steps=fuse), TorchSampler(1, "cuda"), device="cuda")
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    assert res.alpha.dtype == torch.bfloat16 and torch.isfinite(res.objective)
    assert float(res.alpha.float().abs().sum()) <= 5.0 * (1 + 5e-2)
    assert launched["step_tail"] == res.iterations
    assert launched["dense_fused_chunk"] == launched["sparse_fused_chunk"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [1, 128])
def test_sparse_scores_ring_keeps_the_warp_kernels_bits(bs):
    """K5's ring kernel (f32) gives the bits of the warp-per-feature kernel
    (the bf16 route), on the same f32 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import _build
    from repro_torch.kernels import sparse_grad as sg

    mat, y, _ = _sparse_problem()
    assert sg.scores_plan(torch.float32, mat.m, mat.nnz_max).depth > 0
    blk = torch.randint(0, 1000 if bs == 1 else mat.nblocks, (300 if bs == 1 else 6,),
                        device="cuda")
    got = sg.sparse_sampled_scores(mat.values, mat.rows, y, blk, bs)
    n = blk.numel() * bs
    warp = torch.empty(n, device="cuda")
    fn = _build.function("sparse_grad", "sparse_sampled_scores_launch", sg._ARGTYPES)
    err = fn(mat.values.data_ptr(), mat.rows.data_ptr(), y.data_ptr(), blk.data_ptr(),
             warp.data_ptr(), n, bs, mat.nnz_max, mat.p_padded, mat.m, 0, 0, 0, None, 1, 0, 0,
             0, 0, _build.stream(torch.device("cuda")))
    _build.check("sparse_grad", err, "sparse_sampled_scores (warps)")
    assert _bits_equal(got, warp)


# --------------------------------------------------------------------------
# the lane-axis kernels (batched delta lanes)
# --------------------------------------------------------------------------


def _lane_ids(L, frozen):
    return torch.tensor([lane for lane in range(L) if lane not in frozen], dtype=torch.int32,
                        device="cuda")


def _frozen_sets(L):
    """No lane frozen, lane 1 frozen among active ones (L > 1), every lane frozen."""
    return [set(), {1} if L > 1 else {0}, set(range(L))]


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 13])
@pytest.mark.parametrize("case", ["dense f32", "dense bf16", "dense full", "sparse ring",
                                  "sparse warps bf16", "sparse block"])
def test_lane_scores_and_argmax_equal_one_lane_launches(case, L):
    """K2's lane scores and argmax and K5's lane scores: each listed lane
    bitwise equal to the one-lane launch on its inputs; a frozen lane gets
    (-1, 0) and no launch of its own; the tickets are back at 0 (a second
    launch gives the same bits); against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import sparse_grad as sg

    g = torch.Generator(device="cuda")
    g.manual_seed(L)
    sparse = case.startswith("sparse")
    if sparse:
        mat, _, _ = _sparse_problem(m=803 if "ring" in case else 801)
        if "bf16" in case:
            mat = mat.astype(torch.bfloat16)
        m, p = mat.m, mat.p
        bs = mat.block_size if "block" in case else 1
        n_ids = 3 if bs > 1 else 500
        blk = torch.randint(0, mat.nblocks if bs > 1 else p, (L, n_ids), generator=g,
                            device="cuda")
        r = torch.randn((L, m), generator=g, device="cuda")

        def scores_one(rl, bl):
            return sg.sparse_sampled_scores(mat.values, mat.rows, rl, bl, bs)

        def scores_lanes(ids):
            return sg.sparse_sampled_scores_lanes(mat.values, mat.rows, r, blk, bs, ids)

        def scores_plain(ids):
            return sg.sparse_sampled_scores_lanes_plain(mat.values, mat.rows, r, blk, bs, ids)
    else:
        p, m = 1000, 803
        dtype = torch.bfloat16 if "bf16" in case else torch.float32
        X = torch.randn((p, m), generator=g, device="cuda").to(dtype)
        bs = 128 if "full" in case else 1
        blk = (torch.arange(-(-p // bs), device="cuda") if "full" in case
               else torch.randint(0, p, (L, 700), generator=g, device="cuda"))
        r = torch.randn((L, m), generator=g, device="cuda")

        def scores_one(rl, bl):
            return fw.sampled_scores(X, rl, bl, bs)

        def scores_lanes(ids):
            return fw.sampled_scores_lanes(X, r, blk, bs, ids)

        def scores_plain(ids):
            return fw.sampled_scores_lanes_plain(X, r, blk, bs, ids)
    scale = float(torch.linalg.vector_norm(r, dim=1).max()) * 40.0
    for frozen in _frozen_sets(L):
        ids = _lane_ids(L, frozen)
        got = scores_lanes(ids)
        i_star, g_star = fw.vertex_argmax_lanes(got, blk, bs, p, ids)
        i_again, g_again = fw.vertex_argmax_lanes(got, blk, bs, p, ids)
        assert _bits_equal(i_star, i_again) and _bits_equal(g_star, g_again)
        plain = scores_plain(ids)
        for lane in range(L):
            bl = fw.lane_blk(blk, lane)
            if lane in frozen:
                assert int(i_star[lane]) == -1 and float(g_star[lane]) == 0.0
                continue
            one = scores_one(r[lane].clone(), bl)
            assert _bits_equal(got[lane], one), (case, L, lane)
            assert float((got[lane] - plain[lane]).abs().max()) <= RTOL_SUM * scale
            i1, g1 = fw.vertex_argmax(one, bl, bs, p)
            assert int(i_star[lane]) == int(i1) and _bits_equal(g_star[lane], g1)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 13])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_lane_tail_equals_one_lane_launches(layout, dtype, L):
    """The step's lane tail: each listed lane bitwise equal to the one-lane
    launch on its row of beta and of the residual and its scalars (a renorm
    in lane 0 only); a frozen lane's outputs are its inputs and its beta row
    is untouched; against the plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import step_tail as st

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(11 + L)
    if layout == "dense":
        p, m = 1000, 803
        mat = torch.randn((p, m), generator=g, device="cuda").to(dt)
    else:
        sp, _, _ = _sparse_problem(m=5003)
        sp = sp.astype(dt)
        p, m = sp.p, sp.m
        mat = (sp.values, sp.rows)
    cfg = FWConfig(delta=20.0)
    y = torch.randn(m, generator=g, device="cuda").to(dt)
    zty = torch.randn(p, generator=g, device="cuda").to(dt)
    zn2 = (torch.rand(p, generator=g, device="cuda") + 0.5).to(dt)
    beta = torch.randn((L, p), generator=g, device="cuda").to(dt)
    scale = torch.full((L,), 0.9, device="cuda").to(dt)
    scale[0] = 1.01e-6  # lane 0's step renormalizes (lam above 1%)
    maxabs = (torch.rand(L, generator=g, device="cuda") + 1).to(dt)
    step_inf = torch.rand(L, generator=g, device="cuda").to(dt)
    stall = torch.arange(L, dtype=torch.int32, device="cuda")
    resid = torch.randn((L, m), generator=g, device="cuda").to(dt)
    s_quad = (torch.rand(L, generator=g, device="cuda") * 30 + 10).to(dt)
    f_lin = (torch.rand(L, generator=g, device="cuda") * 10).to(dt)
    i_star = torch.randint(0, p, (L,), generator=g, device="cuda")
    gs = torch.randn(L, generator=g, device="cuda") * 5
    delta = torch.full((L,), 20.0, device="cuda")
    for frozen in _frozen_sets(L):
        ids = _lane_ids(L, frozen)
        b_k, b_p = beta.clone(), beta.clone()
        args = (scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, zty, zn2, i_star, gs,
                delta, ids, cfg)
        got = st.step_tail_lanes(mat, b_k, *args)
        want = st.step_tail_lanes_plain(mat, b_p, *args)
        for a, b in zip(got, want):
            assert _bits_equal(a, b), (layout, dtype, L, frozen)
        for lane in range(L):
            if lane in frozen:
                assert _bits_equal(b_k[lane], beta[lane])
                for out, inp in zip(got[1:], (scale, maxabs, step_inf, stall, resid, s_quad,
                                              f_lin)):
                    assert _bits_equal(out[lane], inp[lane])
                continue
            b1 = beta[lane].clone()
            one = st.step_tail(mat, b1, scale[lane].clone(), maxabs[lane].clone(),
                               stall[lane].clone(), resid[lane].clone(), s_quad[lane].clone(),
                               f_lin[lane].clone(), y, zty, zn2, i_star[lane].clone(),
                               gs[lane].clone(), delta[lane].clone(), cfg)
            assert _bits_equal(b_k[lane], b1)
            for out, o1 in zip(got[1:], one[1:]):
                assert _bits_equal(out[lane], o1), (layout, dtype, L, lane)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("backend", ["kernels", "sparse"])
def test_batched_lanes_equal_sequential_solves_on_the_card(backend, fuse):
    """solve_batched on the card: each lane bitwise the sequential solve
    replaying its stream (alpha, iterations, n_dots, the vertex sequence),
    one lane frozen early; one launch of each lane kernel a batched step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import LASSO, LaneStreamSampler, StreamSampler, engine

    mat, y, X = _sparse_problem()
    design = mat if backend == "sparse" else X
    cfg = FWConfig(delta=1.0, kappa=100, max_iters=300, tol=1e-4, backend=backend,
                   fuse_steps=fuse)
    deltas = [0.5, 5.0, 20.0]
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    draws = [torch.randint(0, mat.p, (300, 100), generator=g, device="cuda") for _ in deltas]
    seqs, steps = [[] for _ in deltas], [0]

    def on_step(state, active):
        steps[0] += 1
        for lane, a in enumerate(active):
            if a:
                seqs[lane].append(int(state.i_star[lane]))

    before = launch_counts()
    res, saved = engine.solve_batched(LASSO, design, y, cfg, LaneStreamSampler(draws), None,
                                      deltas, device="cuda", on_step=on_step)
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    scores = "sparse_sampled_scores_lanes" if backend == "sparse" else "sampled_scores_lanes"
    assert launched[scores] == launched["vertex_argmax_lanes"] == steps[0]
    assert launched["step_tail_lanes"] == steps[0]
    assert launched["sampled_scores"] == launched["sparse_sampled_scores"] == 0
    assert min(res.iterations) < max(res.iterations) and saved > 0
    for lane, d in enumerate(deltas):
        seq = []
        one = engine.solve(LASSO, design, y, cfg, StreamSampler(draws[lane]), None, d,
                           device="cuda", per_step=lambda s: seq.append(int(s.i_star)))
        assert one.iterations == res.iterations[lane] and one.n_dots == res.n_dots[lane]
        assert seq == seqs[lane]
        assert _bits_equal(one.alpha, res.alpha[lane])


# --------------------------------------------------------------------------
# the elastic-net's instantiations: the shifted argmax, the EN tail, K4/K7
# with the alpha ledger; the elastic-net and logistic solves on the card
# --------------------------------------------------------------------------


def _shift_case(case, dtype, g, p=1000):
    """(scores, blk, bs, ScoreShift) of a shifted-argmax case."""
    n_blk, bs = 700, 1
    scores = torch.randn(n_blk, generator=g, device="cuda")
    blk = torch.randint(0, p, (n_blk,), generator=g, device="cuda")
    beta = torch.randn(p, generator=g, device="cuda")
    if case == "shift turns the winner":
        scores.fill_(0.1)
        scores[3] = 1.0
        beta[blk[600]] = 10.0
    elif case == "raw all zero":
        scores.zero_()
    elif case == "padded index would win":
        bs = 128
        blk = torch.tensor([2, 7], device="cuda")  # block 7 holds 896..1023: 1000.. padding
        scores = torch.randn(256, generator=g, device="cuda") * 0.01
        scores[200] = 100.0  # index 1000 >= p
        beta[p - 1] = 1e3
    elif case == "full":
        bs = 128
        blk = torch.arange(-(-p // bs), device="cuda")
        scores = torch.randn(blk.numel() * bs, generator=g, device="cuda")
    shift = fw.ScoreShift(beta.to(getattr(torch, dtype)), torch.tensor(0.7, device="cuda"), 1.0)
    return scores, blk, bs, shift


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "shift turns the winner", "raw all zero",
                                  "padded index would win", "full"])
def test_shifted_argmax_matches_plain_on_the_card(case, dtype):
    """K2's argmax with the elastic-net's shift against its plain version,
    bit for bit (i_star, g_raw, g_sel); a padded index never wins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    scores, blk, bs, shift = _shift_case(case, dtype, g)
    before = fw.vertex_argmax_shifted.launches
    got = fw.vertex_argmax_shifted(scores, blk, bs, 1000, shift)
    again = fw.vertex_argmax_shifted(scores, blk, bs, 1000, shift)
    want = fw.argmax_shifted_plain(scores, blk, bs, 1000, shift)
    assert fw.vertex_argmax_shifted.launches == before + 2
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert all(_bits_equal(a, b) for a, b in zip(got, again))
    assert int(got[0]) < 1000


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 13])
def test_shifted_argmax_lanes_equal_one_lane_launches(L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    g = torch.Generator(device="cuda")
    g.manual_seed(L)
    p, n = 1000, 700
    scores = torch.empty((L, -(-n // 4) * 4), device="cuda")[:, :n]
    scores.copy_(torch.randn((L, n), generator=g, device="cuda"))
    blk = torch.randint(0, p, (L, n), generator=g, device="cuda")
    shift = fw.ScoreShift(torch.randn((L, p), generator=g, device="cuda"),
                          torch.rand(L, generator=g, device="cuda") + 0.5, 2.0)
    for frozen in _frozen_sets(L):
        ids = _lane_ids(L, frozen)
        got = fw.vertex_argmax_shifted_lanes(scores, blk, 1, p, ids, shift)
        want = fw.argmax_shifted_lanes_plain(scores, blk, 1, p, ids, shift)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))
        for lane in set(range(L)) - frozen:
            one = fw.vertex_argmax_shifted(scores[lane].contiguous(), blk[lane], 1, p,
                                           shift.lane(lane))
            assert all(_bits_equal(a[lane], b) for a, b in zip(got, one))


def _en_tail_args(layout, dtype, renorm, g, p=1000, m=803, i=5):
    dt = getattr(torch, dtype)
    if layout == "dense":
        mat = torch.randn((p, m), generator=g, device="cuda").to(dt)
    else:
        sp, _, _ = _sparse_problem()
        mat = (sp.values.to(dt), sp.rows)

    def t(v):
        return torch.tensor(v, device="cuda").to(dt)

    beta = torch.randn(p, generator=g, device="cuda").to(dt)
    args = (t(1.2e-6 if renorm else 0.8), t(2.0), torch.tensor(3, dtype=torch.int32, device="cuda"),
            torch.randn(m, generator=g, device="cuda").to(dt), t(30.0), t(10.0),
            torch.randn(m, generator=g, device="cuda").to(dt),
            torch.randn(p, generator=g, device="cuda").to(dt),
            (torch.rand(p, generator=g, device="cuda") + 0.5).to(dt),
            torch.tensor(i, device="cuda"), torch.tensor(-7.5, device="cuda"),
            torch.tensor(5.0, device="cuda"), FWConfig(delta=5.0))
    return mat, beta, args


@pytest.mark.gpu
@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_en_tail_matches_plain_on_the_card(layout, dtype, renorm):
    """The elastic-net's tail against step_tail_plain with ``en``, bit for
    bit, Q included; two launches equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import step_tail as st

    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    mat, beta, args = _en_tail_args(layout, dtype, renorm, g)
    en = st.ENTail(torch.tensor(-3.25, device="cuda"),
                   torch.tensor(40.0, device="cuda").to(getattr(torch, dtype)), 1.0)
    before = st.step_tail_en.launches
    got = st.step_tail_en(mat, beta.clone(), *args, en=en)
    again = st.step_tail_en(mat, beta.clone(), *args, en=en)
    want = st.step_tail_plain(mat, beta.clone(), *args, en=en)
    assert st.step_tail_en.launches == before + 2 and len(got) == 9
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert all(_bits_equal(a, b) for a, b in zip(got, again))
    assert (float(got[1]) == 1.0) == renorm


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 13])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_en_tail_lanes_equal_one_lane_launches(layout, L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import step_tail as st

    g = torch.Generator(device="cuda")
    g.manual_seed(L)
    mat, beta, args = _en_tail_args(layout, "float32", False, g)
    (scale, maxabs, stall, resid, s_quad, f_lin, y, zty, zn2, i, gr, delta, cfg) = args
    lanes = [torch.stack([x.clone() for _ in range(L)]) for x in (scale, maxabs)]
    state = dict(scale=lanes[0], maxabs=lanes[1], step_inf=torch.rand(L, device="cuda"),
                 stall=torch.full((L,), 2, dtype=torch.int32, device="cuda"),
                 resid=torch.randn((L, resid.numel()), generator=g, device="cuda"),
                 s_quad=torch.full((L,), 30.0, device="cuda"),
                 f_lin=torch.full((L,), 10.0, device="cuda"),
                 i_star=torch.randint(0, 1000, (L,), generator=g, device="cuda"),
                 g=torch.randn(L, generator=g, device="cuda") * 5,
                 delta=torch.full((L,), 5.0, device="cuda"))
    state["scale"][0] = 1.2e-6  # a renorm in lane 0 only
    en = st.ENTail(state["g"] + 0.5, torch.full((L,), 40.0, device="cuda"), 1.0)
    betas = torch.randn((L, 1000), generator=g, device="cuda")
    order = ("scale", "maxabs", "step_inf", "stall", "resid", "s_quad", "f_lin")
    for frozen in _frozen_sets(L):
        ids = _lane_ids(L, frozen)
        b_k, b_p = betas.clone(), betas.clone()
        lane_args = [state[k] for k in order] + [y, zty, zn2, state["i_star"], state["g"],
                                                 state["delta"]]
        got = st.step_tail_en_lanes(mat, b_k, *lane_args, ids, cfg, en=en)
        want = st.step_tail_lanes_plain(mat, b_p, *lane_args, ids, cfg, en=en)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))
        for lane in set(range(L)) - frozen:
            b1 = betas[lane].clone()
            one = st.step_tail_en(mat, b1, state["scale"][lane].clone(),
                                  state["maxabs"][lane].clone(), state["stall"][lane].clone(),
                                  state["resid"][lane].clone(), state["s_quad"][lane].clone(),
                                  state["f_lin"][lane].clone(), y, zty, zn2,
                                  state["i_star"][lane].clone(), state["g"][lane].clone(),
                                  state["delta"][lane].clone(), cfg,
                                  en=st.ENTail(en.g_sel[lane].clone(), en.q_norm[lane].clone(),
                                               1.0))
            assert _bits_equal(got[0][lane], one[0])
            assert all(_bits_equal(a[lane], b) for a, b in zip(got[1:], one[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_en_fused_chunk_matches_plain_on_the_card(layout, repeat):
    """K4/K7 with the alpha ledger against the plain chunk: vertices and
    stall flags exact, lam within RTOL_SUM, the residual within RTOL_SUM of
    ||y||, Q within RTOL_SUM of its scale; two launches bitwise equal;
    ``repeat`` makes one coordinate win in steps 0 and 2 (two ledger slots
    add when it is scored again)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import ENOracle

    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    p, m, K, kappa = 1000, 803, 8, 300
    if layout == "dense":
        X = torch.randn((p, m), generator=g, device="cuda")
        X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
        head, chunk, plain = (X,), fs.dense_fused_chunk_en, fs.dense_fused_chunk_plain
        zn2_all = (X * X).sum(1)
    else:
        from repro_torch.kernels.sparse_colstats import sparse_colstats_plain

        sp, _, _ = _sparse_problem()
        head = (sp.values, sp.rows)
        chunk, plain = fs.sparse_fused_chunk_en, fs.sparse_fused_chunk_plain
        m = sp.m
        zn2_all = sparse_colstats_plain(sp.values, sp.rows, torch.zeros(m, device="cuda"), sp.p)[1]
    y = torch.randn(m, generator=g, device="cuda")
    idx = torch.randint(0, p, (K, kappa), generator=g, device="cuda")
    alpha_s = torch.randn((K, kappa), generator=g, device="cuda") * 0.1
    if repeat:
        idx[[0, 2]] = 17
        idx[:, 0] = 17
        alpha_s[:, 0] = 0.05
        alpha_s[[0, 2]] = 0.05
    zty = torch.randn(p, generator=g, device="cuda")
    scal = tuple(torch.tensor(v, device="cuda") for v in (3.0, 1.5, 0.7))
    args = (*head, y, y, scal, idx, zty[idx], zn2_all[idx], 0, torch.tensor(20.0, device="cuda"))
    kw = dict(oracle=ENOracle(l2=1.0), eps_den=1e-12, gap_rtol=1e-6, refresh_every=64,
              max_iters=10**6, alpha_s=alpha_s)
    got, again = chunk(*args, **kw), chunk(*args, **kw)
    want = plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got[:5] + got[5], again[:5] + again[5]))
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    assert float((got[1] - want[1]).abs().max()) <= RTOL_SUM
    assert float((got[4] - want[4]).abs().max()) <= RTOL_SUM * float(torch.linalg.vector_norm(y))
    scale = sum(abs(float(x)) for x in want[5]) + float(y @ y)
    assert max(abs(float(a) - float(b)) for a, b in zip(got[5], want[5])) <= RTOL_SUM * scale
    if repeat:
        assert int((got[0] == 17).sum()) >= 2


@pytest.mark.gpu
def test_en_fused_chunk_sizes_its_ledger_from_k_on_the_card():
    """K4 with a 70-slot ledger (its dynamic shared memory sized from K)
    against the plain chunk: vertices and stall flags exact, lam within
    RTOL_SUM; its records carry each step's gap, gap scale and Q, whose
    stall test is the record's flag, and Q before step 0 is the chunk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import ENOracle

    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    p, m, K, kappa = 1000, 803, 70, 200
    X = torch.randn((p, m), generator=g, device="cuda")
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    y = torch.randn(m, generator=g, device="cuda")
    idx = torch.randint(0, p, (K, kappa), generator=g, device="cuda")
    alpha_s = torch.randn((K, kappa), generator=g, device="cuda") * 0.1
    zty, zn2 = X @ y, (X * X).sum(1)
    scal = tuple(torch.tensor(v, device="cuda") for v in (3.0, 1.5, 0.7))
    args = (X, y, y, scal, idx, zty[idx], zn2[idx], 0, torch.tensor(20.0, device="cuda"))
    kw = dict(oracle=ENOracle(l2=1.0), eps_den=1e-12, gap_rtol=1e-6, refresh_every=64,
              max_iters=10**6, alpha_s=alpha_s)
    got = fs.dense_fused_chunk_en(*args, **kw)
    want = fs.dense_fused_chunk_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    assert float((got[1] - want[1]).abs().max()) <= RTOL_SUM
    recs = got[1].as_strided((K, fs.REC), (fs.REC, 1)).cpu()
    rtol = torch.tensor(1e-6, dtype=torch.float32)
    assert torch.equal(recs[:, 4] == 1.0, recs[:, 5] <= rtol * recs[:, 6])
    assert float(recs[0, 7]) == float(scal[2])


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("oracle", ["elasticnet", "logistic"])
@pytest.mark.parametrize("backend", ["kernels", "sparse"])
def test_extension_solves_on_the_card(backend, oracle, fuse):
    """An elastic-net or logistic solve on the kernels against the plain
    route ('torch', or the plain sparse ops) from the same stream: the same
    iterations, objectives within RTOL_SUM (1e-3 relative for a fused EN
    chunk: the ledger reassociates); the launches of the oracle's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import ENOracle, LOGISTIC, StreamSampler, engine
    from repro_torch.sparse import SparseBlockMatrix

    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    p, m = 2000, 500
    X = torch.randn((p, m), generator=g, device="cuda")
    X[torch.rand((p, m), generator=g, device="cuda") < 0.7] = 0.0
    w = torch.zeros(p, device="cuda")
    w[:10] = torch.randn(10, generator=g, device="cuda")
    y = w @ X + 0.1 * torch.randn(m, generator=g, device="cuda")
    orc = ENOracle(l2=1.0) if oracle == "elasticnet" else LOGISTIC
    if oracle == "logistic":
        y = torch.sign(y) + (y == 0).float()
    design = (SparseBlockMatrix.from_dense(X.cpu(), block_size=128).to("cuda")
              if backend == "sparse" else X)
    draws = torch.randint(0, p, (400, 100), generator=g, device="cuda")
    kw = dict(delta=5.0, kappa=100, max_iters=400, tol=0.0, patience=10**9, fuse_steps=fuse)
    before = launch_counts()
    res = engine.solve(orc, design, y, FWConfig(backend=backend, **kw), StreamSampler(draws))
    after = launch_counts()
    plain_cfg = FWConfig(backend="sparse", sparse_kernel=False, **kw) if backend == "sparse" \
        else FWConfig(backend="torch", **kw)
    ref = engine.solve(orc, design, y, plain_cfg, StreamSampler(draws))
    assert res.iterations == ref.iterations == 400
    tol = 1e-3 if (oracle == "elasticnet" and fuse > 1) else RTOL_SUM
    assert abs(float(res.objective) - float(ref.objective)) <= tol * abs(float(ref.objective))
    used = {k for k in after if after[k] > before[k]}
    if oracle == "elasticnet" and fuse > 1:
        assert ("dense_fused_chunk_en" if backend == "kernels" else "sparse_fused_chunk_en") in used
    elif oracle == "elasticnet":
        assert {"vertex_argmax_shifted", "step_tail_en"} <= used
    else:
        assert "vertex_argmax" in used and not {"step_tail", "step_tail_en"} & used


@pytest.mark.gpu
@pytest.mark.parametrize("oracle", ["elasticnet", "logistic"])
def test_extension_lanes_equal_sequential_solves_on_the_card(oracle):
    """Batched elastic-net lanes are their sequential replays bit for bit on
    the card (the lane kernels); logistic lanes to RTOL_SUM (the card's
    reductions over a stack of rows may round otherwise than over one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import ENOracle, LOGISTIC, LaneStreamSampler, StreamSampler, engine

    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    p, m = 2000, 500
    X = torch.randn((p, m), generator=g, device="cuda")
    y = X[:5].sum(0) + 0.1 * torch.randn(m, generator=g, device="cuda")
    orc = ENOracle(l2=1.0) if oracle == "elasticnet" else LOGISTIC
    if oracle == "logistic":
        y = torch.sign(y) + (y == 0).float()
    cfg = FWConfig(delta=1.0, kappa=100, max_iters=200, tol=1e-4)
    draws = [torch.randint(0, p, (200, 100), generator=g, device="cuda") for _ in range(3)]
    deltas = [1.0, 5.0, 20.0]
    res, _ = engine.solve_batched(orc, X, y, cfg, LaneStreamSampler(draws), None, deltas)
    for lane, d in enumerate(deltas):
        one = engine.solve(orc, X, y, cfg, StreamSampler(draws[lane]), None, d)
        assert one.iterations == res.iterations[lane]
        if oracle == "elasticnet":
            assert _bits_equal(one.alpha, res.alpha[lane])
        else:
            assert abs(float(one.objective) - float(res.objective[lane])) <= RTOL_SUM * abs(
                float(one.objective))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", ["lasso", "en"])
def test_dir_tail_edge_cases_on_the_card(layout, dtype, oracle):
    """The away and pairwise rules' direction tail (``dir_tail``,
    ``dir_tail_en``) against ``dir_tail_plain`` on chip_smoke.py's phase-2
    cases (an away step, a pairwise one, a drop, i_f == i_a, an empty
    buffer, zero-weight atoms, a renorm, a refresh, a full buffer taking a
    new atom), on three blocks of the grid (m = 9,000): vertices, stall, the
    buffer and a drop's zero exact, the rest within RTOL_SUM of its scale,
    two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.data import make_sparse_wide_problem

    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    m = 9_000
    if layout == "sparse":
        mat, _, _ = make_sparse_wide_problem(m, 20_000, 0.01, 50, seed=1, device="cuda",
                                             block_size=256)
    else:
        mat = torch.randn((20_000, m), generator=g, device="cuda")
        mat /= torch.linalg.vector_norm(mat, dim=1, keepdim=True)
    dt = getattr(torch, dtype)
    if dt == torch.bfloat16:
        mat = mat.astype(dt) if layout == "sparse" else mat.to(dt)
    y = torch.randn(m, generator=g, device="cuda")
    for case in chip_smoke.DIR_CASES:
        beta, kw, en, want = chip_smoke.dir_tail_case(torch, mat, y, case, g,
                                                      None if oracle == "lasso" else 1.0, dt)
        chip_smoke.check_dir_tail(torch, case, mat, beta, kw, en, want)


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("m", [74, 186, 800, 20_000, 60_000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["cyclic", "stochastic", "lam_zero", "above_lam_max", "warm",
                                  "zero_column"])
def test_cd_sweep_matches_plain_on_the_card(m, dtype, kind):
    """The baselines' CD sweep (``kernels/cd_sweep``) against its plain loop
    on chip_smoke.py's phase-2 cases: every route of ``sweep_plan`` (the
    residual in registers at m = 74, 186, 800, in shared memory at 20,000,
    in device memory at 60,000), a stochastic order with repeats inside the
    ring's window and back to back, lam = 0 and above lam_max, a warm start,
    a zero column; alpha and R within TOL_CD of their scales, the support
    equal up to named near-ties, two launches bitwise equal. Each sweep
    counts one launch, and only the kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import cd_sweep as cds

    cs = _chip_smoke()
    g = torch.Generator(device="cuda")
    g.manual_seed(m)
    p = 1000 if m <= 800 else 100
    X, zn2, alpha0, R0, lam, order, y_norm = cs._cd_case(torch, g, torch.device("cuda"), m, p,
                                                         getattr(torch, dtype), kind)
    before = cds.cd_sweep.launches
    cs.check_cd_sweep(torch, f"m={m} {dtype} {kind}", X, zn2, alpha0, R0, lam, order, y_norm,
                      nothing_moves=kind == "above_lam_max")
    assert cds.cd_sweep.launches == before + 2  # the plain loop counts none


@pytest.mark.gpu
def test_cd_sweep_never_falls_back_on_the_card():
    """A CUDA tensor launches the kernel or raises: a float64 alpha, an int32
    order and a misaligned bf16 design are refused, not run plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import cd_sweep as cds

    X = torch.randn((64, 74), device="cuda")
    zn2, R = (X * X).sum(1), torch.randn(74, device="cuda")
    before = cds.cd_sweep.launches
    with pytest.raises(TypeError):
        cds.cd_sweep(X, torch.zeros(64, dtype=torch.float64, device="cuda"), R, zn2, 1.0)
    with pytest.raises(ValueError):
        cds.cd_sweep(X, torch.zeros(64, device="cuda"), R, zn2, 1.0,
                     torch.zeros(64, dtype=torch.int32, device="cuda"))
    Xb = torch.zeros(64 * 75 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(64, 75)
    with pytest.raises(ValueError, match="aligned"):
        cds.cd_sweep(Xb, torch.zeros(64, device="cuda"), torch.zeros(75, device="cuda"), zn2, 1.0)
    with pytest.raises(ValueError):
        cds.cd_sweep(X, torch.zeros(64), R, zn2, 1.0)  # a CPU alpha beside CUDA tensors
    assert cds.cd_sweep.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("stochastic", [False, True])
def test_cd_solve_on_the_card_matches_the_plain_route(stochastic):
    """A whole CD solve and a FISTA solve on the card: the sweeps launch the
    kernel once each, and the plain route on CPU copies of the same inputs
    (and the same orders) gives the same sweeps, support and objective to
    rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import CDConfig, FISTAConfig, baselines
    from repro_torch.kernels import cd_sweep as cds

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    X = torch.randn((2000, 74), generator=g, device="cuda")
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    y = X[:10].sum(0) * 3 + 0.1 * torch.randn(74, generator=g, device="cuda")
    cfg = CDConfig(lam=float((X @ y).abs().max()) / 10, tol=1e-4, stochastic=stochastic)
    orders = [torch.randint(0, 2000, (2000,), generator=g, device="cuda") for _ in range(200)]
    before = cds.cd_sweep.launches
    gpu = baselines.cd_solve(X, y, cfg, (lambda s: orders[s]) if stochastic else None)
    assert cds.cd_sweep.launches - before == gpu.iterations
    cpu = baselines.cd_solve(X.cpu(), y.cpu(), cfg,
                             (lambda s: orders[s].cpu()) if stochastic else None)
    assert gpu.iterations == cpu.iterations and gpu.active == cpu.active
    assert abs(float(gpu.objective) - float(cpu.objective)) <= 1e-5 * float(cpu.objective)
    fi = baselines.fista_solve(X, y, FISTAConfig(lam=cfg.lam, tol=1e-4), seed=0)
    pen = lambda r: float(r.objective) + cfg.lam * float(r.alpha.abs().sum())  # noqa: E731
    assert abs(pen(fi) - pen(gpu)) <= 1e-3 * pen(gpu)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_tel_kernels_match_plain_on_the_card(layout):
    """The TEL instantiations (the step tail's four, the replay) bit for bit
    their plain versions, ring words and device cursors included
    (chip_smoke.py's phase-2 cases at a small size): the tail in f32 and
    bf16, lasso and EN, the objective on and off, across the ring's wrap;
    the lane tails at 3 and 13 lanes with a frozen lane; the replay at K = 8
    with a renorm, a repeated winner and a masked tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import step_tail as st

    cs = _chip_smoke()
    mat, y, X = _sparse_problem(p=3000, m=803)
    before = launch_counts()
    errs = cs.phase2_tel_kernels(torch, mat if layout == "sparse" else X, y, layout)
    assert set(errs.values()) == {0.0}
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    assert launched["step_tail_tel"] > 0 and launched["step_tail_en_tel"] > 0
    assert launched["step_tail_lanes_tel"] > 0 and launched["step_tail_en_lanes_tel"] > 0
    assert (launched["fused_replay_tel"] > 0) == (layout == "dense")
    assert st.step_tail_tel.launches >= launched["step_tail_tel"]


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("backend", ["kernels", "sparse"])
def test_telemetry_on_is_the_off_trajectory_on_the_card(backend, fuse):
    """A solve with the ring on: the off solve's alpha bits, iterations and
    n_dots; one TEL tail launch a step (unfused) or one TEL replay a chunk
    (fused, record_objective off) and no launch of the plain instantiation;
    the cursor the iteration count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import engine
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.obs import TelemetrySpec, ring_to_records

    mat, y, X = _sparse_problem()
    design = mat if backend == "sparse" else X
    cfg = FWConfig(delta=20.0, kappa=100, max_iters=300, tol=1e-4, backend=backend,
                   fuse_steps=fuse)
    off = engine.solve(LASSO, design, y, cfg, TorchSampler(3, "cuda"))
    before = launch_counts()
    spec = TelemetrySpec(capacity=64, record_objective=fuse == 1)
    on = engine.solve(LASSO, design, y, dataclasses.replace(cfg, telemetry=spec),
                      TorchSampler(3, "cuda"))
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    assert _bits_equal(off.alpha, on.alpha)
    assert (off.iterations, off.n_dots) == (on.iterations, on.n_dots)
    assert on.telemetry.cursor == on.iterations
    if fuse == 1:
        assert launched["step_tail_tel"] == on.iterations and launched["step_tail"] == 0
        rec = ring_to_records(on.telemetry)
        assert float(rec["objective"][-1]) == float(on.objective)
    else:
        chunk = "sparse_fused_chunk" if backend == "sparse" else "dense_fused_chunk"
        assert launched["fused_replay_tel"] == launched[chunk] > 0
        assert launched["fused_replay"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 37, 4099, 1_000_003])
def test_health_flags_match_plain_on_the_card(dtype, p):
    """The one-launch health check against its plain version: a clean state
    and NaN/+Inf/-Inf at the first, a middle and the last element of beta,
    of the residual and of each scalar; an unaligned beta view; equal flags
    twice (the ticket back at 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.kernels import health

    g = torch.Generator(device="cuda")
    g.manual_seed(p)
    base = [torch.randn(p + 1, generator=g, device="cuda").to(dtype)[1:],  # unaligned view
            torch.tensor(0.5, device="cuda").to(dtype),
            torch.randn(803, generator=g, device="cuda").to(dtype),
            torch.tensor(3.0, device="cuda").to(dtype), torch.tensor(1.0, device="cuda").to(dtype)]
    stall = torch.tensor(5, dtype=torch.int32, device="cuda")
    cases = [None] + [(t, i, v) for t in range(5) for i in ((0, base[t].numel() // 2, -1)
                                                            if base[t].dim() else (None,))
                      for v in (float("nan"), float("inf"), float("-inf"))]
    before = launch_counts()["health_flags"]
    for case in cases:
        ts = [t.clone() for t in base]
        if case is not None:
            t, i, v = case
            if i is None:
                ts[t].fill_(v)
            else:
                ts[t][i] = v
        args = (ts[0], ts[1], ts[2:], stall)
        want = health.health_flags_plain(*args)
        got = [health.health_flags(*args) for _ in range(2)]
        assert torch.equal(got[0], want) and torch.equal(got[1], want), case
    assert launch_counts()["health_flags"] - before == 2 * len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,fuse", [("kernels", 8), ("sparse", 8), ("kernels", 1)])
def test_guarded_solve_is_the_unguarded_one_on_the_card(backend, fuse):
    """No fault: bit for bit engine.solve, one health_flags launch a check;
    beta_nan heals at rung 2 with the counters saying so, the unfused
    retry bit for bit the unguarded run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core import engine
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.resilience import faults, guards

    mat, y, X = _sparse_problem()
    design = mat if backend == "sparse" else X
    cfg = FWConfig(delta=20.0, kappa=100, max_iters=300, tol=0.0, patience=10**9,
                   backend=backend, fuse_steps=fuse)
    ref = engine.solve(LASSO, design, y, cfg, TorchSampler(3, "cuda"))
    before = launch_counts()["health_flags"]
    res = guards.solve_resilient(LASSO, design, y, cfg, TorchSampler(3, "cuda"))
    assert _bits_equal(ref.alpha, res.alpha) and ref.iterations == res.iterations
    chunks = -(-res.iterations // (8 * res.effective_fuse_steps))
    assert launch_counts()["health_flags"] - before == chunks
    reg = obs_metrics.MetricsRegistry()
    plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=1)], seed=7)
    with obs_metrics.use_registry(reg), faults.inject(plan):
        healed = guards.solve_resilient(LASSO, design, y, cfg, TorchSampler(3, "cuda"))
    assert reg.get("fw_guard_recoveries").series() == [
        ((("backend", backend), ("rung", "retry_chunk")), 1.0)]
    assert healed.iterations == ref.iterations and bool(torch.isfinite(healed.alpha).all())
    if fuse == 1:
        assert _bits_equal(ref.alpha, healed.alpha) and healed.n_dots == ref.n_dots


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["kernels", "sparse"])
def test_rung_3_raises_on_the_card(backend, monkeypatch):
    """With rung 2 made to fail (a test-only patch: the retry's beta comes
    back NaN), the card's ladder ends: UnrecoverableFaultError naming the
    backend and the reason, counted as unrecovered, no backend_fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.resilience import faults, guards

    def poisoned_retry(oracle, Xt, y, stats, state, cfg, delta, n_turns, sampler, turns=None):
        out = guards._advance(oracle, Xt, y, stats, state, cfg, delta, n_turns, sampler, True,
                              turns)
        return out._replace(beta=torch.full_like(out.beta, float("nan")))

    mat, y, X = _sparse_problem()
    design = mat if backend == "sparse" else X
    cfg = FWConfig(delta=20.0, kappa=100, max_iters=300, tol=0.0, patience=10**9,
                   backend=backend, fuse_steps=8)
    monkeypatch.setattr(guards, "_retry_chunk", poisoned_retry)
    reg = obs_metrics.MetricsRegistry()
    plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=1)], seed=7)
    with obs_metrics.use_registry(reg), faults.inject(plan):
        with pytest.raises(guards.UnrecoverableFaultError,
                           match=f"nonfinite_beta.*backend: {backend}"):
            guards.solve_resilient(LASSO, design, y, cfg, TorchSampler(3, "cuda"))
    assert reg.get("fw_guard_unrecovered").value(backend=backend) == 1.0
    assert reg.get("fw_guard_recoveries") is None or not reg.get("fw_guard_recoveries").series()


@pytest.mark.gpu
def test_shard_assembly_on_the_card_is_the_cpu_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from repro_torch.data.proxies import make_sparse_coo
    from repro_torch.sparse import io as sio

    rows, cols, vals, y, _ = make_sparse_coo(300, 5000, 0.01, 10, seed=4)
    sio.write_shards(tmp_path, sio.COOData(rows, cols, vals, y, (300, 5000)), rows_per_shard=64)
    cpu, y_cpu = sio.load_shards_as_matrix(tmp_path, block_size=128, device="cpu")
    gpu, y_gpu = sio.load_shards_as_matrix(tmp_path, block_size=128)
    assert gpu.values.is_cuda and torch.equal(gpu.values.cpu(), cpu.values)
    assert torch.equal(gpu.rows.cpu(), cpu.rows) and torch.equal(y_gpu.cpu(), y_cpu)
    assert np.array_equal(y_cpu.numpy(), y)
