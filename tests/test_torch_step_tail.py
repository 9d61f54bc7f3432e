"""The unfused lasso step's tail (``kernels/step_tail``) and K5's route, on
the CPU, where ``step_tail`` runs its plain version.

``step_tail_plain`` is the tail of every backend's lasso step: the eager
ops that ``engine.step`` ran after its argmax (the oracle's line search,
the coefficient update and the oracle's co-state update), in one function.
``_eager`` below writes those ops out again as a spec, the scalars read in
f32 and each stored value rounded once to the state's dtype (for f32 the
identity, so there they are the ops ``engine.step`` ran). From the same
state the two must give the same bits, on the dense and the block-ELL
layout, in f32 and in bf16, through a renorm, with lam clamped at 0 and at
1, and when one coordinate wins two steps in a row (the second step from
the first's outputs). The CUDA kernel is held to ``step_tail_plain`` bit
for bit on the card (``chip_smoke.py`` phase 2, ``tests/test_torch_gpu.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.kernels.sparse_grad.sparse_grad import sparse_sampled_scores as ref_k5
from repro.sparse import SparseBlockMatrix as RefMatrix

from repro_torch.core import LASSO, FWConfig, LassoOracle, TorchSampler, engine
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import launch_counts
from repro_torch.kernels import sparse_grad as sg
from repro_torch.kernels import step_tail as st
from repro_torch.sparse import SparseBlockMatrix

P, M = 300, 80
TAIL_OUT = ("beta", "scale", "maxabs", "step_inf", "stall", "resid", "S", "F")
# each case: the state's scale, S, F, the winner's score and column statistics
CASES = {
    "random": dict(),
    "lam clamped at 1, a renorm (scale * 0)": dict(s_quad=0.0, f_lin=0.0, zty_i=7.5, zn2_i=1e-3),
    "lam clamped at 0, no progress": dict(f_lin=77.5),
    "the scale under the renorm threshold": dict(scale=1.2e-6),
    "a NaN score": dict(g_star=float("nan")),
}


def _bits(t):
    t = t.reshape(-1)
    if t.is_floating_point():
        return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])
    return t


def _same(a, b):
    """Equal bits, NaN at the same places."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a).reshape(-1), torch.isnan(b).reshape(-1)
    return torch.equal(na, nb) and torch.equal(_bits(a)[~na], _bits(b)[~nb])


def _design(layout, dtype, rng):
    """A dense Xt (P, M), or a SparseBlockMatrix of it at 10% density whose
    feature 5 stores a row-0 slot among its nonzeros (then padding)."""
    Xt = rng.standard_normal((P, M)).astype(np.float32)
    if layout == "sparse":
        Xt[rng.random((P, M)) > 0.1] = 0.0
        Xt[5] = 0.0
        Xt[5, [0, 17, 40]] = [1.5, -0.5, 2.0]
    Xt = torch.from_numpy(Xt).to(dtype)
    if layout == "dense":
        return Xt
    return SparseBlockMatrix.from_dense(Xt.float().numpy(), block_size=128).astype(dtype)


def _state(X, dtype, rng, i_star, *, scale=1.0, s_quad=30.0, f_lin=10.0, g_star=-7.5,
           zty_i=None, zn2_i=None):
    """An engine state, the column statistics, y, the winner and its score."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32).to(dtype)

    zty = rng.standard_normal(P).astype(np.float32)
    zn2 = (rng.random(P) + 0.5).astype(np.float32)
    if zty_i is not None:
        zty[i_star] = zty_i
    if zn2_i is not None:
        zn2[i_star] = zn2_i
    stats = engine.ColStats(zty=torch.from_numpy(zty).to(dtype),
                            znorm2=torch.from_numpy(zn2).to(dtype), yty=t(1.0))
    y = torch.from_numpy(rng.standard_normal(M).astype(np.float32)).to(dtype)
    resid = torch.from_numpy(rng.standard_normal(M).astype(np.float32)).to(dtype)
    state = engine.EngineState(
        beta=torch.from_numpy(rng.standard_normal(P).astype(np.float32)).to(dtype),
        scale=t(scale), co=_lasso_co(resid, t(s_quad), t(f_lin)), maxabs=t(2.0),
        step_inf=t(float("inf")),
        stall=torch.tensor(3, dtype=torch.int32), n_dots=0, k=0,
        i_star=torch.tensor(-1))
    return state, stats, y, torch.tensor(i_star), torch.tensor(g_star)


def _lasso_co(resid, s_quad, f_lin):
    from repro_torch.core.fw_lasso import LassoCo

    return LassoCo(resid=resid, s_quad=s_quad, f_lin=f_lin)


def _eager(X, y, stats, state, cfg, delta, i_star, g):
    """The step's eager tail, written out: eq. 6, the line search (eq. 8),
    the coefficient update with its renorm and stopping statistics, eq. 10
    ('torch' dense, the plain sparse ops) and the S/F recursions."""
    dtype = state.beta.dtype

    def take(x):
        return x.index_select(0, i_star.view(1)).view(())

    beta = state.beta.clone()
    g = g.float()
    delta_t = -delta * torch.sign(g)
    a_star = state.scale.float() * take(beta).float()
    # line search
    g_lin = g + take(stats.zty).float()
    s_quad, f_lin = state.co.s_quad.float(), state.co.f_lin.float()
    zty_i, zn2_i = take(stats.zty).float(), take(stats.znorm2).float()
    num = s_quad - delta_t * g - f_lin
    den = s_quad - 2.0 * delta_t * g_lin + delta_t**2 * zn2_i
    lam = torch.clamp(num / torch.clamp_min(den, cfg.eps_den), 0.0, 1.0)
    gap_scale = s_quad + torch.abs(f_lin) + torch.abs(delta_t * g)
    no_progress = num <= cfg.gap_rtol * gap_scale
    # coefficient update and stopping statistics
    scale, maxabs = state.scale.float(), state.maxabs.float()
    one_m = 1.0 - lam
    new_scale = scale * one_m
    need_renorm = new_scale < cfg.renorm_threshold
    beta = (beta.float() * torch.where(need_renorm, new_scale, 1.0)).to(dtype)
    scale = torch.where(need_renorm, 1.0, new_scale)
    coef = delta_t * lam / torch.clamp_min(scale, cfg.eps_den)
    beta[i_star] = (take(beta).float() + coef).to(dtype)
    alpha_istar_new = scale * take(beta).float()
    step_inf = lam * torch.maximum(maxabs, torch.abs(delta_t - a_star))
    maxabs = torch.maximum(one_m * maxabs, torch.abs(alpha_istar_new))
    stall = torch.where((step_inf <= cfg.tol) | no_progress, state.stall + 1, 0)
    # eq. 10
    r = state.co.resid.float()
    if isinstance(X, SparseBlockMatrix):
        vals = X.values.reshape(-1, X.nnz_max)[i_star].float()
        rows = X.rows.reshape(-1, X.nnz_max)[i_star]
        resid = ((1.0 - lam) * r + lam * y.float()).index_add_(0, rows, (-lam * delta_t) * vals)
    else:
        resid = (1.0 - lam) * r + lam * (y.float() - delta_t * X[i_star].float())
    # S/F recursions
    s_new = one_m**2 * s_quad + 2.0 * delta_t * lam * one_m * g_lin + delta_t**2 * lam**2 * zn2_i
    f_new = one_m * f_lin + delta_t * lam * zty_i
    return (beta, scale.to(dtype), maxabs.to(dtype), step_inf.to(dtype), stall, resid.to(dtype),
            s_new.to(dtype), f_new.to(dtype))


def _tail(X, y, stats, state, cfg, delta, i_star, g):
    mat = (X.values, X.rows) if isinstance(X, SparseBlockMatrix) else X
    co = state.co
    return st.step_tail(mat, state.beta.clone(), state.scale, state.maxabs, state.stall,
                        co.resid, co.s_quad, co.f_lin, y, stats.zty, stats.znorm2, i_star, g,
                        delta, cfg)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_step_tail_plain_is_the_eager_tail(layout, dtype, case):
    rng = np.random.default_rng(0)
    X = _design(layout, dtype, rng)
    i_star = 5
    state, stats, y, i, g = _state(X, dtype, rng, i_star, **CASES[case])
    cfg = FWConfig(delta=5.0, backend="kernels" if layout == "dense" else "sparse")
    delta = torch.tensor(5.0)
    before = launch_counts()
    got = _tail(X, y, stats, state, cfg, delta, i, g)
    want = _eager(X, y, stats, state, cfg, delta, i, g)
    assert launch_counts() == before  # CPU tensors: the plain version
    differ = [n for n, a, b in zip(TAIL_OUT, got, want) if not _same(a, b)]
    assert not differ, f"{differ} differ"
    assert got[5].dtype == dtype and got[1].dtype == dtype and got[4].dtype == torch.int32
    if case.startswith("lam clamped at 1") or case.startswith("the scale under"):
        assert float(got[1]) == 1.0  # renormalized
    if case.startswith("lam clamped at 0"):
        assert int(got[4]) == 4  # no progress counts a stall


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_the_same_coordinate_twice_in_a_row(layout, dtype):
    rng = np.random.default_rng(1)
    X = _design(layout, dtype, rng)
    state, stats, y, i, g = _state(X, dtype, rng, 5)
    cfg = FWConfig(delta=5.0)
    delta = torch.tensor(5.0)
    for step in range(2):
        got = _tail(X, y, stats, state, cfg, delta, i, g)
        want = _eager(X, y, stats, state, cfg, delta, i, g)
        assert all(_same(a, b) for a, b in zip(got, want)), f"step {step}"
        beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin = got
        state = state._replace(beta=beta, scale=scale, maxabs=maxabs, step_inf=step_inf,
                               stall=stall, co=_lasso_co(resid, s_quad, f_lin))
        g = g * 0.5


class _AlphaOracle(LassoOracle):
    """A lasso whose fused chunk would need live alpha values: its step's
    tail is the lasso's all the same."""

    fused_needs_alpha = True


@pytest.mark.parametrize("backend,sparse_kernel,oracle,want", [
    ("kernels", None, LASSO, True),
    ("sparse", None, LASSO, True),
    ("sparse", True, LASSO, True),
    ("sparse", False, LASSO, False),
    ("torch", None, LASSO, False),
    ("kernels", None, _AlphaOracle(), True),
])
def test_engine_takes_the_tail_where_the_kernels_run(monkeypatch, backend, sparse_kernel,
                                                     oracle, want):
    """Every lasso step runs one tail: the kernel's wrapper on the kernels'
    backends (its plain version here, on CPU tensors), ``step_tail_plain``
    itself on 'torch' and the plain sparse ops; both give the same step."""
    calls = []

    def wrapper(*args):
        calls.append("wrapper")
        return step_tail(*args)

    def plain(*args):
        calls.append("plain")
        return step_tail_plain(*args)

    step_tail, step_tail_plain = st.step_tail, st.step_tail_plain
    monkeypatch.setattr(st, "step_tail", wrapper)
    monkeypatch.setattr(st, "step_tail_plain", plain)
    rng = np.random.default_rng(4)
    X = _design("sparse" if backend == "sparse" else "dense", torch.float32, rng)
    y = torch.from_numpy(rng.standard_normal(M).astype(np.float32))
    cfg = FWConfig(delta=5.0, kappa=16, max_iters=6, backend=backend, sparse_kernel=sparse_kernel)
    res = engine.solve(oracle, X, y, cfg, TorchSampler(0, "cpu"), device="cpu")
    assert res.iterations == 6
    # on CPU tensors the wrapper runs the plain version: one plain tail a step either way
    assert calls.count("wrapper") == (6 if want else 0) and calls.count("plain") == 6
    ref = engine.solve(LASSO, X, y, dataclasses.replace(cfg, backend="torch" if backend ==
                                                        "kernels" else backend,
                                                        sparse_kernel=False),
                       TorchSampler(0, "cpu"), device="cpu")
    assert torch.equal(res.alpha, ref.alpha) and torch.equal(res.objective, ref.objective)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,nnz_max", [(803, 13), (16_087, 66), (30_000, 66), (57_345, 66),
                                       (803, 300)])
def test_k5_route(m, nnz_max, dtype):
    """K5's route from the inputs: the ring for f32 values where one fits
    beside the residual (K7's plan, the same ring), else the
    warp-per-feature kernel (bf16, or m past the ring's room: no cap on m)."""
    pl = sg.scores_plan(dtype, m, nnz_max)
    if dtype == torch.bfloat16:
        assert pl == sg.NO_RING
    elif m <= fs.M_MAX_SPARSE:
        assert pl == fs.plan(m, nnz_max)
    else:
        assert pl == sg.NO_RING
    assert pl.depth == 0 or pl.smem_bytes(m) <= sg.SMEM_BYTES


@pytest.mark.parametrize("bs", [1, 128])
def test_k5_plain_matches_reference(bs):
    """K5's plain version, which the ring kernel is held to on the card,
    against the reference's Pallas kernel (interpret mode) at width 1 and
    at the block width: the plain version is unchanged by the ring."""
    rng = np.random.default_rng(3)
    Xt = rng.standard_normal((P, M)).astype(np.float32)
    Xt[rng.random((P, M)) > 0.1] = 0.0
    ref = RefMatrix.from_dense(Xt, block_size=128)
    mat = SparseBlockMatrix.from_dense(Xt, block_size=128)
    r = rng.standard_normal(M).astype(np.float32)
    blk = rng.integers(0, P if bs == 1 else mat.nblocks, 40)
    got = sg.sparse_sampled_scores_plain(mat.values, mat.rows, torch.from_numpy(r),
                                         torch.from_numpy(blk), bs)
    import jax.numpy as jnp

    vals = jnp.asarray(np.asarray(ref.values).reshape(-1, bs, ref.nnz_max))
    rows = jnp.asarray(np.asarray(ref.rows).reshape(-1, bs, ref.nnz_max))
    want = np.asarray(ref_k5(vals, rows, jnp.asarray(r), jnp.asarray(blk, jnp.int32),
                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want.reshape(-1), rtol=1e-5, atol=1e-5)
