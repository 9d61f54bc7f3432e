"""The port's elastic-net oracle (``repro_torch.core.fw_elasticnet``) against
the JAX reference's on the CPU, in one process, on the ``small_problem``
geometry of ``tests/test_engine.py``.

Both packages get the same numpy problem and the same index stream: the
reference's own, drawn inside ``jax.threefry_partitionable(False)`` (the
mode its goldens were pinned under, ROADMAP.md Queue 3 R1) and replayed
through ``convert.stream_from_reference`` (lanes:
``convert.lane_streams_from_reference``).

Tolerances, and why:
  * integer facts (iterations, n_dots, the support) exact: the stream, the
    argmax and the stopping rule determine them;
  * objectives at rtol 1e-6, the reference goldens' tolerance for
    summation-order differences;
  * the plain shifted argmax and the plain EN tail against the reference's
    ops on the same inputs: winners exact, scalars at rtol 1e-6 (the same
    f32 ops in the same order; XLA may fuse them otherwise);
  * the EN chunk's plain version against the reference's Pallas kernel in
    interpret mode: i_star and no_progress exact, the rest at the lasso
    chunk's tolerances (tests/test_torch_fused.py); a fused EN solve
    against the unfused one at the reference's own bars (iterations exact,
    objective rtol 1e-5, alpha 5e-4: the ledger reassociates scale * beta);
  * each batched lane against its sequential replay: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ENOracle as RefEN
from repro.core import FWConfig as RefConfig
from repro.core import engine as ref_engine
from repro.core import path as ref_path
from repro.core.fw_elasticnet import en_solve as ref_en_solve
from repro.kernels import fused_step as ref_fs
from repro.sparse import SparseBlockMatrix as RefMatrix

from repro_torch import convert
from repro_torch.core import (LASSO, ENCo, ENOracle, FWConfig, LaneStreamSampler, StreamSampler,
                              en_solve, engine, path, vertex)
from repro_torch.core import fw_elasticnet
from repro_torch.core.engine import ColStats
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import fw_grad
from repro_torch.kernels import step_tail as st
from repro_torch.kernels import launch_counts

DELTA, KAPPA, SEED, L2 = 30.0, 60, 42, 1.0
GOLDEN = dict(iterations=800, n_dots=48000, active=2, objective=828006.375)
FIXED = dict(delta=DELTA, sampling="uniform", kappa=KAPPA, tol=0.0, patience=10**9)
BACKENDS = [("torch", "xla"), ("kernels", "pallas"), ("sparse", "sparse")]


def _draw(n_steps, draw_fn, key=None):
    """The reference engine's stream: key, sub = split(key); draw(sub)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, draw_fn(sub)

        key = jax.random.PRNGKey(SEED) if key is None else key
        _, draws = jax.lax.scan(body, key, None, length=n_steps)
    return np.asarray(draws)


def _uniform(n_steps, p, key=None):
    return _draw(n_steps, lambda k: jax.random.randint(k, (KAPPA,), 0, p), key)


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    Xt = np.ascontiguousarray(ds.X.T)
    return Xt, ds.y


def _sparsified(Xt, threshold=0.7, block_size=64):
    Xs = Xt.copy()
    Xs[np.abs(Xs) < threshold] = 0.0
    return Xs, RefMatrix.from_dense(Xs, block_size=block_size)


def _port_matrix(ref_mat):
    return convert.sparse_from_reference(np.asarray(ref_mat.values), np.asarray(ref_mat.rows),
                                         ref_mat.p, ref_mat.m, ref_mat.block_size,
                                         ref_mat.nnz_max, "cpu")


def _designs(Xt, backend, sparse_from=None):
    """(reference design, port design) for a backend; 'sparse' over the
    block-ELL form of ``sparse_from`` (default Xt)."""
    if backend == "sparse":
        ref_mat = RefMatrix.from_dense(Xt if sparse_from is None else sparse_from, block_size=64)
        return ref_mat, _port_matrix(ref_mat)
    return jnp.asarray(Xt), torch.from_numpy(Xt)


def _ref(design, y, backend, alpha0=None, key=None, **kw):
    with jax.threefry_partitionable(False):
        return ref_en_solve(design, jnp.asarray(y), RefConfig(backend=backend, **kw), L2,
                            jax.random.PRNGKey(SEED) if key is None else key,
                            None if alpha0 is None else jnp.asarray(alpha0))


def _port(design, y, backend, draws, alpha0=None, **kw):
    return en_solve(design, torch.from_numpy(np.asarray(y)), FWConfig(backend=backend, **kw), L2,
                    convert.stream_from_reference(draws, "cpu"),
                    None if alpha0 is None else torch.as_tensor(np.asarray(alpha0)),
                    device="cpu")


def _same_facts(res, ref, rtol=1e-6):
    assert (res.iterations, res.n_dots, int(res.active)) == (
        int(ref.iterations), int(ref.n_dots), int(ref.active))
    np.testing.assert_array_equal(np.nonzero(res.alpha.numpy())[0],
                                  np.nonzero(np.asarray(ref.alpha))[0])
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=rtol)


# --------------------------------------------------------------------------
# the reference's golden and its sibling runs (tests/test_engine.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_golden_replays_the_reference(prob, backend, ref_backend):
    """tests/test_engine.py:121-129: 800 iterations, 48,000 dots, 2 active,
    828006.375, on every backend (the sparse one over the block-ELL form of
    the same dense design)."""
    Xt, y = prob
    ref_design, design = _designs(Xt, backend)
    kw = dict(FIXED, max_iters=800)
    ref = _ref(ref_design, y, ref_backend, **kw)
    res = _port(design, y, backend, _uniform(800, Xt.shape[0]), **kw)
    _same_facts(res, ref)
    assert (res.iterations, res.n_dots, int(res.active)) == (
        GOLDEN["iterations"], GOLDEN["n_dots"], GOLDEN["active"])
    np.testing.assert_allclose(float(res.objective), GOLDEN["objective"], rtol=1e-6)


def test_sparse_matches_dense_and_the_reference(prob):
    """tests/test_engine.py:138-150: on the sparsified design the sparse
    backend takes the dense one's iterations, its objective within 1e-4, its
    l1 within delta; and each equals the reference's run."""
    Xt, y = prob
    Xs, ref_mat = _sparsified(Xt)
    kw = dict(delta=DELTA, sampling="uniform", kappa=KAPPA, max_iters=2000, tol=1e-5)
    draws = _uniform(2000, Xt.shape[0])
    res_d = _port(torch.from_numpy(Xs), y, "torch", draws, **kw)
    res_s = _port(_port_matrix(ref_mat), y, "sparse", draws, **kw)
    assert res_s.iterations == res_d.iterations
    assert abs(float(res_s.objective) / float(res_d.objective) - 1) < 1e-4
    assert float(res_s.alpha.abs().sum()) <= DELTA * (1 + 1e-4)
    _same_facts(res_d, _ref(jnp.asarray(Xs), y, "xla", **kw))
    _same_facts(res_s, _ref(ref_mat, y, "sparse", **kw))


@pytest.mark.parametrize("backend,ref_backend", BACKENDS[:2])
def test_block_sampling_matches_the_reference(prob, backend, ref_backend):
    """tests/test_engine.py:175-186: 'block' sampling with the shift, where
    the reference's 'pallas' scores through its kernel and shifts in XLA
    (the port: K2's scores, the shifted argmax's plain version)."""
    Xt, y = prob
    kw = dict(delta=DELTA, sampling="block", kappa=64, block_size=32, max_iters=2000, tol=1e-5)
    nblocks = -(-Xt.shape[0] // 32)
    draws = _draw(2000, lambda k: jax.random.choice(k, nblocks, (2,), replace=False))
    res = _port(torch.from_numpy(Xt), y, backend, draws, **kw)
    _same_facts(res, _ref(jnp.asarray(Xt), y, ref_backend, **kw))


@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_warm_restart_stalls_as_the_reference(prob, backend, ref_backend):
    """tests/test_engine.py:355-369: from a converged solution the restart
    stops within 3 * patience iterations, on the reference's iterations."""
    Xt, y = prob
    ref_design, design = _designs(Xt, backend)
    kw = dict(delta=DELTA, sampling="uniform", kappa=KAPPA, max_iters=4000, tol=1e-6)
    draws = _uniform(4000, Xt.shape[0])
    base = _port(design, y, backend, draws, **kw)
    ref_base = _ref(ref_design, y, ref_backend, **kw)
    _same_facts(base, ref_base)
    assert bool(base.converged)
    warm = _port(design, y, backend, draws, alpha0=base.alpha.numpy(), **kw)
    ref_warm = _ref(ref_design, y, ref_backend, alpha0=ref_base.alpha, **kw)
    assert bool(warm.converged) and warm.iterations <= 3 * 20
    assert warm.iterations == int(ref_warm.iterations)
    np.testing.assert_allclose(float(warm.objective), float(ref_warm.objective), rtol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "sparse"])
def test_gap_bounds_suboptimality_as_the_reference(prob, backend):
    """tests/test_engine.py:308-330: a short run's certified gap, with the
    elastic-net's own gradient, covers its suboptimality against a long
    run, and equals the reference's ``gap()`` at the same alpha."""
    Xt, y = prob
    ref_design, design = _designs(Xt, backend)
    cfg_kw = dict(delta=DELTA, kappa=KAPPA, tol=0.0, patience=10**9)
    draws = _uniform(6000, Xt.shape[0])
    rough = _port(design, y, backend, draws, max_iters=60, **cfg_kw)
    best = _port(design, y, backend, draws, max_iters=6000, **cfg_kw)
    oracle = ENOracle(l2=L2)
    cfg = FWConfig(backend=backend, **cfg_kw)
    gap = float(oracle.gap(design, torch.from_numpy(y), rough.alpha, DELTA, cfg))
    subopt = float(rough.objective) - float(best.objective)
    # the gap is a small difference of large terms: its rounding floor is
    # 1e-6 of delta * ||X^T y||_inf (this short run is already near optimal)
    floor = 1e-6 * DELTA * float(np.abs(Xt @ y).max())
    assert gap >= subopt - 1e-5 * max(abs(float(best.objective)), 1.0) and gap >= -floor
    ref_gap = float(RefEN(l2=L2).gap(ref_design, jnp.asarray(y), jnp.asarray(rough.alpha.numpy()),
                                     DELTA, RefConfig(backend=backend if backend == "sparse"
                                                      else "xla", **cfg_kw)))
    assert abs(gap - ref_gap) <= floor


def test_report_gap_and_objective_are_the_oracles(prob):
    Xt, y = prob
    res = _port(torch.from_numpy(Xt), y, "kernels", _uniform(300, Xt.shape[0]),
                report_gap=True, max_iters=300, **{k: v for k, v in FIXED.items()})
    assert res.gap is not None and float(res.gap) >= 0.0
    co = ENOracle(L2).init_co(torch.from_numpy(y), torch.from_numpy(Xt.T @ res.alpha.numpy()),
                              res.alpha, torch.float32)
    stats = engine.precompute_colstats(torch.from_numpy(Xt), torch.from_numpy(y))
    np.testing.assert_allclose(float(ENOracle(L2).objective(torch.from_numpy(y), stats, co)),
                               float(res.objective), rtol=1e-5)


# --------------------------------------------------------------------------
# the plain shifted argmax and the plain EN tail against the reference's ops
# --------------------------------------------------------------------------


def _ref_shifted_argmax(scores, idx, p, beta, scale, l2):
    """The reference's _kernel_vertex shift and argmax (core/vertex.py:
    243-249), with its clipped gather."""
    sel = scores + l2 * (scale * jnp.take(beta, idx))
    mag = jnp.where(idx < p, jnp.abs(sel), -1.0)
    j = jnp.argmax(mag)
    return int(idx[j]), float(scores[j]), float(sel[j])


@pytest.mark.parametrize("case", ["random", "shift turns the winner", "raw all zero",
                                  "padded index would win", "block width 8"])
def test_shifted_argmax_plain_matches_the_reference(case):
    rng = np.random.default_rng(3)
    p, bs = 50, 1
    blk = rng.integers(0, p, 40)
    scores = rng.standard_normal(40).astype(np.float32)
    beta = rng.standard_normal(p).astype(np.float32)
    scale = np.float32(0.7)
    if case == "shift turns the winner":
        scores[:] = 0.1
        scores[3] = 1.0  # the raw winner
        beta[blk[7]] = 10.0  # a shift of 7 turns it
    elif case == "raw all zero":
        scores[:] = 0.0
    elif case == "padded index would win":
        bs = 8
        blk = np.array([5, 6], dtype=np.int64)  # block 6 covers 48..55: 50.. are padding
        scores = rng.standard_normal(16).astype(np.float32) * 0.01
        scores[13] = 100.0  # index 53 >= p
        beta[p - 1] = 1e3  # its clipped shift would be largest too
    elif case == "block width 8":
        bs = 8
        blk = np.array([0, 3, 2], dtype=np.int64)
        scores = rng.standard_normal(24).astype(np.float32)
    idx = (blk[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
    want = _ref_shifted_argmax(jnp.asarray(scores), jnp.asarray(idx), p, jnp.asarray(beta),
                               jnp.float32(scale), L2)
    shift = fw_grad.ScoreShift(torch.from_numpy(beta), torch.tensor(scale), L2)
    i, g_raw, g_sel = fw_grad.vertex_argmax_shifted(torch.from_numpy(scores),
                                                    torch.from_numpy(blk), bs, p, shift)
    assert int(i) == want[0] and int(i) < p
    assert float(g_raw) == want[1]
    np.testing.assert_allclose(float(g_sel), want[2], rtol=1e-6)
    if case == "shift turns the winner":
        assert int(i) == blk[7]


def _ref_en_tail(Xt, y, state, i_star, g_raw, g_sel, delta, cfg, sparse_mat=None):
    """The reference step's ops after its argmax for the EN oracle:
    line_search, apply_coeff_update, update_co (engine.step:286-304)."""
    from repro.core import engine as eng

    oracle = RefEN(l2=L2)
    stats = eng.precompute_colstats(sparse_mat if sparse_mat is not None else Xt, y)
    delta_t = -delta * jnp.sign(g_sel)
    a_star = state["scale"] * state["beta"][i_star]
    co = oracle.init_co(y, None, None, jnp.float32)._replace(
        resid=state["resid"], s_quad=state["s"], f_lin=state["f"], q_norm=state["q"])
    design = sparse_mat if sparse_mat is not None else Xt
    lam, no_progress, aux = oracle.line_search(design, y, stats, co, i_star, g_raw, g_sel,
                                               a_star, delta_t, cfg)
    beta, scale, maxabs, step_inf, stall = eng.apply_coeff_update(
        state["beta"], state["scale"], state["maxabs"], state["stall"], a_star, i_star, lam,
        delta_t, no_progress, cfg)
    new = oracle.update_co(design, y, stats, co, beta, scale, i_star, a_star, lam, delta_t,
                           jnp.int32(0), cfg, aux)
    return dict(beta=beta, scale=scale, maxabs=maxabs, step_inf=step_inf, stall=stall,
                resid=new.resid, s=new.s_quad, f=new.f_lin, q=new.q_norm, lam=lam)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("renorm", [False, True])
def test_en_tail_plain_matches_the_reference(prob, layout, renorm):
    """``step_tail_plain`` with ``en`` against the reference's line_search,
    apply_coeff_update and update_co on one state (a renorm when the scale
    is just above the threshold)."""
    Xt, y = prob
    p, m = Xt.shape
    rng = np.random.default_rng(7)
    beta = np.zeros(p, np.float32)
    beta[[3, 70, 272]] = [4.0, -2.0, 7.5]
    scale = np.float32(1.2e-6 if renorm else 0.8)
    resid = (y - (beta * scale) @ Xt).astype(np.float32)
    v = y - resid
    state = dict(beta=beta, scale=scale, maxabs=np.float32(9.0), stall=np.int32(2),
                 resid=resid, s=np.float32(v @ v), f=np.float32(v @ y),
                 q=np.float32((beta * scale) @ (beta * scale)))
    i_star, g_raw = 70, np.float32(-rng.standard_normal() * 50)
    g_sel = np.float32(g_raw + L2 * scale * beta[i_star])
    backend = "sparse" if layout == "sparse" else "xla"
    ref_cfg = RefConfig(delta=DELTA, kappa=KAPPA, backend=backend)
    cfg = FWConfig(delta=DELTA, kappa=KAPPA)
    ref_mat = RefMatrix.from_dense(Xt, block_size=64) if layout == "sparse" else None
    want = _ref_en_tail(jnp.asarray(Xt), jnp.asarray(y),
                        {k: jnp.asarray(v) for k, v in state.items()}, jnp.int32(i_star),
                        jnp.float32(g_raw), jnp.float32(g_sel), jnp.float32(DELTA), ref_cfg,
                        ref_mat)
    X = torch.from_numpy(Xt)
    stats = engine.precompute_colstats(X, torch.from_numpy(y))
    if layout == "sparse":
        mat = _port_matrix(ref_mat)
        stats = engine.precompute_colstats(mat, torch.from_numpy(y))
        X = (mat.values, mat.rows)
    t = {k: torch.tensor(v) for k, v in state.items()}
    got = st.step_tail_plain(
        X, torch.from_numpy(beta.copy()), t["scale"], t["maxabs"], t["stall"], t["resid"],
        t["s"], t["f"], torch.from_numpy(y), stats.zty, stats.znorm2,
        torch.tensor(i_star), torch.tensor(g_raw), torch.tensor(DELTA), cfg,
        st.ENTail(torch.tensor(g_sel), t["q"], L2))
    names = ("beta", "scale", "maxabs", "step_inf", "stall", "resid", "s", "f", "q")
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert (float(got[1]) == 1.0) == renorm


def test_en_algebra_is_the_references():
    """en_ls_closed_form and q_recursion against the reference's, on
    scalars where the line search clamps and where it does not."""
    from repro.core import fw_elasticnet as ref_fe

    for args in [(3e4, 1.2e3, 40.0, -25.0, 11.0, 0.3, 30.0, 79.0),
                 (1.0, 0.5, 2.0, 100.0, 101.0, -1.0, -30.0, 80.0)]:
        s, f, q, gx, gl, a, dt, zn2 = (np.float32(x) for x in args)
        want = ref_fe.en_ls_closed_form(L2, s, f, q, gx, gl, a, dt, zn2, 1e-12, 1e-6)
        t = [torch.tensor(x) for x in (s, f, q, gx, gl, a, dt, zn2)]
        got = st.en_ls_closed_form(L2, *t, 1e-12, 1e-6)
        assert float(got[0]) == float(want[0]) and bool(got[1]) == bool(want[1])
        lam = got[0]
        assert float(st.q_recursion(t[2], lam, t[6], t[5])) == float(
            ref_fe.q_recursion(q, jnp.float32(float(lam)), dt, a))


# --------------------------------------------------------------------------
# the fused chunk: the alpha ledger, the Q reconcile
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k0,max_iters,repeat", [(0, 10**6, False), (60, 66, False),
                                                 (0, 10**6, True)])
def test_en_chunk_plain_matches_reference_kernel(prob, k0, max_iters, repeat):
    """The EN chunk's plain version against the reference's Pallas kernel in
    interpret mode (tests/test_engine.py:461-482 with ENOracle): (60, 66)
    puts a refresh and max_iters inside the chunk; ``repeat`` samples one
    coordinate alone in steps 0 and 2 and first in every other one, so it
    wins twice and its two ledger slots add when the later steps score it."""
    Xt, y = prob
    p, m = Xt.shape
    K, kappa = 8, 32
    rng = np.random.default_rng(5)
    resid = rng.standard_normal(m).astype(np.float32)
    idx = rng.integers(0, p, (K, kappa)).astype(np.int32)
    alpha_s = (rng.standard_normal((K, kappa)) * 0.5).astype(np.float32)
    if repeat:
        idx[[0, 2]] = 17
        idx[:, 0] = 17
        alpha_s[:, 0] = 0.25
        alpha_s[[0, 2]] = 0.25
    zty = (Xt.astype(np.float64) @ y).astype(np.float32)
    zn2 = (Xt.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    scal = (3.0, 1.5, 0.7)
    kw = dict(eps_den=1e-12, gap_rtol=1e-6, refresh_every=64, max_iters=max_iters)
    want = ref_fs.dense_fused_chunk(
        jnp.asarray(Xt), jnp.asarray(y), jnp.asarray(resid), tuple(jnp.float32(s) for s in scal),
        jnp.asarray(idx), jnp.asarray(zty[idx]), jnp.asarray(zn2[idx]), jnp.asarray(alpha_s),
        jnp.int32(k0), jnp.float32(DELTA), oracle=RefEN(l2=L2), interpret=True, **kw)
    before = launch_counts()
    got = fs.dense_fused_chunk_en(
        torch.from_numpy(Xt), torch.from_numpy(y), torch.from_numpy(resid),
        tuple(torch.tensor(s) for s in scal), torch.from_numpy(idx).long(),
        torch.from_numpy(zty[idx]), torch.from_numpy(zn2[idx]), k0, torch.tensor(DELTA),
        oracle=ENOracle(l2=L2), alpha_s=torch.from_numpy(alpha_s), **kw)
    assert launch_counts() == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if repeat:
        assert int((got[0] == 17).sum()) >= 2
    for g, w in ((got[1], want[1]), (got[2], want[2]), (got[4], want[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for g, w in zip(got[5], want[5]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)


def test_en_chunk_needs_its_alpha_values(prob):
    """The EN chunk needs alpha_s of idx's shape; each chunk wrapper runs
    its own oracle's algebra only."""
    Xt, y = prob
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    idx = torch.zeros((2, 3), dtype=torch.long)
    z = torch.zeros((2, 3))
    args = (X, yt, yt, (torch.tensor(0.0),) * 3, idx, z, z, 0, torch.tensor(1.0))
    kw = dict(eps_den=1e-12, gap_rtol=1e-6, refresh_every=64, max_iters=10)
    with pytest.raises(ValueError, match="alpha_s"):
        fs.dense_fused_chunk_en(*args, alpha_s=torch.zeros((2, 2)), oracle=ENOracle(l2=L2), **kw)
    with pytest.raises(NotImplementedError, match="fused_kind"):
        fs.dense_fused_chunk(*args, oracle=ENOracle(l2=L2), **kw)
    with pytest.raises(NotImplementedError, match="fused_kind"):
        fs.dense_fused_chunk_en(*args, alpha_s=z, oracle=LASSO, **kw)


@pytest.mark.parametrize("backend,ref_backend", [("kernels", "pallas"), ("sparse", "sparse")])
def test_fused_en_solve_matches_unfused_as_the_reference(prob, backend, ref_backend):
    """tests/test_engine.py:441-460: the EN chunk (the ledger) against the
    unfused EN steps, iterations exact, objective within 1e-5 and alpha
    within 5e-4; and the port's fused run against the reference's."""
    Xt, y = prob
    ref_design, design = _designs(Xt, backend)
    kw = dict(FIXED, max_iters=200)
    draws = _uniform(200, Xt.shape[0])
    p1 = _port(design, y, backend, draws, **kw)
    p8 = _port(design, y, backend, draws, fuse_steps=8, **kw)
    assert p8.effective_fuse_steps == 8 and p8.iterations == p1.iterations == 200
    assert abs(float(p8.objective) / float(p1.objective) - 1) < 1e-5
    np.testing.assert_allclose(p8.alpha.numpy(), p1.alpha.numpy(), rtol=5e-4, atol=5e-4)
    kw_ref = dict(kw, sparse_kernel=True, interpret=True) if backend == "sparse" else kw
    r8 = _ref(ref_design, y, ref_backend, fuse_steps=8, **kw_ref)
    assert (p8.iterations, p8.n_dots) == (int(r8.iterations), int(r8.n_dots))
    np.testing.assert_allclose(float(p8.objective), float(r8.objective), rtol=1e-6)


def test_torch_backend_chunks_bit_for_bit(prob):
    """The 'torch' backend chunks through K unfused steps: EN at fuse_steps=8
    is its fuse_steps=1 run, bit for bit (tests/test_engine.py:447-450)."""
    Xt, y = prob
    kw = dict(FIXED, max_iters=200)
    draws = _uniform(200, Xt.shape[0])
    e1 = _port(torch.from_numpy(Xt), y, "torch", draws, **kw)
    e8 = _port(torch.from_numpy(Xt), y, "torch", draws, fuse_steps=8, **kw)
    assert torch.equal(e1.alpha, e8.alpha) and e8.effective_fuse_steps == 8


def test_q_is_reconciled_after_a_chunk_over_a_refresh_step(prob):
    """The chunk has no beta for Q's exact refresh: after a chunk that held a
    refresh step (k = 7 with refresh_every 8), the engine sets Q to
    ||alpha||^2 from the replayed beta; a chunk without one keeps the
    chunk's recursion (the run with no refresh at all)."""
    Xt, y = prob
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    draws = torch.from_numpy(_uniform(8, Xt.shape[0]))

    def run(refresh_every):
        cfg = FWConfig(backend="kernels", fuse_steps=4, refresh_every=refresh_every,
                       **dict(FIXED, max_iters=8))
        states = []
        engine.solve(ENOracle(l2=L2), X, yt, cfg, StreamSampler(draws), device="cpu",
                     on_step=lambda s: states.append((s.co.q_norm.clone(), s.scale.clone(),
                                                      s.beta.clone())))
        return states

    refreshed, plain = run(8), run(10**6)
    assert len(refreshed) == len(plain) == 2
    assert torch.equal(refreshed[0][0], plain[0][0])  # steps 0..3: no refresh step
    q, scale, beta = refreshed[1]  # steps 4..7 hold k = 7
    assert torch.equal(q, engine.q_exact(beta, scale))
    np.testing.assert_allclose(float(q), float(plain[1][0]), rtol=1e-4)


def test_en_chunks_past_the_ledger_run_unfused():
    """The ledger's K slots (12 bytes each) share a block's shared memory
    with the residual: at the dense cap m = M_MAX, K = 2730 fits and K =
    2731 does not. Past it the chunk runs K unfused steps (the 'kernels'
    backend's route), the unfused solve's bits; below it any K takes the
    fused kernel."""
    m, p = fs.M_MAX, 64
    rng = np.random.default_rng(11)
    Xt = rng.standard_normal((p, m)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    X = torch.from_numpy(Xt)
    fits = fs.SMEM_BYTES - 8 * m
    assert fs.ledger_bytes(2730) == fits < fs.ledger_bytes(2731)
    for K, fused in ((2730, True), (2731, False), (65, True)):
        cfg = FWConfig(delta=DELTA, kappa=KAPPA, fuse_steps=K)
        assert vertex.use_fused_kernel(cfg, X, ENOracle(l2=L2)) is fused
        assert vertex.use_fused_kernel(cfg, X, LASSO)
    kw = dict(FIXED, max_iters=12)
    draws = _uniform(12, p)
    e1 = _port(X, y, "kernels", draws, **kw)
    past = _port(X, y, "kernels", draws, fuse_steps=2731, **kw)
    assert torch.equal(e1.alpha, past.alpha)


# --------------------------------------------------------------------------
# batched lanes
# --------------------------------------------------------------------------

LANE_MAX_ITERS = 2000


def _lane_streams(n_chunks, lane_width, p):
    """The reference fw_path_batched's per-lane streams, chunk by chunk."""
    with jax.threefry_partitionable(False):
        key, chunks = jax.random.PRNGKey(0), []
        for _ in range(n_chunks):
            key, *subs = jax.random.split(key, lane_width + 1)
            chunks.append([_uniform(LANE_MAX_ITERS, p, s) for s in subs])
    return chunks


@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_fw_path_batched_matches_reference(prob, backend, ref_backend):
    """tests/test_engine.py:266-280: the EN path in lanes of 3 against the
    reference's, point by point: integer facts exact, objectives and l1 at
    rtol 1e-6."""
    Xt, y = prob
    ref_design, design = _designs(Xt, backend)
    deltas = np.geomspace(3.0, 30.0, 6)
    kw = dict(delta=1.0, sampling="uniform", kappa=KAPPA, max_iters=LANE_MAX_ITERS, tol=1e-5)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path_batched(ref_design, jnp.asarray(y), deltas,
                                       RefConfig(backend=ref_backend, **kw), seed=0, lane_width=3,
                                       oracle=RefEN(l2=L2))
    streams = _lane_streams(2, 3, Xt.shape[0])
    res = path.fw_path_batched(
        design, torch.from_numpy(y), deltas, FWConfig(backend=backend, **kw), lane_width=3,
        oracle=ENOracle(l2=L2), device="cpu",
        lane_sampler_fn=lambda c: convert.lane_streams_from_reference(streams[c], "cpu"))
    for got, want in zip(res.points, ref.points):
        assert (got.iterations, got.n_dots, got.active) == (
            want.iterations, want.n_dots, want.active)
        np.testing.assert_array_equal(got.alpha_nnz_idx, want.alpha_nnz_idx)
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
        np.testing.assert_allclose(got.l1, want.l1, rtol=1e-6)
    assert res.saved_iters == ref.saved_iters


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("sampling", ["uniform", "block"])
@pytest.mark.parametrize("backend", ["torch", "kernels", "sparse", "sparse plain"])
def test_lanes_equal_sequential_solves(prob, backend, sampling, fuse):
    """Each lane of ``solve_batched`` is the sequential EN solve on its own
    stream, bit for bit (alpha, objective, gap, iterations, n_dots, the
    vertices), one lane frozen early; with ``fuse_steps=8`` the sequential
    counterpart is the chunk of K unfused steps (``per_step``)."""
    Xt, y = prob
    design = _designs(Xt, backend.split()[0])[1]
    yt = torch.from_numpy(y)
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=300, tol=1e-4, sampling=sampling,
                   backend=backend.split()[0], block_size=64, fuse_steps=fuse, report_gap=True,
                   sparse_kernel=False if backend == "sparse plain" else None)
    deltas = [2.0, 30.0, 150.0]
    rng = np.random.default_rng(5)
    if sampling == "uniform":
        draws = [torch.from_numpy(rng.integers(0, 300, (300, KAPPA))) for _ in deltas]
    else:
        draws = [torch.stack([torch.from_numpy(rng.permutation(5)[:1]) for _ in range(300)])
                 for _ in deltas]
    seqs = [[] for _ in deltas]

    def on_step(state, active):
        for lane, a in enumerate(active):
            if a:
                seqs[lane].append(int(state.i_star[lane]))

    oracle = ENOracle(l2=L2)
    res, saved = engine.solve_batched(oracle, design, yt, cfg, LaneStreamSampler(draws), None,
                                      deltas, device="cpu", on_step=on_step)
    if fuse == 1:
        assert min(res.iterations) < max(res.iterations) and saved > 0
    for lane, d in enumerate(deltas):
        seq = []
        one = engine.solve(oracle, design, yt, cfg, StreamSampler(draws[lane]), None, d,
                           device="cpu", per_step=lambda s: seq.append(int(s.i_star)))
        assert (one.iterations, one.n_dots) == (res.iterations[lane], res.n_dots[lane])
        assert seq == seqs[lane]
        assert _bits(one.alpha, res.alpha[lane])
        assert _bits(one.objective, res.objective[lane])
        assert _bits(one.gap, res.gap[lane])


def test_lanes_refresh_q_at_their_own_k(prob):
    """A lane's Q after a refresh step is its exact ||alpha||^2, as the
    sequential solve's; lanes whose k is not at a refresh keep their
    recursion."""
    Xt, y = prob
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=8, tol=0.0, patience=10**9,
                   refresh_every=4, backend="kernels")
    rng = np.random.default_rng(9)
    draws = [torch.from_numpy(rng.integers(0, 300, (8, KAPPA))) for _ in range(2)]
    seen = []
    engine.solve_batched(ENOracle(l2=L2), X, yt, cfg, LaneStreamSampler(draws), None,
                         [5.0, 20.0], device="cpu",
                         on_step=lambda s, a: seen.append((s.co.q_norm.clone(), s.scale.clone(),
                                                           s.beta.clone())))
    q, scale, beta = seen[3]  # after the step at k = 3
    for lane in range(2):
        assert torch.equal(q[lane], engine.q_exact(beta[lane], scale[lane]))


# --------------------------------------------------------------------------
# state carried across, the package surface
# --------------------------------------------------------------------------


def test_state_from_reference_carries_the_en_co_state(prob):
    Xt, y = prob
    with jax.threefry_partitionable(False):
        st0 = ref_engine.init_state(RefEN(l2=L2), jnp.asarray(Xt), jnp.asarray(y),
                                    jax.random.PRNGKey(0), jnp.ones(300, jnp.float32) * 0.01)
    arrays = {"beta": st0.beta, "scale": st0.scale, "co.resid": st0.co.resid,
              "co.s_quad": st0.co.s_quad, "co.f_lin": st0.co.f_lin, "co.q_norm": st0.co.q_norm,
              "maxabs": st0.maxabs, "step_inf": st0.step_inf, "stall": st0.stall,
              "n_dots": st0.n_dots, "k": st0.k}
    state = convert.state_from_reference(arrays, "cpu")
    assert isinstance(state.co, ENCo)
    np.testing.assert_allclose(float(state.co.q_norm), float(st0.co.q_norm), rtol=0)
    mine = engine.init_state(ENOracle(l2=L2), torch.from_numpy(Xt), torch.from_numpy(y),
                             torch.ones(300) * 0.01)
    # two f32 dot products of 300 terms, summed in different orders
    np.testing.assert_allclose(float(mine.co.q_norm), float(state.co.q_norm), rtol=1e-5)


def test_en_oracle_surface():
    assert ENOracle(l2=0.5) == ENOracle(l2=0.5) and hash(ENOracle(0.5)) == hash(ENOracle(0.5))
    assert ENOracle(0.5) != ENOracle(1.0)
    o = ENOracle(l2=2.0)
    assert (o.fused_kind, o.fused_needs_alpha, o.needs_stats, o.extra_dots) == ("en", True, True, 0)
    assert fw_elasticnet.en_ls_closed_form is st.en_ls_closed_form
    stats = ColStats(zty=torch.zeros(3), znorm2=torch.ones(3), yty=torch.tensor(4.0))
    co = ENCo(torch.zeros(2), torch.tensor(2.0), torch.tensor(1.0), torch.tensor(3.0))
    assert float(o.objective(None, stats, co)) == 0.5 * 4 + 0.5 * 2 - 1 + 0.5 * 2.0 * 3
    shift = o.score_extra(torch.tensor([1.0, -2.0, 3.0]), torch.tensor(0.5))
    assert shift(torch.tensor([2, 0])).tolist() == [3.0, 1.0]
    assert dataclasses.is_dataclass(o)
