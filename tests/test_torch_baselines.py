"""The port's baselines (``repro_torch.core.baselines``, ``projections``,
``cd_path``, ``fista_path`` and the ``cd_sweep`` kernel's plain version)
against the JAX reference on the CPU, and the reference's own baseline
tests (``tests/test_baselines.py``) ported to the port.

Both packages get the same numpy problem and the same random streams: the
reference's own, drawn with ``jax.random`` as its solvers draw them (a
``split`` and a ``randint`` each CD sweep, ``normal(key, (p,))`` for the
power iteration, a ``split`` each path point) and replayed through the
port's stream arguments.

Tolerances. The two packages sum their dots in other orders (XLA's against
torch's), so floats agree to rounding: alpha at rtol 1e-6 with atol 1e-6
of ||alpha||_inf (the iterate's own f32 rounding scale), the maintained
residual at 1e-6 of ||y||_2 (p rounded updates a sweep, each at y's
scale), objectives at 1e-6 of their scale, the larger of the objective and
1/2 ||y||^2 (the residual rounds at y's scale, however small the fit leaves
it), Lipschitz estimates at rtol 1e-5. Counts
and supports are exact. A stopping test compares ||alpha_{t+1} -
alpha_t||_inf with tol in f32, and that step is a difference of two f32
iterates: where tol lies within a few ulps of ||alpha||_inf the stop is
decided by rounding in either package. The stop-test parities therefore
run on the reference's problem with y scaled by 1/100 (alpha of order 1 to
10, tol 1e-3 a thousand ulps), where the sweeps and iterations are exact.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CDConfig as RefCD
from repro.core import FISTAConfig as RefFISTA
from repro.core import baselines as ref_bl
from repro.core import path as ref_path
from repro.core.projections import project_l1_ball as ref_project
from repro.core.projections import soft_threshold as ref_soft

from repro_torch import convert
from repro_torch.core import (CDConfig, FISTAConfig, baselines, cd_path, fista_path,
                              lambda_grid)
from repro_torch.core.projections import project_l1_ball, soft_threshold
from repro_torch.kernels import cd_sweep as cdk
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.colstats import colstats

SEED = 42
RTOL = 1e-6
P_PAPER = 4_272_227


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    return np.ascontiguousarray(ds.X.T), np.asarray(ds.y, np.float32)


@pytest.fixture(scope="module")
def scaled(prob):
    """The stop-test parities' problem (see the module docstring)."""
    Xt, y = prob
    return Xt, (y / 100).astype(np.float32)


def _lam(Xt, y, div):
    return float(np.max(np.abs(Xt @ y))) / div


def _orders(key, n_sweeps, p):
    """The reference ``cd_solve``'s orders: key, sub = split(key); randint(sub)."""
    out = []
    for _ in range(n_sweeps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (p,), 0, p)))
    return out


def _order_fn(orders):
    return lambda s: torch.tensor(orders[s])


def _v0(key, p):
    """The reference ``estimate_lipschitz``'s start."""
    return torch.tensor(np.asarray(jax.random.normal(key, (p,))))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_alpha(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.max(np.abs(want)))
    np.testing.assert_array_equal(np.nonzero(got)[0], np.nonzero(want)[0])


def _close_objective(got, want, y):
    assert abs(float(got) - float(want)) <= RTOL * max(abs(float(want)),
                                                       0.5 * float(np.dot(y, y)))


def _ref_cd(Xt, y, cfg, key=None, alpha0=None, lam=None):
    return ref_bl.cd_solve(jnp.asarray(Xt), jnp.asarray(y), RefCD(**cfg),
                           jax.random.PRNGKey(SEED) if key is None else key,
                           None if alpha0 is None else jnp.asarray(alpha0), lam=lam)


def _ref_fista(Xt, y, cfg, key=None, alpha0=None):
    return ref_bl.fista_solve(jnp.asarray(Xt), jnp.asarray(y), RefFISTA(**cfg),
                              jax.random.PRNGKey(SEED) if key is None else key,
                              None if alpha0 is None else jnp.asarray(alpha0))


def _port_cd(Xt, y, cfg, n_orders, alpha0=None, lam=None):
    p = Xt.shape[0]
    order = (_order_fn(_orders(jax.random.PRNGKey(SEED), n_orders, p))
             if cfg.get("stochastic") else None)
    return baselines.cd_solve(_t(Xt), _t(y), CDConfig(**cfg), order, alpha0, lam)


# --------------------------------------------------------------------------
# coordinate descent
# --------------------------------------------------------------------------


@pytest.mark.parametrize("stochastic", [False, True])
def test_cd_sweeps_match_reference(prob, stochastic):
    """Each sweep's alpha, support and residual against the reference run
    at max_sweeps = k, the sweeps driven through the kernel's wrapper."""
    Xt, y = prob
    p = Xt.shape[0]
    lam = _lam(Xt, y, 10)
    orders = _orders(jax.random.PRNGKey(SEED), 6, p)
    X, Y = _t(Xt), _t(y)
    _, zn2 = colstats(X, Y)
    alpha, resid = torch.zeros(p), Y.clone()
    for k in range(1, 7):
        md = cdk.cd_sweep(X, alpha, resid, zn2, lam,
                          torch.tensor(orders[k - 1]).long() if stochastic else None)
        ref = _ref_cd(Xt, y, dict(lam=lam, max_sweeps=k, tol=0.0, stochastic=stochastic))
        a_ref = np.asarray(ref.alpha, np.float64)
        _close_alpha(alpha.numpy(), a_ref)
        true_resid = y.astype(np.float64) - Xt.T.astype(np.float64) @ a_ref
        np.testing.assert_allclose(resid.numpy(), true_resid, rtol=0,
                                   atol=RTOL * np.linalg.norm(y))
        _close_objective(0.5 * float(resid @ resid), ref.objective, y)
        assert float(md) > 0


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("div,tol", [(10, 1e-3), (10, 1e-4), (3, 1e-3)])
def test_cd_solve_matches_reference(scaled, stochastic, div, tol):
    Xt, y = scaled
    cfg = dict(lam=_lam(Xt, y, div), max_sweeps=1000, tol=tol, stochastic=stochastic)
    ref = _ref_cd(Xt, y, cfg)
    got = _port_cd(Xt, y, cfg, int(ref.iterations))
    assert (got.iterations, got.n_dots, got.active, got.converged) == (
        int(ref.iterations), int(ref.n_dots), int(ref.active), bool(ref.converged))
    assert isinstance(got.n_dots, int)
    _close_alpha(got.alpha.numpy(), ref.alpha)
    _close_objective(got.objective, ref.objective, y)


def test_cd_warm_start_carried_from_the_reference(scaled):
    """A reference result carried across (``convert.baseline_from_reference``)
    is the port's warm start: both packages continue from the same alpha0."""
    Xt, y = scaled
    lam = _lam(Xt, y, 10)
    first = _ref_cd(Xt, y, dict(lam=lam * 2, max_sweeps=1000, tol=1e-3))
    carried = convert.baseline_from_reference(
        {k: np.asarray(v) for k, v in first._asdict().items()}, "cpu")
    assert (carried.iterations, carried.n_dots, carried.active, carried.converged) == (
        int(first.iterations), int(first.n_dots), int(first.active), bool(first.converged))
    np.testing.assert_array_equal(carried.alpha.numpy(), np.asarray(first.alpha))
    ref = _ref_cd(Xt, y, dict(lam=lam, max_sweeps=1000, tol=1e-3), alpha0=first.alpha)
    got = baselines.cd_solve(_t(Xt), _t(y), CDConfig(lam=lam, tol=1e-3), None, carried.alpha)
    assert got.iterations == int(ref.iterations)
    _close_alpha(got.alpha.numpy(), ref.alpha)
    # the caller's warm start is copied, never updated in place
    np.testing.assert_array_equal(carried.alpha.numpy(), np.asarray(first.alpha))
    alpha_only = convert.baseline_from_reference({"alpha": np.asarray(first.alpha)}, "cpu")
    assert alpha_only.active == int(first.active) and alpha_only.n_dots == 0


# --------------------------------------------------------------------------
# the sweep's plain version on its edge cases (the card's phase 2 has the same)
# --------------------------------------------------------------------------


def _sweep64(Xt, alpha, resid, lam, order):
    """The sweep in float64 numpy, for the plain version's edge cases."""
    a, r = alpha.astype(np.float64).copy(), resid.astype(np.float64).copy()
    X = Xt.astype(np.float64)
    n2 = np.sum(X * X, axis=1)
    md = 0.0
    for j in order:
        rho = X[j] @ r + a[j] * n2[j]
        new = np.sign(rho) * max(abs(rho) - lam, 0.0) / max(n2[j], 1e-12)
        d = new - a[j]
        r -= d * X[j]
        a[j] = new
        md = max(md, abs(d))
    return a, r, md


EDGE_CASES = ["repeats", "zero_column", "lam_zero", "above_lam_max", "warm_thresholded"]


def _edge_case(prob, case):
    """The sweep's edge cases on the problem's first 40 rows: ``(Xt, y,
    alpha0, lam, order)``, the order None (cyclic) unless the case repeats
    rows."""
    Xt, y = prob
    Xt = Xt[:40].copy()
    p, m = Xt.shape
    rng = np.random.default_rng(3)
    alpha0 = np.zeros(p, np.float32)
    order = None
    lam = _lam(Xt, y, 5)
    if case == "repeats":  # one row three times inside any ring's window, and back to back
        order = rng.integers(0, p, p)
        order[3:6] = 7
        order[10] = 7
    elif case == "zero_column":
        Xt[5] = 0.0
        alpha0[5] = 2.5  # the 1e-12 floor: a_new = 0 / 1e-12, d = -2.5, R untouched
    elif case == "lam_zero":
        lam = 0.0
    elif case == "above_lam_max":
        lam = _lam(Xt, y, 1) * 1.01
    else:
        alpha0 = rng.standard_normal(p).astype(np.float32)
        alpha0[::3] = 0.0
        lam = _lam(Xt, y, 2)
    return Xt, y, alpha0, lam, order


@pytest.mark.parametrize("case", EDGE_CASES)
def test_cd_sweep_plain_edge_cases(prob, case):
    Xt, y, alpha0, lam, order = _edge_case(prob, case)
    p = Xt.shape[0]
    X, Y = _t(Xt), _t(y)
    _, zn2 = colstats(X, Y)
    alpha = _t(alpha0).clone()
    resid = Y - alpha @ X
    r0 = resid.clone()
    md = cdk.cd_sweep(X, alpha, resid, zn2, lam, None if order is None else _t(order))
    a64, r64, md64 = _sweep64(Xt, alpha0, r0.numpy(), lam, range(p) if order is None else order)
    np.testing.assert_allclose(alpha.numpy(), a64, rtol=1e-5, atol=1e-5 * np.max(np.abs(a64)))
    np.testing.assert_allclose(resid.numpy(), r64, rtol=0, atol=1e-5 * np.linalg.norm(y))
    np.testing.assert_allclose(float(md), md64, rtol=1e-5)
    if case == "above_lam_max":
        assert not torch.any(alpha != 0) and torch.equal(resid, r0) and float(md) == 0.0
    elif case == "lam_zero":
        assert int(torch.count_nonzero(alpha)) == p
    elif case == "zero_column":
        assert float(alpha[5]) == 0.0 and float(md) >= 2.5


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order_kind", ["as_case", "stochastic"])
@pytest.mark.parametrize("rebase_after", [None, 1])
def test_screened_sweep_matches_plain_on_edge_cases(prob, case, dtype, order_kind,
                                                    rebase_after):
    """The screened sweep's plain version (the score pass and the walks;
    ``cd_sweep`` on CPU tensors) bit for bit the unscreened plain loop on
    each edge case (alpha equal up to a zero's sign, R and max |d|
    bitwise), cyclic and stochastic, f32 and bf16, with the cost model's
    re-bases and with one after every idle survivor."""
    Xt, y, alpha0, lam, order = _edge_case(prob, case)
    p = Xt.shape[0]
    if order_kind == "stochastic" and order is None:
        order = np.random.default_rng(5).integers(0, p, p)
    X, Y = _t(Xt).to(dtype), _t(y)
    _, zn2 = colstats(X, Y)
    R0 = Y - _t(alpha0) @ X.float()
    o = None if order is None else _t(order)
    a1, r1 = _t(alpha0).clone(), R0.clone()
    md1 = cdk.cd_sweep_plain(X, a1, r1, zn2, lam, o)
    cdk.STATS.reset()
    a2, r2 = _t(alpha0).clone(), R0.clone()
    md2 = cdk.cd_sweep(X, a2, r2, zn2, lam, o, rebase_after=rebase_after)
    assert torch.equal(a1, a2)
    assert torch.equal(r1.view(torch.int32), r2.view(torch.int32))
    assert torch.equal(md1.view(torch.int32), md2.view(torch.int32))
    st = cdk.STATS.snapshot()
    assert st["sweeps"] == 1 and st["positions"] == p and st["walks"] == st["rebases"] + 1
    if case == "above_lam_max":
        assert st["survivors"] == 0  # nothing can move: the screen skips every position
    if case == "lam_zero":
        assert st["survivors"] == p


@pytest.mark.parametrize("m,dtype,route,threads,slots", [
    (74, torch.float32, "ring", 32, 16),
    (186, torch.float32, "ring", 64, 16),
    (800, torch.float32, "ring", 256, 16),
    (4095, torch.bfloat16, "ring", 1024, 16),
    (4096, torch.float32, "ring", 1024, 13),
    (4097, torch.float32, "direct", 1024, 0),
    (16_087, torch.bfloat16, "direct", 1024, 0),
    (57_344, torch.float32, "direct", 1024, 0),
    (60_000, torch.float32, "direct", 1024, 0),
])
def test_sweep_plan(m, dtype, route, threads, slots):
    pl = cdk.sweep_plan(m, dtype)
    assert (pl.route, pl.threads, pl.slots) == (route, threads, slots)
    assert pl.smem_bytes <= cdk.SMEM_BYTES
    assert pl.residual_on_chip == (m * 4 <= cdk.SMEM_BYTES)
    if pl.slots:
        # a stage holds the row from its 4-byte floor (bf16 rows start mid-word)
        assert pl.slot_words * 4 >= (m * 4 if dtype == torch.float32 else m * 2 + 2)
        assert pl.threads * 4 >= m
        assert 2 * pl.slots <= cdk.ORDER_RING


@pytest.mark.parametrize("m,dtype", [(74, torch.float32), (186, torch.float32),
                                     (800, torch.float32), (4095, torch.bfloat16),
                                     (4096, torch.float32), (4097, torch.float32),
                                     (16_087, torch.bfloat16), (60_000, torch.float32)])
def test_walk_plan(m, dtype):
    """The walker's route is the unscreened sweep's for the same m and dtype,
    its chain the same threads (a survivor's arithmetic is H's bit for bit),
    in a block of at least WALK_MIN_THREADS testers on the ring route (the
    whole block on the direct route). The ring route keeps R in registers
    and takes no dynamic shared memory; the direct route stages R as H does."""
    pl, wp = cdk.sweep_plan(m, dtype), cdk.walk_plan(m, dtype)
    assert wp.route == pl.route and wp.chain_threads == pl.threads
    assert wp.smem_bytes <= cdk.SMEM_BYTES
    if wp.route == "ring":
        assert wp.threads == max(pl.threads, cdk.WALK_MIN_THREADS)
        assert wp.smem_bytes == 0
        assert wp.threads * cdk.WINDOW_PER_THREAD <= 32 * 128  # the window's ballot words
    else:
        assert (wp.threads, wp.smem_bytes) == (1024, pl.smem_bytes)


def test_cd_launches_count_on_the_cpu_only_as_plain(scaled):
    """On CPU tensors the wrapper takes the plain version (the screened
    sweep's: one plain walk a sweep or more) and counts no launch."""
    Xt, y = scaled
    reset_launch_counts()
    cdk.STATS.reset()
    res = baselines.cd_solve(_t(Xt), _t(y), CDConfig(lam=_lam(Xt, y, 10)))
    assert res.iterations > 0
    assert {k: launch_counts()[k] for k in ("cd_score", "cd_walk", "cd_sweep_unscreened")} == {
        "cd_score": 0, "cd_walk": 0, "cd_sweep_unscreened": 0}
    assert cdk.STATS.sweeps == res.iterations and cdk.STATS.walks >= res.iterations


# --------------------------------------------------------------------------
# FISTA and the Lipschitz estimate
# --------------------------------------------------------------------------


def test_lipschitz_matches_reference(prob):
    Xt, _ = prob
    key = jax.random.PRNGKey(SEED)
    for iters in (0, 5, 50):
        ref = float(ref_bl.estimate_lipschitz(jnp.asarray(Xt), iters, key))
        got = baselines.estimate_lipschitz(_t(Xt), iters, _v0(key, Xt.shape[0]))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), ref, rtol=1e-5)


@pytest.mark.parametrize("form,reg,tol", [
    ("penalized", 10, 1e-3), ("penalized", 10, 1e-4), ("penalized", 3, 1e-3),
    ("constrained", 0.3, 1e-3), ("constrained", 3.0, 1e-4),
])
def test_fista_matches_reference(scaled, form, reg, tol):
    Xt, y = scaled
    if form == "penalized":
        cfg = dict(lam=_lam(Xt, y, reg), max_iters=2000, tol=tol)
    else:
        cfg = dict(delta=reg, constrained=True, max_iters=2000, tol=tol)
    ref = _ref_fista(Xt, y, cfg)
    got = baselines.fista_solve(_t(Xt), _t(y), FISTAConfig(**cfg),
                                _v0(jax.random.PRNGKey(SEED), Xt.shape[0]))
    assert (got.iterations, got.n_dots, got.active, got.converged) == (
        int(ref.iterations), int(ref.n_dots), int(ref.active), bool(ref.converged))
    _close_objective(got.objective, ref.objective, y)
    np.testing.assert_array_equal(np.nonzero(got.alpha.numpy())[0],
                                  np.nonzero(np.asarray(ref.alpha))[0])


def test_dot_counts_are_python_ints_past_2_31():
    """ROADMAP.md R6: the reference's int32 counters wrap at the paper's p;
    the port's helper counts in Python ints."""
    fista = baselines.unit_dots(P_PAPER, fista_iters=500, power_iters=50)
    cd = baselines.unit_dots(P_PAPER, cd_sweeps=600)
    assert fista == 2 * P_PAPER * 550 == 4_699_449_700 > 2**31
    assert cd == 600 * P_PAPER == 2_563_336_200 > 2**31
    assert isinstance(fista, int) and isinstance(cd, int)
    # 300 iterations past its 50 power iterations, the reference's int32 count is negative
    assert np.int64(baselines.unit_dots(P_PAPER, fista_iters=300, power_iters=50)).astype(
        np.int32) < 0


def test_solvers_count_through_the_helper(scaled):
    Xt, y = scaled
    p = Xt.shape[0]
    cd = baselines.cd_solve(_t(Xt), _t(y), CDConfig(lam=_lam(Xt, y, 10)))
    assert cd.n_dots == baselines.unit_dots(p, cd_sweeps=cd.iterations)
    fi = baselines.fista_solve(_t(Xt), _t(y), FISTAConfig(lam=_lam(Xt, y, 10), power_iters=7))
    assert fi.n_dots == baselines.unit_dots(p, fista_iters=fi.iterations, power_iters=7)


# --------------------------------------------------------------------------
# projections
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ties", "all_tied", "inside", "on_the_sphere", "random",
                                  "zero_radius"])
def test_project_l1_ball_matches_reference(case):
    rng = np.random.default_rng(5)
    v, radius = rng.standard_normal(50).astype(np.float32) * 10, 3.0
    if case == "ties":
        v = np.array([3.0, -3.0, 3.0, 1.0, -1.0, 0.5, -3.0, 1.0], np.float32)
        radius = 4.0
    elif case == "all_tied":
        v = np.array([2.0, -2.0, 2.0, -2.0], np.float32)
        radius = 3.0
    elif case == "inside":
        v = np.array([0.5, -0.25, 0.1], np.float32)
        radius = 2.0
    elif case == "on_the_sphere":
        v = np.array([0.5, -0.25, 0.25], np.float32)
        radius = 1.0
    elif case == "zero_radius":
        radius = 0.0
    want = np.asarray(ref_project(jnp.asarray(v), radius))
    got = project_l1_ball(_t(v), radius).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.max(np.abs(v)))
    if case == "zero_radius":
        # no k has u_k k > css_k - 0, so theta = 0: the reference returns v
        # itself, and the port keeps its op order
        np.testing.assert_array_equal(got, v)
    elif case in ("inside", "on_the_sphere"):
        np.testing.assert_array_equal(got, v)  # returned unchanged
    else:
        assert np.sum(np.abs(got)) <= radius * (1 + 1e-5)


def test_soft_threshold_matches_reference():
    v = np.array([-3.0, -0.5, 0.0, 0.5, 0.7, 3.0], np.float32)
    for thr in (0.0, 0.5, 0.6, 10.0):
        np.testing.assert_array_equal(soft_threshold(_t(v), thr).numpy(),
                                      np.asarray(ref_soft(jnp.asarray(v), thr)))


# --------------------------------------------------------------------------
# the paths
# --------------------------------------------------------------------------


def _point_keys(seed, n):
    """``_penalized_path``'s per-point keys: key, sub = split(key) each point."""
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _check_points(got, want, y):
    assert len(got.points) == len(want.points)
    for g, (a, b) in enumerate(zip(got.points, want.points)):
        assert (a.iterations, a.n_dots, a.active) == (b.iterations, b.n_dots, b.active), g
        assert a.reg == b.reg
        _close_objective(a.objective, b.objective, y)
        np.testing.assert_allclose(a.l1, b.l1, rtol=RTOL)
        np.testing.assert_array_equal(np.sort(a.alpha_nnz_idx), np.sort(b.alpha_nnz_idx))
    assert (got.total_dots, got.total_iters) == (want.total_dots, want.total_iters)


@pytest.mark.parametrize("stochastic", [False, True])
def test_cd_path_matches_reference(scaled, stochastic):
    Xt, y = scaled
    lams = lambda_grid(_t(Xt), _t(y), n_points=6, ratio=20.0)
    cfg = dict(lam=0.0, max_sweeps=500, tol=1e-3, stochastic=stochastic)
    want = ref_path.cd_path(jnp.asarray(Xt), jnp.asarray(y), lams, RefCD(**cfg), seed=3)
    p = Xt.shape[0]
    keys = _point_keys(3, len(lams))
    streams = [_order_fn(_orders(k, pt.iterations, p)) if stochastic else None
               for k, pt in zip(keys, want.points)]
    got = cd_path(_t(Xt), _t(y), lams, CDConfig(**cfg), stream_fn=lambda g: streams[g])
    _check_points(got, want, y)


@pytest.mark.parametrize("constrained", [False, True])
def test_fista_path_matches_reference(scaled, constrained):
    Xt, y = scaled
    if constrained:
        regs = np.geomspace(0.3, 3.0, 4)
        cfg = dict(constrained=True, max_iters=1000, tol=1e-3)
    else:
        regs = lambda_grid(_t(Xt), _t(y), n_points=4, ratio=10.0)
        cfg = dict(max_iters=1000, tol=1e-3)
    want = ref_path.fista_path(jnp.asarray(Xt), jnp.asarray(y), regs, RefFISTA(**cfg), seed=5)
    v0s = [_v0(k, Xt.shape[0]) for k in _point_keys(5, len(regs))]
    got = fista_path(_t(Xt), _t(y), regs, FISTAConfig(**cfg), stream_fn=lambda g: v0s[g])
    _check_points(got, want, y)


def test_paths_run_on_their_own_streams(scaled):
    """Without stream hooks the paths draw from seeded generators: the same
    seed repeats a path, another seed gives another stochastic path."""
    Xt, y = scaled
    lams = lambda_grid(_t(Xt), _t(y), n_points=3, ratio=10.0)
    cfg = CDConfig(lam=0.0, tol=1e-3, stochastic=True)
    a, b = cd_path(_t(Xt), _t(y), lams, cfg, seed=1), cd_path(_t(Xt), _t(y), lams, cfg, seed=1)
    assert [pt.objective for pt in a.points] == [pt.objective for pt in b.points]
    fa = fista_path(_t(Xt), _t(y), lams, FISTAConfig(tol=1e-3), seed=1)
    assert all(np.isfinite(pt.objective) for pt in fa.points)


# --------------------------------------------------------------------------
# tests/test_baselines.py, on the port
# --------------------------------------------------------------------------


def _orthogonal_problem(m=64, p=32, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((m, p)))
    coef = np.zeros(p)
    coef[: p // 4] = rng.uniform(1.0, 5.0, p // 4)
    y = Q @ coef + 0.01 * rng.standard_normal(m)
    return np.ascontiguousarray(Q.T, np.float32), y.astype(np.float32)


def _penalized(res, lam):
    return float(res.objective) + lam * float(torch.sum(torch.abs(res.alpha)))


def test_cd_orthogonal_closed_form():
    Xt, y = _orthogonal_problem()
    lam = 0.5
    res = baselines.cd_solve(_t(Xt), _t(y), CDConfig(lam=lam, max_sweeps=200, tol=1e-10))
    expected = soft_threshold(_t(Xt) @ _t(y), lam)  # X^T X = I
    np.testing.assert_allclose(res.alpha.numpy(), expected.numpy(), atol=1e-5)


def test_stochastic_cd_matches_cyclic(scaled):
    Xt, y = scaled
    lam = _lam(Xt, y, 20)
    cyc = baselines.cd_solve(_t(Xt), _t(y), CDConfig(lam=lam, max_sweeps=500, tol=1e-6))
    sto = baselines.cd_solve(_t(Xt), _t(y), CDConfig(lam=lam, max_sweeps=500, tol=1e-6,
                                                     stochastic=True), seed=7)
    np.testing.assert_allclose(_penalized(sto, lam), _penalized(cyc, lam), rtol=1e-3)


def test_cd_null_solution_above_lambda_max(prob):
    """Paper §2.1: lam > ||X^T y||_inf => alpha* = 0."""
    Xt, y = prob
    res = baselines.cd_solve(_t(Xt), _t(y), CDConfig(lam=_lam(Xt, y, 1) * 1.01, max_sweeps=50,
                                                     tol=1e-10))
    assert res.active == 0 and res.iterations == 1 and res.converged
    np.testing.assert_allclose(2 * float(res.objective), float(np.dot(y, y)), rtol=RTOL)


def test_fista_penalized_matches_cd(scaled):
    Xt, y = scaled
    lam = _lam(Xt, y, 10)
    cd = baselines.cd_solve(_t(Xt), _t(y), CDConfig(lam=lam, max_sweeps=1000, tol=1e-6))
    fi = baselines.fista_solve(_t(Xt), _t(y), FISTAConfig(lam=lam, max_iters=5000, tol=1e-6))
    np.testing.assert_allclose(_penalized(fi, lam), _penalized(cd, lam), rtol=1e-3)


def test_fista_constrained_feasible(prob):
    Xt, y = prob
    delta = 30.0
    res = baselines.fista_solve(_t(Xt), _t(y), FISTAConfig(delta=delta, constrained=True,
                                                           max_iters=2000, tol=1e-8))
    assert float(torch.sum(torch.abs(res.alpha))) <= delta * (1 + 1e-4)


def test_lipschitz_estimate():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((40, 60)).astype(np.float32)
    est = float(baselines.estimate_lipschitz(_t(X.T), 100, seed=0))
    np.testing.assert_allclose(est, np.linalg.norm(X, 2) ** 2, rtol=1e-3)


def test_projection_norm_and_2d_optimality():
    rng = np.random.default_rng(0)
    for _ in range(10):
        v = rng.standard_normal(50).astype(np.float32) * 10
        assert float(torch.sum(torch.abs(project_l1_ball(_t(v), 3.0)))) <= 3.0 * (1 + 1e-5)
    ts = np.linspace(-1, 1, 401)
    xx, yy = np.meshgrid(ts, ts)
    mask = np.abs(xx) + np.abs(yy) <= 1.0
    pts = np.stack([xx[mask], yy[mask]], -1)
    rng = np.random.default_rng(1)
    for _ in range(20):
        v = rng.standard_normal(2) * 4
        proj = project_l1_ball(_t(v.astype(np.float32)), 1.0).numpy()
        assert ((proj - v) ** 2).sum() <= np.min(((pts - v) ** 2).sum(-1)) + 1e-3


# --------------------------------------------------------------------------
# a bfloat16 design, the package rules
# --------------------------------------------------------------------------


def test_bf16_design(prob):
    """A bf16 design: the port widens it (CD on load, FISTA once a solve), so
    it solves exactly as on the widened f32 design, which the reference
    matches at the f32 tolerances above; the reference's own bf16 run rounds
    its residual and iterate to bf16 at every update (2^-8 relative), and
    agrees on the penalized objective within 1e-2."""
    Xt, y = prob
    lam = _lam(Xt, y, 10)
    Xb = _t(Xt).bfloat16()
    Xw = Xb.float().numpy()
    cfg = dict(lam=lam, max_sweeps=200, tol=1e-3)
    got = baselines.cd_solve(Xb, _t(y), CDConfig(**cfg))
    wide = baselines.cd_solve(_t(Xw), _t(y), CDConfig(**cfg))
    assert got.iterations == wide.iterations and torch.equal(got.alpha, wide.alpha)
    assert got.alpha.dtype == torch.float32
    ref_wide = _ref_cd(Xw, y, cfg)
    assert got.iterations == int(ref_wide.iterations)
    _close_objective(got.objective, ref_wide.objective, y)
    ref_bf16 = ref_bl.cd_solve(jnp.asarray(Xt, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
                               RefCD(**cfg), jax.random.PRNGKey(SEED))
    pen_ref = float(ref_bf16.objective) + lam * float(
        np.sum(np.abs(np.asarray(ref_bf16.alpha, np.float32))))
    np.testing.assert_allclose(_penalized(got, lam), pen_ref, rtol=1e-2)
    fcfg = FISTAConfig(lam=lam, max_iters=2000, tol=1e-3)
    v0 = _v0(jax.random.PRNGKey(SEED), Xt.shape[0])
    fb = baselines.fista_solve(Xb, _t(y), fcfg, v0)
    fw = baselines.fista_solve(_t(Xw), _t(y), fcfg, v0)
    assert fb.iterations == fw.iterations and torch.equal(fb.alpha, fw.alpha)
    np.testing.assert_allclose(_penalized(fb, lam), pen_ref, rtol=1e-2)


def test_baselines_run_where_their_tensors_lie(prob):
    """Numpy inputs go to the card (and raise without one); CPU tensors, or
    device='cpu', run the plain versions on the CPU."""
    Xt, y = prob
    cfg = CDConfig(lam=_lam(Xt, y, 10), max_sweeps=2)
    res = baselines.cd_solve(_t(Xt), _t(y), cfg)
    assert res.alpha.device.type == "cpu" and isinstance(res.active, int)
    assert baselines.cd_solve(Xt, y, cfg, device="cpu").iterations == 2
    if not torch.cuda.is_available():
        for call in (lambda: baselines.cd_solve(Xt, y, cfg),
                     lambda: baselines.fista_solve(Xt, y, FISTAConfig(lam=1.0)),
                     lambda: cd_path(Xt, y, [1.0], cfg),
                     lambda: fista_path(Xt, y, [1.0], FISTAConfig()),
                     lambda: convert.baseline_from_reference({"alpha": y})):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_baselines_refuse_what_they_do_not_take(prob):
    from repro_torch.sparse import SparseBlockMatrix

    Xt, y = prob
    cfg = CDConfig(lam=1.0, max_sweeps=1)
    with pytest.raises(ValueError, match="takes no order"):
        baselines.cd_solve(_t(Xt), _t(y), cfg, lambda s: torch.zeros(300, dtype=torch.int64))
    sto = dataclasses.replace(cfg, stochastic=True)
    with pytest.raises(ValueError, match="outside"):
        baselines.cd_solve(_t(Xt), _t(y), sto, lambda s: torch.full((300,), 300))
    with pytest.raises(ValueError, match=r"must be \(300,\)"):
        baselines.cd_solve(_t(Xt), _t(y), sto, lambda s: torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="dense"):
        baselines.cd_solve(SparseBlockMatrix.from_dense(Xt, block_size=16), _t(y), cfg)
    with pytest.raises(TypeError, match="float32"):
        cdk.cd_sweep(_t(Xt), torch.zeros(300, dtype=torch.float64), _t(y), torch.ones(300), 1.0)


def test_new_modules_import_neither_jax_nor_the_reference():
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_package import FORBIDDEN, ROOT, _imported_roots

    files = [ROOT / "src" / "repro_torch" / f for f in (
        "core/baselines.py", "core/projections.py", "core/path.py", "core/solver_config.py",
        "kernels/cd_sweep.py", "convert.py")] + [ROOT / "scripts" / "cd_sweep_breakdown.py"]
    assert {str(f): sorted(_imported_roots(f) & FORBIDDEN) for f in files} == {
        str(f): [] for f in files}
