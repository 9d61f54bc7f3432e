"""The port's step rules (``repro_torch.core.step_rule``): the protocol's
pieces against the JAX reference's on the same inputs, and the port's
versions of ``tests/test_step_rules.py``.

The pieces (``apply_dir_update``, ``init_active_set`` with tied |beta|,
``insert_active``, ``_select_away``, ``score_indices`` on each backend with
-1 slots, the direction step's line search and co-state update (the
lasso's and the EN's in ``kernels/step_tail``, the logistic's on its
oracle), each oracle's ``partan_mu`` and ``partan_update_co``) get the same numpy inputs in both
packages. Winners, flags and buffers are exact; scalars at rtol 1e-6 (the
same f32 ops in the same order; XLA may fuse them otherwise); a sum over
the sample axis at 1e-6 of its Cauchy-Schwarz scale ||a|| ||b|| (the two
packages add in another order); the logistic's bisection at 1e-5 of its
interval (its 20 halvings end on an interval of 2^-20 of it, and a probe
whose phi' is a sum that rounds to the other sign moves it by one).

The acceptance tests run on the reference's own stream (drawn in legacy
threefry mode, ROADMAP.md Queue 3 R1, and replayed), the reference's
design, configs and bars; the bf16 solves are held to the bars of
``tests/test_torch_repairs.py::test_solver_dtypes``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ENOracle as RefEN
from repro.core import FWConfig as RefConfig
from repro.core import LASSO as REF_LASSO
from repro.core import LOGISTIC as REF_LOGISTIC
from repro.core import engine as ref_engine
from repro.core import step_rule as ref_rules
from repro.core import vertex as ref_vertex
from repro.sparse import SparseBlockMatrix as RefMatrix

from repro_torch import convert
from repro_torch.core import (LASSO, LOGISTIC, ENOracle, FWConfig, LaneSampler, StreamSampler,
                              engine, fw_elasticnet, fw_lasso, fw_solve, path, step_rule, vertex)
from repro_torch.core.fw_elasticnet import ENCo
from repro_torch.core.fw_lasso import LassoCo
from repro_torch.core.fw_logistic import LogisticCo
from repro_torch.core.solver_config import VALID_BACKENDS, VALID_STEP_RULES
from repro_torch.kernels import step_tail
from repro_torch.kernels.step_tail import DirEN

DELTA = 40.0
GAP_REL_TOL = 1e-4  # the reference's certified-gap bar: gap <= tol * objective
RULES = ["away", "pairwise", "partan", "lazy"]


def _corr_design(m=300, p=120, rho=0.6, k=10, scale=50.0, seed=11):
    """The reference's pinned correlated design (``tests/test_step_rules.py:
    42-61``): AR(1) columns, a strong sparse signal."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((m, p)).astype(np.float32)
    X = np.empty_like(Z)
    X[:, 0] = Z[:, 0]
    for j in range(1, p):
        X[:, j] = rho * X[:, j - 1] + np.sqrt(1 - rho**2) * Z[:, j]
    coef = np.zeros(p, np.float32)
    coef[rng.choice(p, k, replace=False)] = rng.standard_normal(k).astype(np.float32) * scale
    y = X @ coef + 1.0 * rng.standard_normal(m).astype(np.float32)
    return X.T.copy(), y.astype(np.float32)


@pytest.fixture(scope="module")
def corr():
    return _corr_design()


def _stream(p, n_steps, kappa=48, seed=1):
    """The reference engine's stream from PRNGKey(seed), legacy mode."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (kappa,), 0, p)

        _, draws = jax.lax.scan(body, jax.random.PRNGKey(seed), None, length=n_steps)
    return np.asarray(draws)


def _rule_kw(rule, **kw):
    base = dict(delta=DELTA, kappa=48, sampling="uniform", max_iters=1500, tol=1e-4,
                patience=20, step_rule=rule)
    base.update(kw)
    return base


def _solve_rule(Xt, y, rule, backend="torch", sampler=None, oracle=LASSO, **kw):
    """The reference's ``_solve_rule`` on the port, on the reference's stream
    (the sparse layout in blocks of 32, as the reference's)."""
    cfg = FWConfig(backend=backend, **_rule_kw(rule, **kw))
    op = vertex.SparseBlockMatrix.from_dense(torch.from_numpy(Xt), block_size=32) \
        if backend == "sparse" else torch.from_numpy(Xt)
    if sampler is None:
        sampler = convert.stream_from_reference(_stream(Xt.shape[0], cfg.max_iters), "cpu")
    yt = torch.from_numpy(y)
    res = engine.solve(oracle, op, yt, cfg, sampler, device="cpu")
    gap = float(oracle.gap(op, yt, res.alpha, torch.tensor(cfg.delta), cfg))
    return res, gap


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _j(x):
    return jnp.asarray(np.asarray(x))


def _ref_ds(ds):
    return ref_rules.DirStep(**{k: _j(v.numpy()) for k, v in ds._asdict().items()})


def _ds(t, df, da, i_f, i_a, a_f, a_a, sel_f, sel_a, g_max):
    f = lambda x: torch.tensor(np.float32(x))  # noqa: E731
    return step_rule.DirStep(t=f(t), df=f(df), da=f(da), i_f=torch.tensor(i_f),
                             i_a=torch.tensor(i_a), a_f=f(a_f), a_a=f(a_a), sel_f=f(sel_f),
                             sel_a=f(sel_a), same=f(float(i_f == i_a)), g_max=f(g_max))


# --------------------------------------------------------------------------
# the protocol's pieces against the reference's
# --------------------------------------------------------------------------


def _dir_cases():
    """(name, DirStep, g, scale): away, its drop, pairwise, classic, one
    coordinate for both atoms, and a renorm."""
    return [
        ("away", _ds(1.0, 0.0, -10.0, 0, 1, 3.0, 0.7, 1.0, 1.0, 0.7 / 9.3), 0.03, 1.0),
        ("drop", _ds(1.0, 0.0, -10.0, 0, 1, 3.0, 0.7, 1.0, 1.0, 0.7 / 9.3),
         np.float32(0.7 / 9.3), 1.0),
        ("pairwise", _ds(0.0, 10.0, 10.0, 3, 2, 0.25, -2.0, -4.0, 2.0, 0.2), 0.1, 1.0),
        ("classic", _ds(-1.0, -10.0, 0.0, 4, 0, 0.0, 3.0, 5.0, 1.0, 1.0), 0.4, 1.0),
        ("same", _ds(0.0, 10.0, -10.0, 2, 2, -2.0, -2.0, -3.0, 1.0, 0.2), 0.15, 1.0),
        ("renorm", _ds(-1.0, 10.0, 0.0, 3, 0, 0.25, 3.0, -1.0, 1.0, 1.0), 0.9999999, 5e-6),
    ]


@pytest.mark.parametrize("case", range(6))
def test_apply_dir_update_matches_reference(case):
    name, ds, g, scale = _dir_cases()[case]
    cfg, ref_cfg = FWConfig(delta=10.0), RefConfig(delta=10.0)
    beta = np.asarray([3.0, 0.7, -2.0, 0.25, 0.0, 1.5], np.float32)
    for no_prog in (False, True):
        got = step_rule.apply_dir_update(_t(beta).clone(), torch.tensor(np.float32(scale)),
                                         torch.tensor(3.0), torch.tensor(2, dtype=torch.int32),
                                         ds, torch.tensor(np.float32(g)), torch.tensor(no_prog),
                                         cfg)
        want = ref_rules.apply_dir_update(_j(beta), jnp.float32(scale), jnp.float32(3.0),
                                          jnp.int32(2), _ref_ds(ds), jnp.float32(g),
                                          jnp.asarray(no_prog), ref_cfg)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]), err_msg=name)
        for a, b in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6, err_msg=name)
        assert int(got[4]) == int(want[4]), name
    if name == "drop":
        assert float(got[0][1]) == 0.0  # exact zero, not dust


@pytest.mark.parametrize("cap", [4, 8, 12])
def test_init_active_set_matches_reference_with_ties(cap):
    """Tied |beta| fill the buffer in index order (lax.top_k's), larger
    first; zeros stay empty slots; a buffer wider than p pads with -1."""
    beta = np.asarray([0.0, 2.0, -2.0, 1.0, 2.0, 0.0, -1.0, 0.5, -2.0, 1.0], np.float32)
    got = step_rule.init_active_set(_t(beta), FWConfig(delta=1.0, active_set_size=cap))
    want = ref_rules.init_active_set(_j(beta), RefConfig(delta=1.0, active_set_size=cap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("buf,i_new", [
    ([3, -1, 1, -1], 5),  # the first empty slot
    ([3, 2, 1, 0], 2),  # present: unchanged
    ([3, 2, 1, 0], 5),  # full: the weakest |beta|, the first of tied ones
    ([4, 2, 1, 0], 6),  # full, a zero-weight slot
])
def test_insert_active_matches_reference(buf, i_new):
    beta = np.asarray([1.0, -0.5, 0.5, 2.0, 0.0, 1.0, 3.0], np.float32)
    got = step_rule.insert_active(_t(buf, torch.int64), torch.tensor(i_new), _t(beta))
    want = ref_rules.insert_active(_j(np.asarray(buf, np.int32)), jnp.int32(i_new), _j(beta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _backend_designs(Xt, backend):
    if backend == "sparse":
        ref_mat = RefMatrix.from_dense(Xt, block_size=32)
        return ref_mat, convert.sparse_from_reference(
            np.asarray(ref_mat.values), np.asarray(ref_mat.rows), ref_mat.p, ref_mat.m,
            ref_mat.block_size, ref_mat.nnz_max, "cpu")
    return _j(Xt), _t(Xt)


BACKENDS = [("torch", "xla"), ("kernels", "pallas"), ("sparse", "sparse")]


@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("oracle_name", ["lasso", "en"])
def test_score_indices_and_select_away_match_reference(corr, backend, ref_backend, oracle_name):
    """``score_indices`` on each backend at caller indices with -1 slots,
    the EN's shift included, and ``_select_away`` over such a buffer
    (zero-weight and empty slots masked; an all-empty buffer's dummy)."""
    Xt, y = corr
    p = Xt.shape[0]
    rng = np.random.default_rng(3)
    w = rng.standard_normal(Xt.shape[1]).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[[3, 7, 11, 50, 90]] = [1.5, -0.5, 2.0, -1.0, 0.75]
    buf = np.asarray([7, -1, 3, 11, -1, 20, 90, 50], np.int64)
    scale = np.float32(0.8)
    ref_design, design = _backend_designs(Xt, backend)
    ref_oracle, oracle = (REF_LASSO, LASSO) if oracle_name == "lasso" else (RefEN(1.0),
                                                                             ENOracle(1.0))
    cfg = FWConfig(delta=DELTA, backend=backend)
    ref_cfg = RefConfig(delta=DELTA, backend=ref_backend)
    extra = oracle.score_extra(_t(beta), torch.tensor(scale))
    ref_extra = ref_oracle.score_extra(_j(beta), jnp.float32(scale))
    raw, sel = vertex.score_indices(design, _t(w), _t(buf), p, cfg, extra)
    want_raw, want_sel = ref_vertex.score_indices(ref_design, _j(w), _j(buf.astype(np.int32)), p,
                                                  ref_cfg, ref_extra)
    cs = float(np.linalg.norm(w) * np.linalg.norm(Xt, axis=1).max())
    np.testing.assert_allclose(raw.float().numpy(), np.asarray(want_raw), rtol=0, atol=1e-6 * cs)
    np.testing.assert_allclose(sel.float().numpy(), np.asarray(want_sel), rtol=0, atol=1e-6 * cs)
    for b in (buf, np.full(8, -1, np.int64), np.asarray([20, 21, -1, 22], np.int64)):
        got = step_rule._select_away(oracle, design, _t(w), _t(b), _t(beta), torch.tensor(scale),
                                     torch.tensor(DELTA), p, cfg)
        want = ref_rules._select_away(ref_oracle, ref_design, _j(w), _j(b.astype(np.int32)),
                                      _j(beta), jnp.float32(scale), jnp.float32(DELTA), p,
                                      ref_cfg)
        assert (int(got[0]), bool(got[4])) == (int(want[0]), bool(want[4]))
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=0, atol=1e-6 * cs)
        np.testing.assert_allclose([float(got[2]), float(got[3])],
                                   [float(want[2]), float(want[3])], rtol=1e-6)


def _cos(Xt, y, oracle_name, rng):
    """The same co-state for both packages, from a random alpha."""
    p = Xt.shape[0]
    alpha = np.zeros(p, np.float32)
    alpha[[3, 11, 50]] = [1.5, -2.0, 0.75]
    v = (alpha @ Xt).astype(np.float32)
    if oracle_name == "logistic":
        return (LogisticCo(_t(v)), REF_LOGISTIC.init_co(_j(y), _j(v), _j(alpha), jnp.float32),
                alpha)
    if oracle_name == "lasso":
        ref_co = REF_LASSO.init_co(_j(y), _j(v), _j(alpha), jnp.float32)
        return (LassoCo(*(_t(np.asarray(f)) for f in ref_co)), ref_co, alpha)
    ref_co = RefEN(1.0).init_co(_j(y), _j(v), _j(alpha), jnp.float32)
    return ENCo(*(_t(np.asarray(f)) for f in ref_co)), ref_co, alpha


@pytest.mark.parametrize("oracle_name", ["lasso", "en", "logistic"])
@pytest.mark.parametrize("case", ["away", "pairwise", "classic", "same"])
def test_direction_protocol_matches_reference(corr, oracle_name, case):
    """The direction step's line search and co-state update (the refresh
    step too) against the reference oracle's ``dir_line_search`` and
    ``dir_update_co`` on the same co-state and direction: on the lasso and
    the EN the pieces ``step_tail.dir_tail_plain`` runs
    (``step_tail.dir_line_search``, ``step_tail.dir_update_co`` and the EN's
    ``q_refresh``, as ``ENOracle.dir_tail`` applies it), on the logistic
    its oracle's methods."""
    Xt, y = corr
    if oracle_name == "logistic":
        y = np.sign(y).astype(np.float32)
    rng = np.random.default_rng(5)
    co, ref_co, alpha = _cos(Xt, y, oracle_name, rng)
    ref_oracle, oracle = {"lasso": (REF_LASSO, LASSO), "en": (RefEN(1.0), ENOracle(1.0)),
                          "logistic": (REF_LOGISTIC, LOGISTIC)}[oracle_name]
    delta = 5.0
    ds = {"away": _ds(1.0, 0.0, -delta, 7, 11, 0.0, -2.0, 30.0, -40.0, 2.0 / 3.0),
          "pairwise": _ds(0.0, -delta, delta, 7, 11, 0.0, -2.0, 30.0, -40.0, 0.4),
          "classic": _ds(-1.0, -delta, 0.0, 7, 0, 0.0, 0.0, 30.0, 1.0, 1.0),
          "same": _ds(0.0, -delta, delta, 3, 3, 1.5, 1.5, 30.0, 30.0, 0.3)}[case]
    cols = np.stack([Xt[int(ds.i_f)], Xt[int(ds.i_a)]])
    u = (float(ds.df) * cols[0] + float(ds.da) * cols[1]).astype(np.float32)
    cfg, ref_cfg = FWConfig(delta=delta), RefConfig(delta=delta)
    stats = engine.precompute_colstats(_t(Xt), _t(y))
    ref_stats = ref_engine.precompute_colstats(_j(Xt), _j(y))
    en = DirEN(1.0, co.q_norm) if oracle_name == "en" else None
    if oracle_name == "logistic":
        g, no_prog, aux = oracle.dir_line_search(_t(y), stats, co, ds, _t(u), cfg)
    else:
        g, no_prog, aux = step_tail.dir_line_search(ds, _t(u), co.resid, _t(y), co.s_quad,
                                                    co.f_lin, cfg.eps_den, cfg.gap_rtol, en)
    rg, rno_prog, raux = ref_oracle.dir_line_search(_j(y), ref_stats, ref_co, _ref_ds(ds), _j(u),
                                                    ref_cfg)
    assert bool(no_prog) == bool(rno_prog)
    scale_u = float(np.linalg.norm(u) * (np.linalg.norm(y) + np.linalg.norm(u)))
    if oracle_name == "logistic":
        np.testing.assert_allclose(float(g), float(rg), rtol=0, atol=1e-5 * float(ds.g_max))
        np.testing.assert_allclose(aux.numpy(), np.asarray(raux), rtol=0,
                                   atol=1e-6 * float(np.abs(u).max() + np.abs(y).max()))
    else:
        np.testing.assert_allclose(float(g), float(rg), rtol=1e-5)
        np.testing.assert_allclose([float(a) for a in aux], [float(a) for a in raux], rtol=0,
                                   atol=1e-6 * scale_u)
    beta = _t(alpha)
    for k in (5, 63):  # a recursion step, then a refresh step (refresh_every 64)
        if oracle_name == "logistic":
            got = oracle.dir_update_co(_t(Xt), _t(y), stats, co, beta, torch.tensor(1.0), ds,
                                       rg_t(rg), _t(u), k, cfg, aux)
        else:
            got = step_tail.dir_update_co(co.resid, _t(y), _t(u), ds, rg_t(rg), co.s_quad,
                                          co.f_lin, aux, fw_lasso.refresh_step(k, cfg),
                                          torch.float32, None if en is None else en.q_norm)
            got = got[:3] if en is None else got[:3] + (
                fw_elasticnet.q_refresh(got[3], beta, torch.tensor(1.0), k, cfg),)
        want = ref_oracle.dir_update_co(_j(Xt), _j(y), ref_stats, ref_co, _j(alpha),
                                        jnp.float32(1.0), _ref_ds(ds), jnp.float32(rg), _j(u),
                                        jnp.int32(k), ref_cfg, raux)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * float(np.abs(b).max() + 1))


def rg_t(rg):
    return torch.tensor(np.float32(rg))


@pytest.mark.parametrize("oracle_name", ["lasso", "en", "logistic"])
def test_partan_protocol_matches_reference(corr, oracle_name):
    Xt, y = corr
    if oracle_name == "logistic":
        y = np.sign(y).astype(np.float32)
    rng = np.random.default_rng(9)
    co, ref_co, alpha = _cos(Xt, y, oracle_name, rng)
    ref_oracle, oracle = {"lasso": (REF_LASSO, LASSO), "en": (RefEN(1.0), ENOracle(1.0)),
                          "logistic": (REF_LOGISTIC, LOGISTIC)}[oracle_name]
    dp = np.zeros_like(alpha)
    dp[[3, 11, 20]] = [0.1, -0.3, 0.2]
    u = (dp @ Xt).astype(np.float32)
    cfg, ref_cfg = FWConfig(delta=5.0), RefConfig(delta=5.0)
    mu = oracle.partan_mu(_t(y), None, co, _t(u), _t(alpha), _t(dp), step_rule.PARTAN_MU_CAP,
                          cfg)
    rmu = ref_oracle.partan_mu(_j(y), None, ref_co, _j(u), _j(alpha), _j(dp),
                               jnp.asarray(ref_rules.PARTAN_MU_CAP), ref_cfg)
    tol = 1e-5 * step_rule.PARTAN_MU_CAP if oracle_name == "logistic" else 1e-5 * float(rmu)
    np.testing.assert_allclose(float(mu), float(rmu), rtol=0, atol=tol)
    a_new = (alpha + float(rmu) * dp).astype(np.float32)
    got = oracle.partan_update_co(_t(y), None, co, _t(a_new), torch.tensor(np.float32(rmu)),
                                  _t(u), cfg)
    want = ref_oracle.partan_update_co(_j(y), None, ref_co, _j(a_new), jnp.float32(rmu), _j(u),
                                       ref_cfg)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6 * float(np.abs(b).max() + 1))
    assert step_rule.PARTAN_MU_CAP == ref_rules.PARTAN_MU_CAP
    assert step_rule.PARTAN_DRIFT_LIMIT == ref_rules.PARTAN_DRIFT_LIMIT
    assert (step_rule.DIR_EXTRA_DOTS, step_rule.PARTAN_EXTRA_DOTS) == (
        ref_rules.DIR_EXTRA_DOTS, ref_rules.PARTAN_EXTRA_DOTS)


# --------------------------------------------------------------------------
# the port's versions of tests/test_step_rules.py
# --------------------------------------------------------------------------


class TestConfigValidation:
    def test_bad_backend_raises_with_choices(self):
        with pytest.raises(ValueError) as ei:
            FWConfig(delta=1.0, backend="gpu")
        msg = str(ei.value)
        assert "backend" in msg and "'gpu'" in msg
        for b in VALID_BACKENDS:
            assert b in msg

    def test_bad_step_rule_raises_with_choices(self):
        with pytest.raises(ValueError) as ei:
            FWConfig(delta=1.0, step_rule="awaystep")
        msg = str(ei.value)
        assert "step_rule" in msg and "'awaystep'" in msg
        for r in VALID_STEP_RULES:
            assert r in msg

    @pytest.mark.parametrize("rule", VALID_STEP_RULES)
    def test_every_registered_rule_constructs_and_resolves(self, rule):
        cfg = FWConfig(delta=1.0, step_rule=rule)
        assert step_rule.get_rule(cfg).name == rule
        assert step_rule.get_rule(None).name == "classic"


class TestClassicParity:
    @pytest.mark.parametrize("backend", ["torch", "kernels", "sparse"])
    def test_classic_rule_bit_identical_to_default(self, corr, backend):
        """'classic' is ``engine.step`` itself: the same bits as a config
        that never names a rule, on every backend."""
        Xt, y = corr
        r_default, _ = _solve_rule(Xt, y, "classic", backend, max_iters=300)
        cfg = FWConfig(delta=DELTA, kappa=48, sampling="uniform", max_iters=300, tol=1e-4,
                       patience=20, backend=backend)
        op = vertex.SparseBlockMatrix.from_dense(torch.from_numpy(Xt), block_size=32) \
            if backend == "sparse" else torch.from_numpy(Xt)
        r_again = engine.solve(LASSO, op, torch.from_numpy(y), cfg,
                               convert.stream_from_reference(_stream(Xt.shape[0], 300), "cpu"),
                               device="cpu")
        assert torch.equal(r_default.alpha, r_again.alpha)
        assert (r_default.iterations, r_default.n_dots) == (r_again.iterations, r_again.n_dots)

    def test_rule_state_slot_defaults_empty(self):
        st = engine.EngineState(
            beta=torch.zeros(4), scale=torch.ones(()), co=None, maxabs=torch.zeros(()),
            step_inf=torch.zeros(()), stall=torch.zeros((), dtype=torch.int32), n_dots=0, k=0,
            i_star=torch.tensor(-1))
        assert st.rule == () and st.stall_host is None


class TestRuleAcceptance:
    """The reference's acceptance bars on its pinned correlated design, on
    its own index stream (the three of these that fail for the reference
    outside legacy mode, R1, pass here in it)."""

    @pytest.mark.parametrize("backend", ["torch", "sparse"])
    def test_away_and_pairwise_beat_classic(self, corr, backend):
        Xt, y = corr
        r_classic, _ = _solve_rule(Xt, y, "classic", backend)
        obj_c = float(r_classic.objective)
        for rule in ("away", "pairwise"):
            r, gap = _solve_rule(Xt, y, rule, backend)
            assert r.iterations <= r_classic.iterations, rule
            assert gap <= GAP_REL_TOL * float(r.objective), (rule, gap)
            assert float(torch.sum(torch.abs(r.alpha))) <= DELTA * (1 + 1e-4)
            assert abs(float(r.objective) - obj_c) / obj_c < 1e-3, rule

    @pytest.mark.parametrize("backend", ["torch", "sparse"])
    def test_away_converges_several_times_faster(self, corr, backend):
        """The reference's bars; its ``gap_a < gap_c`` compares two gaps at
        the f32 rounding floor of the objective (2.7e6, whose ulp is 0.25;
        the reference's legacy-mode run has 0.3125 against 0.4375), which the
        port's sparse run ties at 0.0625, so here it holds within one ulp of
        the objective."""
        Xt, y = corr
        r_classic, gap_c = _solve_rule(Xt, y, "classic", backend)
        r_away, gap_a = _solve_rule(Xt, y, "away", backend)
        assert bool(r_away.converged)
        assert r_away.iterations * 4 < r_classic.iterations
        assert gap_a <= gap_c + float(np.spacing(np.float32(r_classic.objective)))

    @pytest.mark.parametrize("rule", ["partan", "lazy"])
    def test_partan_and_lazy_certify(self, corr, rule):
        Xt, y = corr
        r, gap = _solve_rule(Xt, y, rule)
        assert gap <= GAP_REL_TOL * float(r.objective), (rule, gap)
        true_obj = 0.5 * float(np.sum((Xt.T @ r.alpha.numpy() - y) ** 2))
        assert abs(float(r.objective) - true_obj) / true_obj < 1e-3

    def test_lazy_saves_dots(self, corr):
        Xt, y = corr
        r_classic, _ = _solve_rule(Xt, y, "classic")
        r_lazy, _ = _solve_rule(Xt, y, "lazy")
        per_c = r_classic.n_dots / r_classic.iterations
        per_l = r_lazy.n_dots / r_lazy.iterations
        assert per_l < 0.6 * per_c, (per_l, per_c)


class TestDropStep:
    def test_away_drop_zeroes_coordinate_exactly(self):
        ds = _ds(1.0, 0.0, -10.0, 0, 1, 3.0, 0.7, 1.0, 1.0, 0.7 / 9.3)
        beta2, scale2, _, _, _ = step_rule.apply_dir_update(
            torch.tensor([3.0, 0.7, -2.0]), torch.ones(()), torch.tensor(3.0),
            torch.zeros((), dtype=torch.int32), ds, ds.g_max, torch.tensor(False),
            FWConfig(delta=10.0))
        assert float(beta2[1]) == 0.0
        assert float(scale2) == pytest.approx(1.0 + float(ds.g_max), rel=1e-6)

    def test_away_run_prunes_support(self, corr):
        Xt, y = corr
        r_classic, _ = _solve_rule(Xt, y, "classic")
        r_away, _ = _solve_rule(Xt, y, "away")
        assert int(r_away.active) <= int(r_classic.active)


class TestFusedFallback:
    def test_classic_fuses(self, corr):
        Xt, y = corr
        r, _ = _solve_rule(Xt, y, "classic", "kernels", max_iters=256, fuse_steps=8)
        assert r.effective_fuse_steps == 8

    def test_non_classic_rule_warns_once_and_falls_back(self, corr):
        Xt, y = corr
        vertex._warned_unfused_rules.discard("away")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r, _ = _solve_rule(Xt, y, "away", "kernels", max_iters=64, fuse_steps=8)
            _solve_rule(Xt, y, "away", "kernels", max_iters=64, fuse_steps=8)
        msgs = [str(w.message) for w in caught if "does not compose" in str(w.message)]
        assert len(msgs) == 1
        assert "away" in msgs[0] and "falling back" in msgs[0]
        assert r.effective_fuse_steps == 1
        # the per-step loop it fell back to: the unfused solve, bit for bit
        r1, _ = _solve_rule(Xt, y, "away", "kernels", max_iters=64)
        assert torch.equal(r.alpha, r1.alpha) and r.iterations == r1.iterations

    def test_logistic_oracle_reports_unfused(self, corr):
        Xt, y = corr
        ylog = np.sign(y).astype(np.float32)
        res, _ = _solve_rule(Xt, ylog, "classic", max_iters=64, fuse_steps=8, delta=5.0,
                             oracle=LOGISTIC)
        assert res.effective_fuse_steps == 1


def test_rule_lanes_are_refused_naming_item_9a(corr):
    """Item 9a is done: the batched entry points take the rules, no longer
    refusing them (``tests/test_torch_rule_lanes.py`` holds each lane to its
    sequential solve and to the reference's lanes)."""
    Xt, y = corr
    cfg = FWConfig(delta=1.0, step_rule="lazy", max_iters=5)
    res, _ = engine.solve_batched(LASSO, torch.from_numpy(Xt), torch.from_numpy(y), cfg,
                                  LaneSampler(0, 2, "cpu"), None, [1.0, 2.0], device="cpu")
    assert res.iterations == [5, 5]
    res = path.fw_path_batched(Xt, y, [1.0, 2.0], cfg, device="cpu")
    assert [pt.iterations for pt in res.points] == [5, 5]


def test_lazy_hit_passes_over_its_row(corr):
    """A cache hit still takes its step's row of the stream (the reference
    splits its key on every step): with ``skip`` doing nothing, the first
    draw after the first hit reads the hit's row and the run leaves the
    reference's vertex sequence, which the real run keeps up to there."""
    Xt, y = corr
    p, n = Xt.shape[0], 60
    draws = _stream(p, n)
    kw = _rule_kw("lazy", max_iters=n, tol=0.0, patience=10**9)
    with jax.threefry_partitionable(False):
        from repro.obs.telemetry import TelemetrySpec, ring_to_records

        ref = ref_engine.solve(REF_LASSO, _j(Xt), _j(y),
                               RefConfig(telemetry=TelemetrySpec(capacity=n,
                                                                 record_objective=False), **kw),
                               jax.random.PRNGKey(1))
    ref_seq = ring_to_records(ref.telemetry)["i_star"]

    class NoSkip(StreamSampler):
        def skip(self):
            pass

    runs = {}
    for name, sampler in (("skip", StreamSampler(torch.from_numpy(draws))),
                          ("no skip", NoSkip(torch.from_numpy(draws)))):
        seq, dots = [], []
        engine.solve(LASSO, _t(Xt), _t(y), FWConfig(backend="torch", **kw), sampler,
                     device="cpu", on_step=lambda s: (seq.append(int(s.i_star)),
                                                      dots.append(s.n_dots)))
        runs[name] = (np.asarray(seq), np.diff([0] + dots))
    seq, steps = runs["skip"]
    hits = np.nonzero(steps < 48)[0]  # a hit pays the cache's 16 dots, a miss 16 + 48
    assert hits.size, "the run needs a cache hit"
    wrong = np.nonzero(runs["no skip"][0] != ref_seq)[0]
    assert wrong.size and wrong[0] > hits[0]
    np.testing.assert_array_equal(seq[:wrong[0] + 1], ref_seq[:wrong[0] + 1])


@pytest.mark.parametrize("rule", RULES)
def test_bf16_rule_solve(corr, rule):
    """One bf16 solve a rule on 'kernels', held to ``test_solver_dtypes``'s
    bars: a finite objective, l1 <= delta (1 + 5e-2), and a true objective
    (float64) within 1e-2 of the same rule's float32 solve's."""
    Xt, y = corr
    kw = dict(_rule_kw(rule, max_iters=600), backend="kernels")
    sampler = lambda: convert.stream_from_reference(_stream(Xt.shape[0], 600), "cpu")  # noqa: E731
    r32 = fw_solve(torch.from_numpy(Xt), torch.from_numpy(y), FWConfig(**kw), sampler(),
                   device="cpu")
    r16 = fw_solve(torch.from_numpy(Xt).bfloat16(), torch.from_numpy(y).bfloat16(),
                   FWConfig(**kw), sampler(), device="cpu")
    assert r16.alpha.dtype == torch.bfloat16 and np.isfinite(float(r16.objective))
    a16 = r16.alpha.float().numpy().astype(np.float64)
    assert np.abs(a16).sum() <= DELTA * (1 + 5e-2)

    def true_obj(a):
        r = y.astype(np.float64) - a @ Xt.astype(np.float64)
        return 0.5 * r @ r

    want = true_obj(r32.alpha.numpy().astype(np.float64))
    assert abs(true_obj(a16) - want) <= 1e-2 * abs(want)
