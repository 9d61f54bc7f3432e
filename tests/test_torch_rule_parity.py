"""The port's step rules (``repro_torch.core.step_rule``) against the JAX
reference's on the CPU, in one process: every rule on every oracle and
backend on the reference's correlated acceptance design
(``tests/test_step_rules.py:42-61``, m = 300, p = 120) with delta inside the
unconstrained l1 norm's reach (2000; the logistic's 5), then the history
solve, the path and a continuation from a mid-run reference state on the
``small_problem`` geometry of ``tests/test_engine.py``.

Both packages get the same numpy problem and the same index stream: the
reference's own, drawn inside ``jax.threefry_partitionable(False)`` (the
mode its goldens were pinned under, ROADMAP.md Queue 3 R1) and replayed
through ``convert.stream_from_reference``; a lazy cache hit passes over its
step's row (``StreamSampler.skip``), as the reference splits its key on
every step. The reference's trajectory is its own ``engine.rule_step``
driven from Python, one jitted step at a time, which is its ``solve`` bit
for bit (alpha and every step's objective, checked on every rule, oracle
and backend of this file); its vertex sequence comes from its telemetry
ring, which leaves the trajectory bitwise as it is
(``tests/test_obs.py:92``).

Each solve is held to the reference in two ways.

* Step by step. Every reference state of the run is carried into the port
  (``convert.state_from_reference``) and stepped once on that step's draw;
  the port's step must make the reference's decisions (the vertex, the
  support, the stall count, n_dots, the active-set buffer or the lazy
  cache) and land on its next state: alpha at 1e-6 of delta (the l1
  radius bounds every coordinate, and one step's alpha is the old one
  moved by g times an atom of size delta), the objective at rtol 1e-6 of
  its scale times the step's amplification (1 + g)^2: S' = (1 + g t)^2 S
  + 2 (1 + g t) g <v, u> + g^2 <u, u> rounds at the scale of its terms,
  and an away step from an atom that holds all the weight (w_a = 1, as a
  path's rescaled warm start from one atom is) has a zero direction, g at
  its 1e3 clip and those terms 1e6 times S (ROADMAP.md R5,
  ``test_away_drop_at_the_clip_leaves_the_recursions_behind``). A step
  whose decisions differ must be a near-tie (below), and at most
  ``MAX_SPLIT_SHARE`` of the steps may be, but for the lazy hit test: on
  a converged run both gap and phi are rounding noise, so a split there
  is retaken on the reference's side of the test and held to every fact.
  PARTAN's near-ties also excuse its values (its l1 test picks mu between
  two branches, and its O(p) reductions sum in another order than
  XLA's).
* As a whole run from the same start. The decisions are equal up to the
  port's first near-tie, and alpha and the objective at every step before
  it at the tolerances above; a run with no near-tie has its iterations,
  n_dots, support and vertex sequence exact and its final objective at
  rtol 1e-6; after a near-tie the final objectives agree within the larger
  certified gap of the two runs (or that rounding, when both gaps round
  to 0). On the acceptance design every run is exact but pairwise's,
  whose first pair step balances its two atoms (a near-tie at step 2),
  and the logistic's away and lazy runs, which compare at least
  ``MIN_RUN_STEPS`` steps before theirs.

Near-ties, and why. The two packages' f32 sums round apart by a few ulps,
so on a decision that rounding decides they may take either side, and the
rules make such decisions by construction:

  * an exact line search along a pair of atoms leaves their leave-scores
    equal in exact arithmetic (the two atoms of a face after a FW step from
    the l1 sphere, and both atoms of every pairwise step), so the away
    argmax is a tie that f32 rounding decides;
  * PARTAN's l1 test ``||a_mid + mu dp||_1 <= delta (1 + 1e-6)`` sits on the
    sphere whenever the iterate does, and its drift odometer crosses its
    limit after a product of such steps;
  * a lazy cache holds the atoms a line search just balanced, and its hit
    test compares a gap with phi, which earlier gaps set.

``chip_smoke.RuleTieProbe`` records, while the port runs, each decision's
margin: the top two |scores| of the draw, the top two leave scores of the
buffer, the away-or-FW comparison, the drop test g = g_max, PARTAN's l1
test and odometer, and the lazy rule's cache argmax, hit test and phi
update. A margin within ``RTOL_TIE`` = 1e-4 of its scale (``chip_smoke.py``'s
near-tie bound) is a near-tie.
"""
import contextlib
import dataclasses
import sys
from pathlib import Path
from typing import NamedTuple

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
from repro.core import path as ref_path
from repro.core import vertex as ref_vertex
from repro.obs.telemetry import TelemetrySpec, ring_to_records
from repro.sparse import SparseBlockMatrix as RefMatrix

from repro_torch import convert
from repro_torch.core import LASSO, LOGISTIC, ENOracle, FWConfig, engine, path, step_rule

KAPPA, SEED, DELTA, LOG_DELTA = 60, 42, 30.0, 5.0
# the acceptance design's solves: the reference's kappa, an interior delta,
# 60 steps
CORR_KAPPA, CORR_DELTA, CORR_STEPS = 48, 2000.0, 60
RTOL_TIE = 1e-4
RTOL_STEP = 1e-6  # alpha at this share of delta, the objective of its scale
# the share of a run's steps whose decisions may differ (each a near-tie)
MAX_SPLIT_SHARE = 0.1
# the steps a whole run compares at least before its first near-tie
MIN_RUN_STEPS = 20
RULES = ["away", "pairwise", "partan", "lazy"]
BACKENDS = [("torch", "xla"), ("kernels", "pallas"), ("sparse", "sparse")]
ORACLES = ["lasso", "en", "logistic"]


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    Xt = np.ascontiguousarray(ds.X.T)
    return Xt, np.asarray(ds.y, np.float32)


@pytest.fixture(scope="module")
def corr():
    """The reference's pinned correlated design (``tests/test_step_rules.py:
    42-61``): AR(1) columns, rho 0.6, a strong 10-sparse signal."""
    rng = np.random.default_rng(11)
    m, p, rho = 300, 120, 0.6
    Z = rng.standard_normal((m, p)).astype(np.float32)
    X = np.empty_like(Z)
    X[:, 0] = Z[:, 0]
    for j in range(1, p):
        X[:, j] = rho * X[:, j - 1] + np.sqrt(1 - rho**2) * Z[:, j]
    coef = np.zeros(p, np.float32)
    coef[rng.choice(p, 10, replace=False)] = rng.standard_normal(10).astype(np.float32) * 50.0
    y = X @ coef + 1.0 * rng.standard_normal(m).astype(np.float32)
    return X.T.copy(), y.astype(np.float32)


def _uniform(n_steps, p, key=None, kappa=KAPPA):
    """The reference engine's stream: key, sub = split(key); randint(sub)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (kappa,), 0, p)

        key = jax.random.PRNGKey(SEED) if key is None else key
        _, draws = jax.lax.scan(body, key, None, length=n_steps)
    return np.asarray(draws)


def _oracles(name):
    if name == "lasso":
        return REF_LASSO, LASSO
    if name == "en":
        return RefEN(1.0), ENOracle(1.0)
    return REF_LOGISTIC, LOGISTIC


def _designs(Xt, backend):
    if backend == "sparse":
        ref_mat = RefMatrix.from_dense(Xt, block_size=64)
        return ref_mat, convert.sparse_from_reference(
            np.asarray(ref_mat.values), np.asarray(ref_mat.rows), ref_mat.p, ref_mat.m,
            ref_mat.block_size, ref_mat.nnz_max, "cpu")
    return jnp.asarray(Xt), torch.from_numpy(Xt)


def _problem(prob, oracle_name, delta=DELTA):
    Xt, y = prob
    if oracle_name == "logistic":
        return Xt, np.sign(y).astype(np.float32), LOG_DELTA
    return Xt, y, delta


def _kw(rule, delta, **over):
    kw = dict(delta=delta, kappa=KAPPA, sampling="uniform", max_iters=300, tol=1e-4,
              patience=20, step_rule=rule)
    kw.update(over)
    return kw


def _obj_scale(oracle_name, y):
    """The objective's rounding scale: for the lasso and the EN the sum of
    its terms' magnitudes, 0.5 y^T y + 0.5 S + |F|, which is 2 y^T y at an
    interior optimum where S and F are y^T y (the objective is their
    difference, far smaller, and rounds at their scale); 0 for the
    logistic (its objective's own magnitude)."""
    return 0.0 if oracle_name == "logistic" else 2.0 * float(np.dot(y, y))


# --------------------------------------------------------------------------
# the reference's trajectory
# --------------------------------------------------------------------------


class Trace(NamedTuple):
    """The reference's run: its state before each step and after the last
    (the arrays ``convert.state_from_reference`` takes), each step's
    objective after it, each step's vertex and step size (its telemetry
    ring's), and the final state's alpha."""

    states: list
    objective: np.ndarray
    i_star: np.ndarray
    lam: np.ndarray
    alpha: np.ndarray


def _arrays(st, rule):
    out = {"beta": st.beta, "scale": st.scale, "maxabs": st.maxabs, "step_inf": st.step_inf,
           "stall": st.stall, "n_dots": st.n_dots, "k": st.k}
    out.update({f"co.{name}": getattr(st.co, name) for name in st.co._fields})
    if rule in ("away", "pairwise"):
        out["rule.buffer"] = st.rule
    elif rule == "partan":
        out.update(zip(("rule.a_prev", "rule.v_prev", "rule.drift"), st.rule))
    elif rule == "lazy":
        out.update(zip(("rule.cache", "rule.phi"), st.rule))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["alpha"] = out["scale"] * out["beta"]
    return out


def _ref_trace(oracle, design, y, backend, kw, key=None, alpha0=None, delta=None,
               n_steps=None):
    """The reference's ``rule_step`` from its ``init_state``, one jitted step
    at a time, until its stopping rule fires or max_iters (``n_steps``
    steps when given, stopping rule off)."""
    n_max = kw["max_iters"] if n_steps is None else n_steps
    cfg = RefConfig(backend=backend, telemetry=TelemetrySpec(capacity=n_max,
                                                             record_objective=False), **kw)
    rule = kw["step_rule"]
    with jax.threefry_partitionable(False):
        Y = jnp.asarray(y)
        stats = ref_engine.precompute_colstats(design, Y, cfg) if oracle.needs_stats else None
        st = ref_engine.init_state(oracle, design, Y, jax.random.PRNGKey(SEED) if key is None
                                   else key, None if alpha0 is None else jnp.asarray(alpha0), cfg)
        X = ref_vertex.pad_backend_matrix(design, cfg)
        d = jnp.asarray(kw["delta"] if delta is None else delta)
        step = jax.jit(lambda s: ref_engine.rule_step(oracle, X, Y, stats, s, cfg, d))
        patience = 10**9 if n_steps is not None else ref_engine._patience(cfg)
        states, objective = [_arrays(st, rule)], []
        while int(st.k) < n_max and int(st.stall) < patience:
            st = step(st)
            states.append(_arrays(st, rule))
            objective.append(float(oracle.objective(Y, stats, st.co, cfg)))
        ring = ring_to_records(st.tel)
    return Trace(states, np.asarray(objective), ring["i_star"].astype(np.int64),
                 ring["lam"].astype(np.float64), states[-1]["alpha"])


# --------------------------------------------------------------------------
# the port, probed for near-ties (see the module docstring)
# --------------------------------------------------------------------------


def _probe(design):
    """``chip_smoke.RuleTieProbe`` on ``design``: while a run goes inside it,
    the first step of each grid point where one of the rules' decisions is a
    near-tie (within RTOL_TIE of its Cauchy-Schwarz scale)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.RTOL_TIE == RTOL_TIE
    return chip_smoke.RuleTieProbe(torch, design)


class Step(NamedTuple):
    """A port state's facts, as the comparisons read them."""

    i_star: int
    n_dots: int
    stall: int
    alpha: np.ndarray
    objective: float
    rule: tuple
    # the step's rounding amplification (1 + |g|)^2: the S/F recursions
    # multiply S by (1 + g t)^2 and add back as much (a reference step's)
    amp: float = 1.0

    @classmethod
    def of(cls, oracle, y, stats, state):
        rule = state.rule
        if torch.is_tensor(rule):
            rule = (rule.tolist(),)  # the active-set buffer
        elif rule and rule[0].dtype == torch.int64:
            rule = (rule[0].tolist(), float(rule[1]))  # the lazy cache and phi
        else:
            rule = ()  # PARTAN's floats ride alpha
        return cls(int(state.i_star), int(state.n_dots), int(state.stall),
                   (state.scale * state.beta).double().numpy(),
                   float(oracle.objective(y, stats, state.co)), rule)

    def decisions(self):
        return (self.i_star, self.n_dots, self.stall, tuple(np.nonzero(self.alpha)[0]),
                tuple(self.rule[0]) if self.rule else ())


def _ref_step(trace, t, rule):
    """The reference's facts after its step t, as a ``Step``."""
    st = trace.states[t + 1]
    if rule in ("away", "pairwise"):
        extra = (st["rule.buffer"].astype(np.int64).tolist(),)
    elif rule == "lazy":
        extra = (st["rule.cache"].astype(np.int64).tolist(), float(st["rule.phi"]))
    else:
        extra = ()
    return Step(int(trace.i_star[t]), int(st["n_dots"]), int(st["stall"]),
                st["alpha"].astype(np.float64), float(trace.objective[t]), extra,
                (1.0 + abs(float(trace.lam[t])))**2)


def _values_close(got: Step, want: Step, delta, obj_scale):
    """alpha at RTOL_STEP of delta; the objective at RTOL_STEP of its scale
    times the step's amplification ``want.amp``; the lazy rule's phi (half
    a gap <grad, alpha> + delta |sel|, whose terms are the objective's) at
    RTOL_STEP of the objective's scale. Returns what differs."""
    bad = []
    scale = max(abs(want.objective), obj_scale)
    if np.max(np.abs(got.alpha - want.alpha), initial=0.0) > RTOL_STEP * delta:
        bad.append(f"alpha by {np.max(np.abs(got.alpha - want.alpha)):.3g}")
    if abs(got.objective - want.objective) > RTOL_STEP * want.amp * scale:
        bad.append(f"objective {got.objective!r} against {want.objective!r} (amplification "
                   f"{want.amp:.4g})")
    if len(want.rule) == 2 and np.isfinite(want.rule[1]) and (
            abs(got.rule[1] - want.rule[1]) > RTOL_STEP * max(scale, abs(want.rule[1]))):
        bad.append(f"phi {got.rule[1]!r} against {want.rule[1]!r}")
    return bad


def _prepared(oracle, design, y, cfg):
    X, Y = engine.prepare_inputs(design, torch.from_numpy(np.asarray(y)), cfg, "cpu")
    return X, Y, engine.precompute_colstats(X, Y, cfg) if oracle.needs_stats else None


def _step_by_step(oracle, design, y, cfg, trace, draws, delta, obj_scale):
    """Each of the reference's states stepped once by the port on its step's
    draw (see the module docstring). Returns the steps compared in full and
    the near-ties that excused a split."""
    X, Y, stats = _prepared(oracle, design, y, cfg)
    d = torch.tensor(float(delta))
    rule = cfg.step_rule
    full, splits = 0, []

    def port_step(t, hit=None):
        state = convert.state_from_reference(trace.states[t], "cpu")
        probe = _probe(X)
        sampler = probe.sampler(convert.stream_from_reference(draws[t:t + 1], "cpu"))
        with probe, _forced_hit(hit):
            new = engine.rule_step(oracle, X, Y, stats, state, cfg, d, sampler)
        return Step.of(oracle, Y, stats, new), probe.first.get(0)

    for t in range(len(trace.objective)):
        got, tie = port_step(t)
        want = _ref_step(trace, t, rule)
        if (got.decisions() != want.decisions() and tie is not None
                and tie[1] == "the lazy hit test"):
            # the hit test at a near-tie: take the reference's side of it
            # (a hit scores the cache only) and hold the step to the rest
            hit = (want.n_dots - int(trace.states[t]["n_dots"])
                   == cfg.lazy_cache + 1 + oracle.extra_dots)
            got, _ = port_step(t, hit)
            splits.append((t, "the lazy hit test, taken as the reference took it"))
            assert got.decisions() == want.decisions(), f"step {t} with the reference's hit"
            assert not _values_close(got, want, delta, obj_scale), f"step {t}"
            full += 1
            continue
        if got.decisions() != want.decisions():
            assert tie is not None, (
                f"step {t}: the port's decisions {got.decisions()} against the reference's "
                f"{want.decisions()}, with no near-tie")
            splits.append((t, tie[1]))
            continue
        bad = _values_close(got, want, delta, obj_scale)
        if bad and rule == "partan" and tie is not None:
            splits.append((t, tie[1]))
            continue
        assert not bad, f"step {t}: {', '.join(bad)}"
        full += 1
    n = len(trace.objective)
    excused = [t for t, what in splits if "taken as the reference" not in what]
    assert len(excused) <= MAX_SPLIT_SHARE * n, f"{len(excused)} of {n} steps split: {splits}"
    return full, splits


@contextlib.contextmanager
def _forced_hit(hit):
    """With ``hit`` not None, the lazy rule's first cache peek says ``hit``."""
    if hit is None:
        yield
        return
    orig = step_rule.LazyRule.__dict__["_peek"]
    calls = []

    def peek(*args):
        out = orig.__func__(*args)
        calls.append(1)
        return out._replace(hit=torch.tensor(hit)) if len(calls) == 1 else out

    step_rule.LazyRule._peek = staticmethod(peek)
    try:
        yield
    finally:
        step_rule.LazyRule._peek = orig


def _free_run(oracle, design, y, cfg, draws, alpha0=None, delta=None):
    """The port's solve on the reference's stream, probed; returns the
    result, each step's ``Step`` and the first near-tie ``(step, what)`` or
    None."""
    X, Y, stats = _prepared(oracle, design, y, cfg)
    probe = _probe(X)
    steps = []

    def on_step(state):
        steps.append(Step.of(oracle, Y, stats, state))
        probe.on_step(0, state)

    with probe:
        res = engine.solve(oracle, X, Y, cfg,
                           probe.sampler(convert.stream_from_reference(draws, "cpu")),
                           None if alpha0 is None else torch.as_tensor(np.asarray(alpha0)),
                           delta, device="cpu", on_step=on_step)
    return res, steps, probe.first.get(0)


def _check_run(oracle, design, y, res, steps, tie, trace, delta, obj_scale, rule):
    """The whole run against the reference's (see the module docstring).
    Returns the number of steps compared in full and what ended them."""
    want = [_ref_step(trace, t, rule) for t in range(len(trace.objective))]
    common = min(len(steps), len(want))
    split = next((t for t in range(common) if steps[t].decisions() != want[t].decisions()),
                 None)
    if split is None and len(steps) != len(want):
        split = common
    if split is not None:
        assert tie is not None and split >= tie[0], (
            f"step {split}: the port's decisions differ from the reference's before the first "
            f"near-tie ({tie})")
    end = min(common, split if split is not None else common, tie[0] if tie else common)
    for t in range(end):
        bad = _values_close(steps[t], want[t], delta, obj_scale)
        assert not bad, f"step {t}, before any near-tie: {', '.join(bad)}"
    assert float(torch.sum(torch.abs(res.alpha))) <= delta * (1 + 1e-4)
    assert np.isfinite(float(res.objective))
    if tie is None:
        assert split is None
        assert (res.iterations, res.n_dots, int(res.active)) == (
            len(want), want[-1].n_dots, int(np.count_nonzero(trace.alpha)))
        np.testing.assert_array_equal(np.nonzero(res.alpha.numpy())[0], np.nonzero(trace.alpha)[0])
        assert abs(float(res.objective) - trace.objective[-1]) <= 1e-6 * max(
            abs(trace.objective[-1]), obj_scale)
        return end, "exact"
    d = torch.tensor(float(delta))
    yy = torch.from_numpy(np.asarray(y))
    gaps = [float(oracle.gap(design, yy, torch.as_tensor(a, dtype=torch.float32), d))
            for a in (res.alpha.numpy(), trace.alpha)]
    assert abs(float(res.objective) - trace.objective[-1]) <= max(
        max(gaps), 1e-6 * max(abs(trace.objective[-1]), obj_scale)), (
        f"objectives {float(res.objective)!r} and {trace.objective[-1]!r} differ by more than "
        f"the larger certified gap {max(gaps)!r}")
    return end, f"near-tie at step {tie[0]} ({tie[1]})"


@pytest.mark.parametrize("oracle_name", ORACLES)
@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("rule", RULES)
def test_rule_solve_matches_reference(corr, rule, backend, ref_backend, oracle_name):
    """Every rule x backend x oracle on the acceptance design: each of the
    reference's steps taken by the port from the reference's state, then the
    whole run from the same start."""
    Xt, y, delta = _problem(corr, oracle_name, CORR_DELTA)
    ref_oracle, oracle = _oracles(oracle_name)
    ref_design, design = _designs(Xt, backend)
    kw = _kw(rule, delta, kappa=CORR_KAPPA, max_iters=CORR_STEPS)
    trace = _ref_trace(ref_oracle, ref_design, y, ref_backend, kw)
    draws = _uniform(CORR_STEPS, Xt.shape[0], kappa=CORR_KAPPA)
    cfg = FWConfig(backend=backend, **kw)
    obj_scale = _obj_scale(oracle_name, y)
    full, splits = _step_by_step(oracle, design, y, cfg, trace, draws, delta, obj_scale)
    res, steps, tie = _free_run(oracle, design, y, cfg, draws)
    end, outcome = _check_run(oracle, design, y, res, steps, tie, trace, delta, obj_scale, rule)
    print(f"{rule}/{backend}/{oracle_name}: {full} of {len(trace.objective)} steps in full "
          f"from the reference's states ({len(splits)} near-tie splits); the whole run "
          f"{outcome}, {end} steps compared")
    # the runs whose 60 steps make no near-tie on this design hold every fact
    # exactly; pairwise balances its two atoms at its first pair step (step
    # 2), and the logistic's away and lazy runs meet their first near-tie
    # past MIN_RUN_STEPS
    if rule == "pairwise":
        assert end >= 2, outcome
    elif oracle_name == "logistic" and rule != "partan":
        assert end >= MIN_RUN_STEPS, outcome
    else:
        assert outcome == "exact", outcome


def test_away_drop_at_the_clip_leaves_the_recursions_behind(prob):
    """ROADMAP.md R5, in both packages on the same inputs. From alpha =
    -150 e_70 a full FW step makes alpha one atom, 150 e_272; the next step
    goes away from it with w_a = 1, so g_max = w_a / (1 - w_a) is clipped
    to 1e3 and the direction (1 + g) alpha - g delta e_272 is zero. The
    line search takes g = 1e3 = g_max, a drop step, which sets the away
    coordinate to exactly 0: alpha becomes 0, while the S/F recursions
    follow the direction and keep S near its old 22,500, where the exact S
    of alpha = 0 is 0. The port's step does the same: its decisions the
    reference's, S at the step's amplified rounding of the reference's."""
    Xt, y = prob
    p = Xt.shape[0]
    a0 = np.zeros(p, np.float32)
    a0[70] = -150.0
    kw = _kw("away", 150.0, tol=0.0, patience=10**9)
    trace = _ref_trace(REF_LASSO, jnp.asarray(Xt), y, "xla", kw, alpha0=a0, n_steps=2)
    after = trace.states[2]
    assert trace.lam[1] == 1e3 and int(trace.i_star[1]) == 272
    assert not np.any(after["alpha"]) and float(after["co.s_quad"]) > 2e4
    cfg = FWConfig(backend="torch", **kw)
    full, splits = _step_by_step(LASSO, torch.from_numpy(Xt), y, cfg, trace, _uniform(2, p),
                                 150.0, _obj_scale("lasso", y))
    assert (full, splits) == (2, [])
    state = convert.state_from_reference(trace.states[1], "cpu")
    Xp, yp = torch.from_numpy(Xt), torch.from_numpy(y)
    state = engine.rule_step(LASSO, Xp, yp, engine.precompute_colstats(Xp, yp, cfg), state, cfg,
                             torch.tensor(150.0),
                             convert.stream_from_reference(_uniform(2, p)[1:], "cpu"))
    assert not torch.any(state.scale * state.beta) and float(state.co.s_quad) > 2e4


@pytest.mark.parametrize("rule", RULES)
def test_rule_history_matches_reference(prob, rule):
    """``solve_with_history`` under each rule: the objective after each of
    its fixed steps against the reference's history (rtol 1e-6 of the
    objective's scale 0.5 y^T y) up to the steps where the lasso path stays
    exact (40 steps, before this geometry's first near-tie of any rule)."""
    Xt, y = prob
    n = 40
    kw = _kw(rule, DELTA)
    cfg = RefConfig(backend="xla", **kw)
    with jax.threefry_partitionable(False):
        ref, ref_hist = ref_engine.solve_with_history(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y),
                                                      cfg, jax.random.PRNGKey(SEED), n)
    res, hist = engine.solve_with_history(
        LASSO, torch.from_numpy(Xt), torch.from_numpy(y), FWConfig(backend="torch", **kw),
        convert.stream_from_reference(_uniform(n, Xt.shape[0]), "cpu"), n, device="cpu")
    assert hist.shape == (n,) and res.iterations == int(ref.iterations) == n
    assert res.n_dots == int(ref.n_dots)
    scale = 0.5 * float(np.dot(y, y))
    np.testing.assert_allclose(hist.numpy(), np.asarray(ref_hist), rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("rule", RULES)
def test_rule_continues_a_reference_state(prob, rule):
    """A mid-run reference state (its rule state included) carried into the
    port by ``convert.state_from_reference`` and stepped on: each of the
    next steps against the reference's own continuation, decisions equal up
    to the port's first near-tie and alpha and the objective at the
    tolerances of the module docstring before it; then each of those steps
    from the reference's state, as ``test_rule_solve_matches_reference``
    takes them."""
    Xt, y = prob
    p = Xt.shape[0]
    n0, n1 = 6, 12
    kw = _kw(rule, DELTA, tol=0.0, patience=10**9)
    trace = _ref_trace(REF_LASSO, jnp.asarray(Xt), y, "xla", kw, n_steps=n0 + n1)
    draws = _uniform(n0 + n1, p)
    cfg = FWConfig(backend="torch", **kw)
    # the config carries across with its rule and the rules' capacities
    ref_cfg = RefConfig(backend="xla", **kw)
    assert convert.config_from_reference(dataclasses.asdict(ref_cfg)) == cfg
    state = convert.state_from_reference(trace.states[n0], "cpu")
    assert state.k == n0 and state.rule != ()
    Xp, yp = torch.from_numpy(Xt), torch.from_numpy(y)
    pstats = engine.precompute_colstats(Xp, yp, cfg)
    sampler = convert.stream_from_reference(draws[n0:], "cpu")
    probe = _probe(Xp)
    sampler = probe.sampler(sampler)
    steps = []
    with probe:
        for _ in range(n1):
            state = engine.rule_step(LASSO, Xp, yp, pstats, state, cfg, torch.tensor(DELTA),
                                     sampler)
            steps.append(Step.of(LASSO, yp, pstats, state))
            probe.on_step(0, state)
    assert state.k == n0 + n1
    tie = probe.first.get(0)
    obj_scale = _obj_scale("lasso", y)
    compared = 0
    for j, got in enumerate(steps):
        if tie is not None and j >= tie[0]:
            break
        want = _ref_step(trace, n0 + j, rule)
        assert got.decisions() == want.decisions(), f"continued step {j}"
        bad = _values_close(got, want, DELTA, obj_scale)
        assert not bad, f"continued step {j}: {', '.join(bad)}"
        compared += 1
    sub = trace._replace(states=trace.states[n0:], objective=trace.objective[n0:],
                         i_star=trace.i_star[n0:])
    full, splits = _step_by_step(LASSO, Xp, y, cfg, sub, draws[n0:], DELTA, obj_scale)
    print(f"{rule}: {compared} continued steps before a near-tie ({tie}); {full} of {n1} "
          f"in full from the reference's states")


@pytest.mark.parametrize("rule", RULES)
def test_rule_path_matches_reference(prob, rule):
    """``fw_path`` carries the rule: 3 warm-started points on 'torch'. Each
    point of the reference path is rerun as a trace (its key, its rescaled
    warm start and delta, the path's own step sequence): its iterations and
    objective the path's. Every step of every point is taken by the port
    from the reference's state; the port's path then has each point's
    vertex sequence the reference's up to its first near-tie there, as long
    as no earlier point had one (a split point hands the next another warm
    start), and every point's objective within the larger certified gap of
    the two runs."""
    Xt, y = prob
    deltas = ref_path.delta_grid(150.0, n_points=3)
    kw = _kw(rule, 1.0, max_iters=200)
    ref_cfg = RefConfig(backend="xla", **kw)
    X, Y = jnp.asarray(Xt), jnp.asarray(y)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path(X, Y, deltas, ref_cfg, seed=SEED)
        streams, traces, key, alpha = [], [], jax.random.PRNGKey(SEED), None
        for g, d in enumerate(deltas):
            if alpha is not None:
                alpha = alpha * (float(d) / float(jnp.sum(jnp.abs(alpha))))
            key, sub = jax.random.split(key)
            streams.append(_uniform(200, Xt.shape[0], sub))
            tr = _ref_trace(REF_LASSO, X, y, "xla", kw, key=sub, alpha0=alpha, delta=float(d))
            assert len(tr.objective) == ref.points[g].iterations
            np.testing.assert_allclose(tr.objective[-1], ref.points[g].objective, rtol=1e-6)
            traces.append(tr)
            alpha = jnp.asarray(tr.alpha)
    cfg = FWConfig(backend="torch", **kw)
    forced = [_step_by_step(LASSO, torch.from_numpy(Xt), y, cfg, tr, streams[g], float(deltas[g]),
                            _obj_scale("lasso", y))[0] for g, tr in enumerate(traces)]
    rings = [tr.i_star for tr in traces]
    probe = _probe(torch.from_numpy(Xt))
    seqs = [[] for _ in deltas]

    def on_step(g, state):
        seqs[g].append(int(state.i_star))
        probe.on_step(g, state)

    with probe:
        res = path.fw_path(
            Xt, y, deltas, FWConfig(backend="torch", **kw), device="cpu",
            sampler_fn=lambda g: probe.sampler(convert.stream_from_reference(streams[g], "cpu")),
            on_step=on_step)
    assert len(res.points) == 3
    Xp, yp = torch.from_numpy(Xt), torch.from_numpy(y)
    same_start, compared = True, []
    for g, (got, want) in enumerate(zip(res.points, ref.points)):
        assert got.l1 <= got.reg * (1 + 1e-4) and np.isfinite(got.objective)
        tie = probe.first.get(g)
        if same_start:
            seq, ring = np.asarray(seqs[g]), rings[g]
            end = min(len(seq), len(ring), tie[0] if tie else len(seq))
            np.testing.assert_array_equal(seq[:end], ring[:end])
            compared.append(end)
            if tie is None:
                np.testing.assert_array_equal(seq, ring)
                assert (got.iterations, got.n_dots, got.active) == (
                    want.iterations, want.n_dots, want.active)
                np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
                continue
            same_start = False
        d = torch.tensor(float(deltas[g]))
        gaps = [float(LASSO.gap(Xp, yp, a.to(torch.float32), d)) for a in (
            _point_alpha(got, Xt.shape[0]), _point_alpha(want, Xt.shape[0]))]
        assert abs(got.objective - want.objective) <= max(max(gaps), 1e-6 * max(
            abs(want.objective), _obj_scale("lasso", y))), (g, got.objective, want.objective, gaps)
    assert compared and compared[0] >= 1
    print(f"{rule}: steps of each point's vertex sequence compared {compared}; steps in full "
          f"from the reference's states {forced} of {[len(tr.objective) for tr in traces]}")


def _point_alpha(pt, p):
    alpha = torch.zeros(p, dtype=torch.float64)
    alpha[torch.as_tensor(np.asarray(pt.alpha_nnz_idx), dtype=torch.int64)] = torch.as_tensor(
        np.asarray(pt.alpha_nnz_val), dtype=torch.float64)
    return alpha


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("backend", ["kernels", "sparse"])
@pytest.mark.parametrize("oracle_name", ["lasso", "en"])
def test_tail_shadow_replays_every_direction_step(corr, backend, oracle_name):
    """``chip_smoke.TailShadow``, which phase 3 and phase 4 wrap around the
    kernels' route on the card, replays each direction tail of a run
    through ``dir_tail_plain`` from the same inputs. On the CPU the
    wrapper's route is that plain version itself, so every step agrees
    exactly, and the run is the one without the shadow, bit for bit."""
    cs = _chip_smoke()
    Xt, y, _ = _problem(corr, oracle_name)
    _, design = _designs(Xt, "sparse" if backend == "sparse" else "kernels")
    oracle = _oracles(oracle_name)[1]
    cfg = FWConfig(backend=backend, **_kw("away", 40.0, kappa=CORR_KAPPA, max_iters=80))
    draws = _uniform(80, Xt.shape[0], kappa=CORR_KAPPA)
    yt = torch.from_numpy(y)
    with cs.TailShadow(torch, design) as shadow:
        res = engine.solve(oracle, design, yt, cfg, convert.stream_from_reference(draws, "cpu"),
                           device="cpu")
    plain = engine.solve(oracle, design, yt, cfg, convert.stream_from_reference(draws, "cpu"),
                         device="cpu")
    assert shadow.steps == res.iterations and shadow.splits == 0 and shadow.worst == 0.0
    assert torch.equal(res.alpha, plain.alpha) and res.iterations == plain.iterations


@pytest.mark.parametrize("fault", ["s_quad", "resid", "buf"])
def test_tail_shadow_catches_a_wrong_tail(corr, fault):
    """A direction tail off its plain version (S by one part in 1e4, the
    residual by one part in 1e4 at one row, or a buffer that loses its new
    atom) fails the shadow's check at the step it first shows."""
    cs = _chip_smoke()
    Xt, y, _ = _problem(corr, "lasso")
    design = torch.from_numpy(Xt)
    cfg = FWConfig(backend="kernels", **_kw("away", 40.0, kappa=CORR_KAPPA, max_iters=40))
    draws = _uniform(40, Xt.shape[0], kappa=CORR_KAPPA)

    def wrong(*args, **kw):
        out = right(*args, **kw)
        if fault == "s_quad":
            return out._replace(s_quad=out.s_quad * (1 + 1e-4))
        if fault == "resid":
            resid = out.resid.clone()
            resid[7] += 1e-4 * float(resid.abs().max())
            return out._replace(resid=resid)
        return out._replace(buf=torch.where(out.buf == out.i_star, -1, out.buf))

    from repro_torch.core import vertex

    right = vertex.dir_tail
    with cs.TailShadow(torch, design, tail=wrong):
        with pytest.raises(cs.CheckFailed, match=r"\[shadow\]"):
            engine.solve(LASSO, design, torch.from_numpy(y), cfg,
                         convert.stream_from_reference(draws, "cpu"), device="cpu")
    assert vertex.dir_tail is right
