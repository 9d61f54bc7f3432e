"""The port's history solve (``fw_solve_with_history``,
``engine.solve_with_history``) and the flat lasso surface (``FWState``,
``init_state``, ``fw_step``, ``objective``, ``duality_gap``) against the JAX
reference on the CPU, and the paper's convergence guarantee on the port.

The reference draws its stream from ``jax.random`` inside
``jax.threefry_partitionable(False)`` (ROADMAP.md Queue 3 R1), and the port
replays it (``convert.stream_from_reference``). Histories have the same
length and agree to rtol 1e-6, the reference goldens' tolerance for
summation-order differences. The O(1/k) rate tests
(tests/test_convergence.py, Propositions 1/2) run on the port's own
samplers, with f* from the reference's FISTA in the same process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FISTAConfig, baselines
from repro.core import FWConfig as RefConfig
from repro.core import fw_lasso as ref_lasso
from repro.core import engine as ref_engine

from repro_torch import convert
from repro_torch.core import (LASSO, FWConfig, FWState, TorchSampler, duality_gap, engine,
                              fw_lasso, fw_solve_with_history, fw_step, history_patience,
                              init_state, objective, precompute_colstats)

DELTA, SEED = 150.0, 42
PAIRS = [("torch", "xla"), ("kernels", "pallas")]


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    return np.ascontiguousarray(ds.X.T), ds.y


def _stream(n_steps, kappa, p):
    """The reference engine's stream: key, sub = split(key); randint(sub)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (kappa,), 0, p)

        _, draws = jax.lax.scan(body, jax.random.PRNGKey(SEED), None, length=n_steps)
    return np.asarray(draws)


def _ref_history(Xt, y, n_iters, **kw):
    with jax.threefry_partitionable(False):
        res, hist = ref_lasso.fw_solve_with_history(
            jnp.asarray(Xt), jnp.asarray(y), RefConfig(**kw), jax.random.PRNGKey(SEED),
            n_iters=n_iters)
    return res, np.asarray(hist)


def _assert_history(got, want, y):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("case", ["uniform", "full"])
@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_history_matches_reference(prob, backend, ref_backend, case, fuse):
    """tests/test_fw_lasso.py's history runs (uniform, kappa 64, 500 steps;
    full sampling, 200 steps), unfused and with fuse_steps=8: the same
    length, the same values, the same final state."""
    Xt, y = prob
    n_iters = 500 if case == "uniform" else 200
    kw = dict(delta=DELTA, sampling=case, kappa=64, max_iters=10**6, tol=0.0,
              patience=10**9, fuse_steps=fuse)
    ref, ref_hist = _ref_history(Xt, y, n_iters, backend=ref_backend, **kw)
    sampler = (convert.stream_from_reference(_stream(n_iters, 64, Xt.shape[0]), "cpu")
               if case == "uniform" else None)
    res, hist = fw_solve_with_history(Xt, y, FWConfig(backend=backend, **kw), sampler,
                                      n_iters, device="cpu")
    _assert_history(hist.numpy(), ref_hist, y)
    assert res.iterations == int(ref.iterations) == n_iters
    assert res.n_dots == int(ref.n_dots)
    assert int(res.active) == int(ref.active)
    assert bool(res.converged) == bool(ref.converged)
    assert res.effective_fuse_steps == int(ref.effective_fuse_steps)
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=1e-6)
    assert float(hist[-1]) == float(res.objective)


@pytest.mark.parametrize("fuse", [1, 8])
@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_history_is_the_solve_it_records(prob, backend, fuse):
    """The history is the objective after every step of the solve that a
    per-step hook sees, bit for bit; the run takes exactly n_iters steps
    (history_patience never stops it) and ``converged`` reads the config's
    own patience; with fuse_steps=8 the steps are the unfused solve's."""
    Xt, y = prob
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    n_iters = 150
    draws = _stream(n_iters, 60, Xt.shape[0])
    cfg = FWConfig(delta=5.0, kappa=60, max_iters=10, tol=1e-3, backend=backend,
                   fuse_steps=fuse)
    res, hist = engine.solve_with_history(LASSO, X, yt, cfg,
                                          convert.stream_from_reference(draws, "cpu"), n_iters,
                                          device="cpu")
    seen, stats = [], precompute_colstats(X, yt)
    plain = engine.solve(LASSO, X, yt, FWConfig(delta=5.0, kappa=60, max_iters=n_iters,
                                                  tol=1e-3, patience=history_patience(n_iters),
                                                  backend=backend),
                         convert.stream_from_reference(draws, "cpu"), device="cpu",
                         per_step=lambda s: seen.append(float(LASSO.objective(yt, stats, s.co))))
    assert hist.shape == (n_iters,) and res.iterations == n_iters == plain.iterations
    assert hist.tolist() == seen
    assert torch.equal(res.alpha, plain.alpha)
    assert bool(res.converged)  # a stall of 10^2 steps: past patience 20, short of n_iters + 1
    assert history_patience(n_iters) == n_iters + 1


def test_history_of_zero_steps(prob):
    Xt, y = prob
    res, hist = fw_solve_with_history(Xt, y, FWConfig(delta=DELTA, kappa=60), None, 0,
                                      device="cpu")
    assert hist.shape == (0,) and res.iterations == 0


def test_flat_api_matches_reference(prob):
    """init_state, fw_step, objective and duality_gap against the
    reference's, step by step on its stream, cold and warm-started."""
    Xt, y = prob
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    cfg = FWConfig(delta=DELTA, kappa=60)
    ref_cfg = RefConfig(delta=DELTA, kappa=60)
    stats = precompute_colstats(X, yt)
    ref_stats = ref_engine.precompute_colstats(jnp.asarray(Xt), jnp.asarray(y))
    draws = _stream(40, 60, Xt.shape[0])
    for alpha0 in (None, np.linspace(-0.3, 0.3, Xt.shape[0]).astype(np.float32)):
        with jax.threefry_partitionable(False):
            ref_state = ref_lasso.init_state(jnp.asarray(Xt), jnp.asarray(y),
                                             jax.random.PRNGKey(SEED),
                                             None if alpha0 is None else jnp.asarray(alpha0))
        state = init_state(X, yt, None if alpha0 is None else torch.from_numpy(alpha0))
        assert isinstance(state, FWState) and not hasattr(state, "key")
        np.testing.assert_allclose(state.resid.numpy(), np.asarray(ref_state.resid),
                                   rtol=1e-5, atol=1e-5)
        sampler = convert.stream_from_reference(draws, "cpu")
        for t in range(40):
            with jax.threefry_partitionable(False):
                ref_state = ref_lasso.fw_step(jnp.asarray(Xt), jnp.asarray(y), ref_stats,
                                              ref_state, ref_cfg)
            state = fw_step(X, yt, stats, state, cfg, sampler)
            assert (state.k, state.n_dots) == (int(ref_state.k), int(ref_state.n_dots))
            assert int(state.stall) == int(ref_state.stall)
            np.testing.assert_allclose(float(objective(stats, state)),
                                       float(ref_lasso.objective(ref_stats, ref_state)),
                                       rtol=1e-6)
        alpha = (state.scale * state.beta).numpy()
        np.testing.assert_allclose(alpha, np.asarray(ref_state.scale * ref_state.beta),
                                   rtol=1e-5, atol=1e-6)
        gap = float(duality_gap(X, state, DELTA))
        ref_gap = float(ref_lasso.duality_gap(jnp.asarray(Xt), ref_state, DELTA))
        assert abs(gap - ref_gap) <= 1e-6 * DELTA * float(np.abs(Xt @ y).max())
        # the live residual's gap is the oracle's gap at the same alpha
        assert abs(gap - float(LASSO.gap(X, yt, state.scale * state.beta, DELTA))) <= (
            1e-6 * DELTA * float(np.abs(Xt @ y).max()))


def test_fw_step_takes_delta_and_the_flat_state_round_trips(prob):
    Xt, y = prob
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    stats = precompute_colstats(X, yt)
    draws = torch.from_numpy(_stream(1, 60, Xt.shape[0]))
    a = fw_step(X, yt, stats, init_state(X, yt), FWConfig(delta=1.0, kappa=60),
                convert.stream_from_reference(draws, "cpu"), delta=DELTA)
    b = fw_step(X, yt, stats, init_state(X, yt), FWConfig(delta=DELTA, kappa=60),
                convert.stream_from_reference(draws, "cpu"))
    assert torch.equal(a.beta, b.beta) and torch.equal(a.resid, b.resid)
    es = fw_lasso._to_engine(a)
    assert fw_lasso._from_engine(es) == a


# --------------------------------------------------------------------------
# the paper's convergence guarantee (tests/test_convergence.py, ported)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rate(prob):
    """f* at delta 100 from the reference's FISTA, and the curvature bound
    C_f <= (2 delta)^2 ||X||_2^2 / 2 (Jaggi 2013)."""
    Xt, y = prob
    delta = 100.0
    fista = baselines.fista_solve(
        jnp.asarray(Xt), jnp.asarray(y),
        FISTAConfig(delta=delta, constrained=True, max_iters=20000, tol=1e-12),
        jax.random.PRNGKey(0))
    cf = 0.5 * (2 * delta) ** 2 * float(np.linalg.norm(Xt, 2) ** 2)
    return delta, float(fista.objective), cf


def _rate_cfg(delta, sampling):
    return FWConfig(delta=delta, sampling=sampling, kappa=60, max_iters=10**6, tol=0.0,
                    patience=10**9)


def test_deterministic_rate(prob, rate):
    Xt, y = prob
    delta, fstar, cf = rate
    _, hist = fw_solve_with_history(Xt, y, _rate_cfg(delta, "full"), None, 400, device="cpu")
    h = hist.numpy().astype(np.float64) - fstar
    bound = 4 * cf / (np.arange(1, len(h) + 1) + 2)
    assert np.all(h[5:] <= bound[5:] + 1e-2), f"max violation {np.max(h[5:] - bound[5:])}"


def test_stochastic_rate_in_expectation(prob, rate):
    """The mean over 8 seeds approximates E[f(a_k)] - f* <= 4 C~_f/(k+2)."""
    Xt, y = prob
    delta, fstar, cf = rate
    hists = [fw_solve_with_history(Xt, y, _rate_cfg(delta, "uniform"), TorchSampler(seed, "cpu"),
                                   400, device="cpu")[1].numpy() for seed in range(8)]
    mean_h = np.mean(hists, axis=0).astype(np.float64) - fstar
    bound = 4 * cf / (np.arange(1, len(mean_h) + 1) + 2)
    assert np.all(mean_h[5:] <= bound[5:] + 1e-2)


def test_rate_is_sublinear_not_stalled(prob, rate):
    """h_k decreases about as 1/k: h_400 < h_100 and h_511 < h_10 / 4, or
    they are already at the floor."""
    Xt, y = prob
    delta, fstar, _ = rate
    _, hist = fw_solve_with_history(Xt, y, _rate_cfg(delta, "uniform"),
                                    TorchSampler(SEED, "cpu"), 512, device="cpu")
    floor = 1e-6 * float(0.5 * np.dot(y, y))
    h = np.maximum(hist.numpy().astype(np.float64) - fstar, floor)
    assert h[400] < h[100] or h[400] <= floor
    assert h[-1] < 0.25 * h[10] or h[-1] <= floor


def test_history_needs_a_card_by_default(prob):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    Xt, y = prob
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fw_solve_with_history(Xt, y, FWConfig(delta=DELTA), None, 5)
