"""The port's solver (``repro_torch.core``) against the JAX reference on the
CPU, in one process, on the ``small_problem`` geometry of
``tests/test_engine.py``.

Both packages get the same numpy problem and the same sampled index
stream: the reference's own, drawn inside ``jax.threefry_partitionable(False)``
(the mode its goldens were pinned under, ROADMAP.md Queue 3 R1) and
replayed into the port through ``convert.stream_from_reference``.

Tolerances, and why:
  * integer facts (iterations, n_dots, support, convergence) are exact:
    the stream, the argmax and the stopping rule determine them;
  * the per-step vertex sequence is exact up to the first step where the
    two disagree, and that step must be a near-tie: two distinct sampled
    coordinates whose |scores| lie within RTOL_TIE * ||r||. The packages
    sum the m products of a score in different orders (torch's CPU matvec
    vs XLA's), so ulp-level differences may flip such a tie;
  * objectives and gaps at rtol 1e-6, the tolerance the reference's goldens
    use for BLAS-order differences.
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
from repro.core import vertex as ref_vertex
from repro.obs import TelemetrySpec, ring_to_records

from repro_torch import convert
from repro_torch.core import FWConfig, LASSO, TorchSampler, engine, fw_solve
from repro_torch.kernels import launch_counts

DELTA, KAPPA, SEED = 150.0, 60, 42
RTOL_OBJ = 1e-6
RTOL_TIE = 1e-4
PAIRS = [("torch", "xla"), ("kernels", "pallas")]


def _draw_stream(n_steps, draw_fn):
    """The reference engine's stream: key, sub = split(key); draw(sub)."""
    with jax.threefry_partitionable(False):
        def body(key, _):
            key, sub = jax.random.split(key)
            return key, draw_fn(sub)

        _, draws = jax.lax.scan(body, jax.random.PRNGKey(SEED), None, length=n_steps)
    return np.asarray(draws)


def _ref_run(Xt, y, backend, alpha0=None, **kw):
    """Reference solve with a telemetry ring holding every step's vertex."""
    cfg = RefConfig(delta=DELTA, kappa=KAPPA, backend=backend,
                    telemetry=TelemetrySpec(capacity=kw.get("max_iters", 300)), **kw)
    with jax.threefry_partitionable(False):
        res = ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y), cfg,
                               jax.random.PRNGKey(SEED),
                               None if alpha0 is None else jnp.asarray(alpha0))
    return res, np.asarray(ring_to_records(res.telemetry)["i_star"])


def _port_run(Xt, y, backend, draws, alpha0=None, **kw):
    """Port solve on the CPU replaying ``draws``; returns the result, the
    vertex sequence and each step's pre-step residual."""
    X, yt = convert.problem_from_numpy(Xt, y, "cpu")
    cfg = FWConfig(delta=DELTA, kappa=KAPPA, backend=backend, **kw)
    seq, resid = [], [yt if alpha0 is None else yt - torch.as_tensor(alpha0) @ X]
    sampler = None if draws is None else convert.stream_from_reference(draws, "cpu")

    def on_step(state):
        seq.append(int(state.i_star))
        resid.append(state.co.resid)

    res = fw_solve(X, yt, cfg, sampler, None if alpha0 is None else torch.as_tensor(alpha0),
                   device="cpu", on_step=on_step)
    return res, np.asarray(seq), resid


def _assert_same_until_near_tie(Xt, seq, ref_seq, resid, idx_at):
    """Vertex sequences agree up to their first difference, which must be a
    near-tie on the port's pre-step residual. Returns that step (or None)."""
    n = min(len(seq), len(ref_seq))
    diff = np.nonzero(seq[:n] != ref_seq[:n])[0]
    if diff.size == 0:
        return None
    t = int(diff[0])
    idx = np.unique(idx_at(t))
    r = resid[t].numpy().astype(np.float64)
    mags = np.sort(np.abs(Xt[idx].astype(np.float64) @ r))[::-1]
    margin = mags[0] - mags[1]
    assert margin <= RTOL_TIE * np.linalg.norm(r), (
        f"vertex {seq[t]} vs reference {ref_seq[t]} at step {t} is no near-tie "
        f"(margin {margin:.3e}, ||r|| {np.linalg.norm(r):.3e})"
    )
    return t


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    return np.ascontiguousarray(ds.X.T), ds.y


@pytest.fixture(scope="module")
def uniform_stream(prob):
    p = prob[0].shape[0]
    return _draw_stream(300, lambda k: jax.random.randint(k, (KAPPA,), 0, p))


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_converging_run_reproduces_the_golden(prob, uniform_stream, backend, ref_backend):
    Xt, y = prob
    kw = dict(max_iters=5000, tol=1e-4)
    ref, ref_seq = _ref_run(Xt, y, ref_backend, **kw)
    res, seq, _ = _port_run(Xt, y, backend, uniform_stream, **kw)
    assert (int(ref.iterations), int(ref.n_dots)) == (25, 1500)  # the R1 premise
    assert (res.iterations, res.n_dots, bool(res.converged)) == (25, 1500, True)
    np.testing.assert_array_equal(seq, ref_seq)  # the whole sequence: no near-tie
    np.testing.assert_allclose(float(res.objective), 751729.4375, rtol=RTOL_OBJ)
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=RTOL_OBJ)


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_fixed_run_reproduces_the_golden(prob, uniform_stream, backend, ref_backend):
    Xt, y = prob
    kw = dict(max_iters=300, tol=0.0, patience=10**9)
    ref, ref_seq = _ref_run(Xt, y, ref_backend, **kw)
    res, seq, resid = _port_run(Xt, y, backend, uniform_stream, **kw)
    assert (res.iterations, res.n_dots) == (300, 18000)
    assert np.nonzero(res.alpha.numpy())[0].tolist() == [70, 272]
    np.testing.assert_allclose(float(res.objective), 751729.4375, rtol=RTOL_OBJ)
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=RTOL_OBJ)
    t = _assert_same_until_near_tie(Xt, seq, ref_seq, resid, lambda t: uniform_stream[t])
    # past convergence the two active coordinates' scores near-tie; before
    # it (25 steps, the converging run) the sequences must be identical
    assert t is None or t > 25


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_full_sampling_needs_no_stream(prob, backend, ref_backend):
    Xt, y = prob
    kw = dict(sampling="full", max_iters=60, tol=1e-4)
    ref, ref_seq = _ref_run(Xt, y, ref_backend, **kw)
    res, seq, resid = _port_run(Xt, y, backend, None, **kw)
    assert (res.iterations, res.n_dots) == (int(ref.iterations), int(ref.n_dots))
    assert bool(res.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=RTOL_OBJ)
    _assert_same_until_near_tie(Xt, seq, ref_seq, resid, lambda t: np.arange(Xt.shape[0]))


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_block_sampling_with_a_tail_block(prob, backend, ref_backend):
    """p = 300 over 128-wide blocks: the third block has 84 rows past p,
    which 'xla'/'torch' wrap modulo p and 'pallas'/'kernels' mask."""
    Xt, y = prob
    p = Xt.shape[0]
    kw = dict(sampling="block", block_size=128, max_iters=80, tol=0.0, patience=10**9)
    ref_cfg = RefConfig(delta=DELTA, kappa=256, **kw)
    starts = _draw_stream(80, lambda k: ref_vertex.sample_block_starts(k, p, ref_cfg))
    assert starts.shape == (80, 2) and (starts == 2).any()  # the tail block is drawn
    cfg = RefConfig(delta=DELTA, kappa=256, backend=ref_backend, **kw)
    with jax.threefry_partitionable(False):
        ref = ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y), cfg,
                               jax.random.PRNGKey(SEED))
    X, yt = convert.problem_from_numpy(Xt, y, "cpu")
    res = fw_solve(X, yt, convert.config_from_reference(dataclasses.asdict(cfg)),
                   convert.stream_from_reference(starts, "cpu"), device="cpu")
    assert (res.iterations, res.n_dots) == (80, 80 * 256)
    assert int(res.active) == int(ref.active)
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=RTOL_OBJ)


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_warm_start_from_alpha0(prob, uniform_stream, backend, ref_backend):
    Xt, y = prob
    alpha0 = np.zeros(Xt.shape[0], np.float32)
    alpha0[[70, 272]] = [60.0, 40.0]  # l1 = 100 < delta
    kw = dict(max_iters=5000, tol=1e-4)
    ref, ref_seq = _ref_run(Xt, y, ref_backend, alpha0=alpha0, **kw)
    res, seq, resid = _port_run(Xt, y, backend, uniform_stream, alpha0=alpha0, **kw)
    assert (res.iterations, res.n_dots) == (int(ref.iterations), int(ref.n_dots))
    np.testing.assert_allclose(float(res.objective), float(ref.objective), rtol=RTOL_OBJ)
    _assert_same_until_near_tie(Xt, seq, ref_seq, resid, lambda t: uniform_stream[t])


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_mid_run_state_carries_across(prob, uniform_stream, backend):
    """Run the reference 40 steps, carry its state over with
    ``state_from_reference``, and let both finish the next 60."""
    Xt, y = prob
    Xj, yj = jnp.asarray(Xt), jnp.asarray(y)
    cfg = RefConfig(delta=DELTA, kappa=KAPPA, max_iters=40, tol=0.0, patience=10**9)
    delta = jnp.asarray(DELTA)
    with jax.threefry_partitionable(False):
        stats = ref_engine.precompute_colstats(Xj, yj, cfg)
        s0 = ref_engine.init_state(REF_LASSO, Xj, yj, jax.random.PRNGKey(SEED), None, cfg)
        s40 = ref_engine.run_loop(REF_LASSO, Xj, yj, stats, s0, cfg, delta, 10**9)
        cfg100 = dataclasses.replace(cfg, max_iters=100)
        s100 = ref_engine.run_loop(REF_LASSO, Xj, yj, stats, s40, cfg100, delta, 10**9)
    arrays = {"beta": s40.beta, "scale": s40.scale, "co.resid": s40.co.resid,
              "co.s_quad": s40.co.s_quad, "co.f_lin": s40.co.f_lin,
              "maxabs": s40.maxabs, "step_inf": s40.step_inf, "stall": s40.stall,
              "n_dots": s40.n_dots, "k": s40.k}
    state = convert.state_from_reference({k: np.asarray(v) for k, v in arrays.items()}, "cpu")
    assert (state.k, state.n_dots) == (40, 40 * KAPPA)
    X, yt = convert.problem_from_numpy(Xt, y, "cpu")
    pcfg = convert.config_from_reference(dataclasses.asdict(cfg100))
    pcfg = dataclasses.replace(pcfg, backend=backend)
    pstats = engine.precompute_colstats(X, yt, pcfg)
    final = engine.run_loop(LASSO, X, yt, pstats, state, pcfg, torch.tensor(DELTA), 10**9,
                            convert.stream_from_reference(uniform_stream[40:], "cpu"))
    assert (final.k, final.n_dots) == (100, 100 * KAPPA)
    np.testing.assert_allclose(float(LASSO.objective(yt, pstats, final.co)),
                               float(REF_LASSO.objective(yj, stats, s100.co)), rtol=RTOL_OBJ)
    np.testing.assert_array_equal(np.nonzero((final.scale * final.beta).numpy())[0],
                                  np.nonzero(np.asarray(s100.scale * s100.beta))[0])


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_report_gap_matches_certified_gap(prob, uniform_stream, backend, ref_backend):
    Xt, y = prob
    kw = dict(max_iters=5000, tol=1e-4, report_gap=True)
    cfg = RefConfig(delta=DELTA, kappa=KAPPA, backend=ref_backend, **kw)
    with jax.threefry_partitionable(False):
        ref = ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y), cfg,
                               jax.random.PRNGKey(SEED))
    res, _, _ = _port_run(Xt, y, backend, uniform_stream, **kw)
    # the reference's certified_gap at the port's iterate, and the
    # reference's own solve (same trajectory, see the converging run)
    alpha = jnp.asarray(res.alpha.numpy())
    co = REF_LASSO.init_co(jnp.asarray(y), alpha @ jnp.asarray(Xt), alpha, alpha.dtype)
    want = ref_engine.certified_gap(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y), co, alpha,
                                    jnp.ones(()), DELTA)
    # the gap is alpha^T grad + delta*||grad||_inf, a small difference of two
    # large f32 terms: compare it to 1e-6 of the terms' scale
    a64 = res.alpha.numpy().astype(np.float64)
    grad = -(Xt.astype(np.float64) @ (y - a64 @ Xt))
    scale = abs(a64 @ grad) + DELTA * np.abs(grad).max()
    assert res.gap is not None
    assert abs(float(res.gap) - float(want)) <= 1e-6 * scale
    assert abs(float(res.gap) - float(ref.gap)) <= 1e-6 * scale


def test_cpu_runs_take_the_plain_versions(prob, uniform_stream):
    """On CPU tensors the 'kernels' backend runs the plain versions (no
    launch) and replays the 'torch' backend exactly."""
    Xt, y = prob
    before = launch_counts()
    kw = dict(max_iters=300, tol=0.0, patience=10**9)
    a, seq_a, _ = _port_run(Xt, y, "kernels", uniform_stream, **kw)
    b, seq_b, _ = _port_run(Xt, y, "torch", uniform_stream, **kw)
    assert launch_counts() == before
    np.testing.assert_array_equal(seq_a, seq_b)
    assert torch.equal(a.alpha, b.alpha) and float(a.objective) == float(b.objective)


def test_nonfinite_inputs_raise(prob):
    Xt, y = prob
    X = Xt.copy()
    X[3, 4] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        fw_solve(X, y, FWConfig(delta=DELTA), None, device="cpu")


def test_n_dots_stays_exact_past_2_24():
    """ROADMAP.md Queue 3 R3: without x64 the reference counts dots in
    float32, exact only up to 2^24 (393 steps of the paper size's kappa);
    the port counts in host integers. 241 steps that each score one block
    of 70,001 rows cross 2^24 on an odd total."""
    rng = np.random.default_rng(0)
    Xt = rng.standard_normal((2 * 70_001, 2)).astype(np.float32)
    y = rng.standard_normal(2).astype(np.float32)
    kw = dict(delta=DELTA, kappa=70_001, sampling="block", block_size=70_001,
              max_iters=241, tol=0.0, patience=10**9)
    ref = ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y), RefConfig(**kw),
                           jax.random.PRNGKey(SEED))
    res = fw_solve(Xt, y, FWConfig(backend="torch", **kw), TorchSampler(0, "cpu"), device="cpu")
    assert res.n_dots == 241 * 70_001 > 2**24
    assert int(ref.n_dots) != 241 * 70_001  # the reference's float32 counter rounded


def test_chip_smoke_golden_is_the_reference_stream(prob, uniform_stream):
    """chip_smoke.py replays the converging golden on the card from an
    embedded copy of the reference's stream and vertex sequence."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    np.testing.assert_array_equal(smoke.golden_stream(), uniform_stream[:25])
    ref, ref_seq = _ref_run(*prob, "xla", max_iters=5000, tol=1e-4)
    assert smoke.GOLDEN_I_STAR == ref_seq.tolist()
    assert smoke.GOLDEN_OBJECTIVE == float(ref.objective)
