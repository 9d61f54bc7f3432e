"""The port's observability (``repro_torch.obs``; the engine's telemetry
ring, the path drivers' spans and monitors) against the JAX reference on
the CPU, mirroring tests/test_obs.py's classes.

Both packages get the same numpy problem and the same index stream: the
reference draws it from ``jax.random`` inside
``jax.threefry_partitionable(False)`` (ROADMAP.md Queue 3 R1) and the port
replays it (``convert.stream_from_reference``, one stream a lane for the
batched engine). Ring parity (``ring_to_records`` dicts): the integer
fields and the record indices exactly, ``n_dots`` exactly against the
reference's float32 count (below 2^24 here, R3), the objective at rtol
1e-6; the sampled gap ``S - F + delta |g|`` is a small difference of terms
of the objective's size, so it agrees to 1e-6 of the largest objective
(its float32 cancellation floor), and lam and step_inf, which the gap's
numerator divides, to rtol 1e-6 plus that floor over the step's gap (a
step at the floor, its gap a rounding of zero, has its lam set by the
rounding in both packages). Unrecorded floats are NaN in both.

Against itself: telemetry on leaves every trajectory bit for bit the
telemetry-off one (backends, rules, oracles, the fused routes, lanes); the
kernel chunk's replayed records equal the unfused steps' on the facts the
chunk emits; a lane ring equals its lane's sequential ring.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ENOracle as RefEN
from repro.core import FWConfig as RefConfig
from repro.core import LOGISTIC as REF_LOGISTIC
from repro.core import engine as ref_engine
from repro.core import path as ref_path
from repro.core.fw_lasso import LASSO as REF_LASSO
from repro.obs import TelemetrySpec as RefSpec
from repro.obs import Tracer as RefTracer
from repro.obs import register_sink as ref_register_sink
from repro.obs import ring_to_records as ref_records
from repro.obs import unregister_sink as ref_unregister_sink
from repro.obs import use_tracer as ref_use_tracer
from repro.sparse.matrix import SparseBlockMatrix as RefMatrix

from repro_torch import convert
from repro_torch.core import LASSO, LOGISTIC, ENOracle, FWConfig, engine, path
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.obs import (
    EVENT_AWAY,
    EVENT_DROP,
    EVENT_FW,
    EVENT_LAZY_HIT,
    EVENT_PAIRWISE,
    EVENT_PARTAN,
    LaneProgressMonitor,
    StepMonitor,
    TelemetrySpec,
    Tracer,
    build_report,
    default_meta,
    get_tracer,
    register_sink,
    render_markdown,
    ring_to_records,
    unregister_sink,
    use_tracer,
    validate_chrome_trace,
    write_report,
)
from repro_torch.obs import telemetry as tel_lib
from repro_torch.utils.timing import Timer, timed

DELTA, SEED, KAPPA = 150.0, 42, 40
BACKENDS = [("torch", "xla"), ("kernels", "pallas"), ("sparse", "sparse")]
INT_FIELDS = ("k", "i_star", "event", "stall", "record_index")


def _base_kw(**kw):
    base = dict(delta=DELTA, kappa=KAPPA, sampling="uniform", max_iters=120, tol=0.0,
                patience=10**9)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    Xt = np.ascontiguousarray(ds.X.T)
    Xs = Xt.copy()
    Xs[np.abs(Xs) < 0.7] = 0.0  # tests/test_obs.py's sparse design
    return Xt, ds.y, RefMatrix.from_dense(Xs, block_size=64)


def _stream(n_steps, p, kappa=KAPPA, key=None):
    """The reference engine's stream: key, sub = split(key); randint(sub)."""
    with jax.threefry_partitionable(False):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.randint(sub, (kappa,), 0, p)

        key = jax.random.PRNGKey(SEED) if key is None else key
        _, draws = jax.lax.scan(body, key, None, length=n_steps)
    return np.asarray(draws)


def _path_streams(n_splits, width, n_steps, p=300):
    """The reference path drivers' streams from PRNGKey(0): per point
    (``width`` 1, ``split(key)``) or per lane chunk (``split(key, width +
    1)``), each lane's the scan of its key."""
    with jax.threefry_partitionable(False):
        key, out = jax.random.PRNGKey(0), []
        for _ in range(n_splits):
            key, *subs = jax.random.split(key, width + 1)
            out.append([_stream(n_steps, p, key=s) for s in subs])
    return out


def _designs(prob, backend):
    """(the reference's design, the port's) for a backend."""
    Xt, _, ref_mat = prob
    if backend != "sparse":
        return jnp.asarray(Xt), torch.from_numpy(Xt)
    return ref_mat, convert.sparse_from_reference(
        np.asarray(ref_mat.values), np.asarray(ref_mat.rows), ref_mat.p, ref_mat.m,
        ref_mat.block_size, ref_mat.nnz_max, "cpu")


def _ref_kw(ref_backend, kw):
    """The reference's Pallas kernels in interpret mode, as its own tests
    run them on the CPU ('sparse' with its kernels on)."""
    kw = dict(kw)
    if ref_backend in ("pallas", "sparse"):
        kw["interpret"] = True
    if ref_backend == "sparse":
        kw.setdefault("sparse_kernel", True)
    return kw


def _pair(prob, backend, ref_backend, oracle=("lasso",), labels=False, spec=None,
          ref_spec=None, **kw):
    """One solve in each package on the same stream: (reference result,
    port result)."""
    _, y, _ = prob
    ref_design, design = _designs(prob, backend)
    kw = _base_kw(**kw)
    yv = np.sign(y) + (y == 0) if labels else y
    ref_oracle, port_oracle = {"lasso": (REF_LASSO, LASSO), "logistic": (REF_LOGISTIC, LOGISTIC),
                               "en": (RefEN(l2=0.7), ENOracle(0.7))}[oracle[0]]
    with jax.threefry_partitionable(False):
        ref = ref_engine.solve(ref_oracle, ref_design, jnp.asarray(yv, jnp.float32),
                               RefConfig(backend=ref_backend, telemetry=ref_spec,
                                         **_ref_kw(ref_backend, kw)),
                               jax.random.PRNGKey(SEED))
    # a fused chunk draws its masked trailing steps too
    sampler = convert.stream_from_reference(_stream(kw["max_iters"] + 8, ref_design.shape[0]),
                                            "cpu")
    res = engine.solve(port_oracle, design, torch.from_numpy(np.asarray(yv, np.float32)),
                       FWConfig(backend=backend, telemetry=spec, **kw), sampler, device="cpu")
    return ref, res


def _assert_ring_parity(got, want):
    """``ring_to_records`` dicts of the port and the reference (see the
    module docstring for the tolerances)."""
    assert set(got) == set(want)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["n_dots"].dtype == np.int64 and np.all(want["n_dots"] < 2**24)
    np.testing.assert_array_equal(got["n_dots"], want["n_dots"].astype(np.int64))
    for f in ("lam", "gap", "objective", "step_inf"):
        assert got[f].dtype == np.float32
        np.testing.assert_array_equal(np.isnan(got[f]), np.isnan(want[f]), err_msg=f)
    live = ~np.isnan(want["objective"])
    if not live.any():
        return  # lam and step_inf: held by the same stream's run with the objective on
    np.testing.assert_allclose(got["objective"][live], want["objective"][live], rtol=1e-6)
    floor = 1e-6 * float(max(np.max(np.abs(want["objective"][live])),
                             np.max(np.abs(want["gap"][live]))))
    np.testing.assert_allclose(got["gap"][live], want["gap"][live], rtol=0, atol=floor)
    # lam = num / den with num the gap: held where the gap stands clear of its
    # floor, to rtol 1e-6 plus the floor's share of the gap
    clear = live & (np.abs(want["gap"]) > 1e3 * floor)
    rtol = 1e-6 + floor / np.abs(want["gap"][clear])
    for f in ("lam", "step_inf"):
        assert np.all(np.abs(got[f][clear] - want[f][clear])
                      <= rtol * np.abs(want[f][clear])), f


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def _port(prob, backend, spec=None, oracle=LASSO, y=None, **kw):
    _, yv, _ = prob
    _, design = _designs(prob, backend)
    kw = _base_kw(**kw)
    y = torch.from_numpy(yv if y is None else y)
    sampler = convert.stream_from_reference(_stream(kw["max_iters"] + 8, design.shape[0]), "cpu")
    return engine.solve(oracle, design, y, FWConfig(backend=backend, telemetry=spec, **kw),
                        sampler, device="cpu")


class TestTelemetryOffBitIdentity:
    """The ring is an observer: alpha, iterations, n_dots and the vertex
    sequence bit for bit with it on or off."""

    @pytest.mark.parametrize("backend", ["torch", "kernels", "sparse"])
    def test_backends_identical(self, prob, backend):
        seen = {}
        for name, spec in (("off", None), ("on", TelemetrySpec(capacity=64))):
            stars = []
            _, design = _designs(prob, backend)
            res = engine.solve(LASSO, design, torch.from_numpy(prob[1]),
                               FWConfig(backend=backend, telemetry=spec, **_base_kw()),
                               convert.stream_from_reference(_stream(120, 300), "cpu"),
                               device="cpu", on_step=lambda s: stars.append(int(s.i_star)))
            seen[name] = (res, stars)
        (off, s_off), (on, s_on) = seen["off"], seen["on"]
        assert _bits(off.alpha, on.alpha) and s_off == s_on
        assert (off.iterations, off.n_dots) == (on.iterations, on.n_dots)
        assert off.telemetry is None and on.telemetry is not None

    @pytest.mark.parametrize("rule", ["away", "pairwise", "partan", "lazy"])
    @pytest.mark.parametrize("backend", ["torch", "kernels"])
    def test_step_rules_identical(self, prob, rule, backend):
        off = _port(prob, backend, step_rule=rule)
        on = _port(prob, backend, TelemetrySpec(capacity=64), step_rule=rule)
        assert _bits(off.alpha, on.alpha)
        assert (off.iterations, off.n_dots) == (on.iterations, on.n_dots)

    @pytest.mark.parametrize("oracle", ["logistic", "elasticnet"])
    @pytest.mark.parametrize("backend", ["torch", "kernels", "sparse"])
    def test_family_identical(self, prob, oracle, backend):
        y = prob[1]
        yv = (np.sign(y) + (y == 0)).astype(np.float32) if oracle == "logistic" else y
        o = LOGISTIC if oracle == "logistic" else ENOracle(0.7)
        off = _port(prob, backend, None, o, yv, max_iters=60)
        on = _port(prob, backend, TelemetrySpec(capacity=64), o, yv, max_iters=60)
        assert _bits(off.alpha, on.alpha) and off.n_dots == on.n_dots

    @pytest.mark.parametrize("record_objective", [True, False])
    @pytest.mark.parametrize("oracle", ["lasso", "elasticnet"])
    @pytest.mark.parametrize("backend", ["kernels", "sparse"])
    def test_fused_solve_identical(self, prob, backend, oracle, record_objective):
        """With the objective off the fused chunk runs and its replay
        records; with it on a chunk runs as K unfused steps, which for the
        lasso are the fused chunk's bits, and for the elastic-net (whose
        chunk matches its unfused steps to rounding, by its alpha ledger)
        the bits of the same solve chunked through unfused steps (the
        ``per_step`` route), as the reference's ``record_objective``
        routing gives."""
        o = LASSO if oracle == "lasso" else ENOracle(0.7)
        off_kw = {}
        if oracle == "elasticnet" and record_objective:
            off_kw["per_step"] = lambda s: None
        _, yv, _ = prob
        _, design = _designs(prob, backend)
        off = engine.solve(o, design, torch.from_numpy(yv),
                           FWConfig(backend=backend, **_base_kw(fuse_steps=8)),
                           convert.stream_from_reference(_stream(128, 300), "cpu"),
                           device="cpu", **off_kw)
        on = _port(prob, backend, TelemetrySpec(capacity=64, record_objective=record_objective),
                   o, fuse_steps=8)
        assert _bits(off.alpha, on.alpha)
        assert (off.iterations, off.n_dots) == (on.iterations, on.n_dots)
        assert on.telemetry.cursor == on.iterations

    def test_bf16_identical(self, prob):
        Xt, y, _ = prob
        X, yt = torch.from_numpy(Xt).bfloat16(), torch.from_numpy(y).bfloat16()
        runs = [engine.solve(LASSO, X, yt, FWConfig(telemetry=spec, **_base_kw(max_iters=70)),
                             convert.stream_from_reference(_stream(70, 300), "cpu"),
                             device="cpu")
                for spec in (None, TelemetrySpec(capacity=128))]
        assert torch.equal(runs[0].alpha, runs[1].alpha)
        rec = ring_to_records(runs[1].telemetry)
        assert rec["lam"].dtype == np.float32 and not np.any(np.isnan(rec["objective"]))
        # the ring's objective is the oracle's bf16 objective, in f32
        assert rec["objective"][-1] == float(runs[1].objective)


class TestRingContents:
    @pytest.mark.parametrize("record_objective", [True, False])
    @pytest.mark.parametrize("backend,ref_backend", BACKENDS)
    def test_ring_matches_reference(self, prob, backend, ref_backend, record_objective):
        """The whole ring against the reference's on the same stream, a
        refresh step (k = 63) included; 120 records through a ring of 64,
        so it wrapped."""
        ref, res = _pair(prob, backend, ref_backend,
                         spec=TelemetrySpec(capacity=64, record_objective=record_objective),
                         ref_spec=RefSpec(capacity=64, record_objective=record_objective))
        assert res.telemetry.cursor == int(ref.telemetry.cursor) == 120
        _assert_ring_parity(ring_to_records(res.telemetry), ref_records(ref.telemetry))

    @pytest.mark.parametrize("oracle", ["en", "logistic"])
    def test_family_rings_match_reference(self, prob, oracle):
        ref, res = _pair(prob, "kernels" if oracle == "en" else "torch",
                         "pallas" if oracle == "en" else "xla", oracle=(oracle,),
                         labels=oracle == "logistic", spec=TelemetrySpec(capacity=128),
                         ref_spec=RefSpec(capacity=128), max_iters=80)
        _assert_ring_parity(ring_to_records(res.telemetry), ref_records(ref.telemetry))

    @pytest.mark.parametrize("backend", ["torch", "kernels", "sparse"])
    def test_refresh_step_records_the_refreshed_objective(self, prob, backend):
        """The tail records before the periodic refresh; the refresh step's
        record carries the refreshed co-state's objective, bit for bit the
        oracle's on the state after the step (the reference records after
        ``update_co``)."""
        Xt, y, _ = prob
        _, design = _designs(prob, backend)
        yt = torch.from_numpy(y)
        stats = engine.precompute_colstats(design, yt)
        seen = []
        res = engine.solve(LASSO, design, yt,
                           FWConfig(backend=backend, refresh_every=16,
                                    telemetry=TelemetrySpec(capacity=128), **_base_kw()),
                           convert.stream_from_reference(_stream(120, 300), "cpu"),
                           device="cpu",
                           on_step=lambda s: seen.append(float(LASSO.objective(yt, stats, s.co))))
        rec = ring_to_records(res.telemetry)
        assert rec["objective"].tolist() == seen
        assert float(rec["objective"][-1]) == float(res.objective)

    def test_ring_matches_history(self, prob):
        """The ring's objective column IS the solve_with_history curve."""
        Xt, y, _ = prob
        n = 100
        res_h, hist = engine.solve_with_history(
            LASSO, torch.from_numpy(Xt), torch.from_numpy(y), FWConfig(**_base_kw()),
            convert.stream_from_reference(_stream(n, 300), "cpu"), n, device="cpu")
        ring = _port(prob, "kernels", TelemetrySpec(capacity=n), max_iters=n).telemetry
        assert hist.shape == (n,)
        assert _bits(hist, ring.objective)
        assert _bits(res_h.telemetry.objective[:n], hist)

    def test_fused_history_matches_unfused(self, prob):
        _, y, _ = prob
        _, mat = _designs(prob, "sparse")
        hists = [engine.solve_with_history(
            LASSO, mat, torch.from_numpy(y), FWConfig(backend="sparse", fuse_steps=f,
                                                      **_base_kw()),
            convert.stream_from_reference(_stream(64, 300), "cpu"), 60, device="cpu")[1]
            for f in (1, 8)]
        assert _bits(*hists)

    def test_wrap_keeps_last_records(self, prob):
        ring = _port(prob, "kernels", TelemetrySpec(capacity=32), max_iters=100).telemetry
        assert ring.cursor == 100  # the true count survives the wrap
        rec = ring_to_records(ring)
        np.testing.assert_array_equal(rec["k"], np.arange(68, 100))
        np.testing.assert_array_equal(rec["record_index"], np.arange(68, 100))
        assert np.all(np.diff(rec["n_dots"]) > 0)  # cumulative

    @pytest.mark.parametrize("backend,ref_backend", [("kernels", "pallas"),
                                                     ("sparse", "sparse")])
    def test_kernel_chunk_records(self, prob, backend, ref_backend):
        """record_objective=False keeps the fused chunk; its replay's records
        equal the per-step run's on the facts the chunk emits, with NaN
        objective and gap, and the reference's fused ring."""
        spec = TelemetrySpec(capacity=64, record_objective=False)
        reset_launch_counts()
        fused = _port(prob, backend, spec, fuse_steps=8)
        assert launch_counts()["fused_replay_tel"] == 0  # the plain replay on the CPU
        ref_fused, _ = _pair(prob, backend, ref_backend, spec=spec,
                             ref_spec=RefSpec(capacity=64, record_objective=False), fuse_steps=8)
        unfused = _port(prob, backend, spec)
        a, b = ring_to_records(fused.telemetry), ring_to_records(unfused.telemetry)
        for f in ("k", "i_star", "lam", "n_dots", "event", "stall", "step_inf"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        assert np.all(np.isnan(a["objective"])) and np.all(np.isnan(a["gap"]))
        _assert_ring_parity(a, ref_records(ref_fused.telemetry))

    def test_kernel_chunk_masks_past_max_iters(self, prob):
        """A chunk's steps past max_iters write nothing: the cursor is the
        iteration count, not a multiple of K."""
        res = _port(prob, "kernels", TelemetrySpec(capacity=64, record_objective=False),
                    fuse_steps=8, max_iters=45)
        assert res.iterations == res.telemetry.cursor == 45
        np.testing.assert_array_equal(ring_to_records(res.telemetry)["k"], np.arange(45))

    def test_objective_gap_recorded(self, prob):
        res = _port(prob, "kernels", TelemetrySpec(capacity=200))
        rec = ring_to_records(res.telemetry)
        assert not np.any(np.isnan(rec["objective"])) and not np.any(np.isnan(rec["gap"]))
        assert rec["objective"][-1] == float(res.objective)

    def test_n_dots_is_exact_past_2_24(self, prob):
        """The ring counts dots in int64 (the reference's float32 count is
        exact only to 2^24, ROADMAP.md R3): full sampling scores all p
        coordinates a step, from a count already past 2^24."""
        Xt, y, _ = prob
        X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
        cfg = FWConfig(backend="kernels", sampling="full", telemetry=TelemetrySpec(capacity=8),
                       **{k: v for k, v in _base_kw(max_iters=5).items() if k != "sampling"})
        state = engine.init_state(LASSO, X, yt, None, cfg)._replace(n_dots=2**24 + 1)
        stats = engine.precompute_colstats(X, yt, cfg)
        delta = torch.tensor(DELTA)
        for _ in range(3):
            state = engine.step(LASSO, X, yt, stats, state, cfg, delta, None)
        rec = ring_to_records(state.tel)
        np.testing.assert_array_equal(rec["n_dots"], 2**24 + 1 + 300 * np.arange(1, 4))


def _lane_run(prob, backend, capacity, record_objective=True, fuse=1, **kw):
    """tests/test_obs.py's lanes (deltas 20, 80, 150 from zero, keys split
    from PRNGKey(0)) in both packages, and each lane's stream."""
    _, y, _ = prob
    ref_design, design = _designs(prob, backend)
    base = dict(delta=1.0, kappa=KAPPA, sampling="uniform", max_iters=400, tol=1e-3,
                patience=10, fuse_steps=fuse)
    base.update(kw)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    streams = [_stream(400, 300, key=k) for k in keys]
    ref_backend = dict(BACKENDS)[backend]
    with jax.threefry_partitionable(False):
        ref, _ = ref_engine.solve_batched(
            REF_LASSO, ref_design, jnp.asarray(y),
            RefConfig(backend=ref_backend, telemetry=RefSpec(capacity=capacity,
                                                             record_objective=record_objective),
                      **_ref_kw(ref_backend, base)),
            keys, jnp.zeros((3, 300), jnp.float32), jnp.asarray([20.0, 80.0, 150.0]))
    res, _ = engine.solve_batched(
        LASSO, design, torch.from_numpy(y),
        FWConfig(backend=backend, telemetry=TelemetrySpec(capacity=capacity,
                                                          record_objective=record_objective),
                 **base),
        convert.lane_streams_from_reference(streams, "cpu"), None, [20.0, 80.0, 150.0],
        device="cpu")
    return ref, res, streams, base


class TestLaneRings:
    @pytest.mark.parametrize("capacity", [400, 32])
    @pytest.mark.parametrize("backend", ["torch", "kernels", "sparse"])
    def test_lane_rings_match_reference(self, prob, backend, capacity):
        """One ring a lane: a frozen lane stops recording, so each lane's
        cursor is its iteration count and (capacity 400) the slots past it
        stay empty; wrapped (capacity 32), the last records of that lane.
        Each lane's ring against the reference's lane."""
        ref, res, _, _ = _lane_run(prob, backend, capacity)
        iters = res.iterations
        assert res.telemetry.cursor == iters == np.asarray(ref.iterations).tolist()
        if backend != "sparse":
            assert len(set(iters)) > 1  # the lanes froze apart
        for lane in range(3):
            ring = res.telemetry.lane(lane)
            it = iters[lane]
            rec = ring_to_records(ring)
            n = min(it, capacity)
            np.testing.assert_array_equal(rec["k"], np.arange(it - n, it))
            if capacity > it:
                assert torch.all(ring.k[it:] == -1)  # untouched slots
            want = ref_records(jax.tree_util.tree_map(lambda a: a[lane], ref.telemetry))
            _assert_ring_parity(rec, want)

    @pytest.mark.parametrize("record_objective", [True, False])
    @pytest.mark.parametrize("backend", ["kernels", "sparse"])
    def test_lane_ring_is_the_sequential_ring(self, prob, backend, record_objective):
        """Each lane's ring is bit for bit the sequential solve's on the
        lane's stream (the lane tail's records are the one-lane tail's)."""
        _, y, _ = prob
        _, design = _designs(prob, backend)
        _, res, streams, base = _lane_run(prob, backend, 64, record_objective)
        for lane, d in enumerate([20.0, 80.0, 150.0]):
            seq = engine.solve(LASSO, design, torch.from_numpy(y),
                               FWConfig(backend=backend, telemetry=TelemetrySpec(
                                   capacity=64, record_objective=record_objective),
                                   **dict(base, delta=d)),
                               convert.stream_from_reference(streams[lane], "cpu"),
                               device="cpu")
            assert seq.iterations == res.iterations[lane]
            assert torch.equal(seq.telemetry.buf, res.telemetry.buf[lane])
        assert res.telemetry.dev_cursor.tolist() == res.iterations

    def test_fused_lanes_freeze_mid_chunk_exact_cursor(self, prob):
        """fuse_steps=8 lanes stop on their own iteration: the cursor is each
        lane's iteration count."""
        ref, res, _, _ = _lane_run(prob, "sparse", 64, record_objective=False, fuse=8)
        assert res.telemetry.cursor == res.iterations == np.asarray(ref.iterations).tolist()
        for lane in range(3):
            rec = ring_to_records(res.telemetry.lane(lane))
            it = res.iterations[lane]
            n = min(it, 64)
            np.testing.assert_array_equal(rec["k"], np.arange(it - n, it))

    def test_logistic_and_en_lanes_record(self, prob):
        _, y, _ = prob
        X = torch.from_numpy(prob[0])
        labels = torch.from_numpy((np.sign(y) + (y == 0)).astype(np.float32))
        for oracle, yv in ((LOGISTIC, labels), (ENOracle(0.7), torch.from_numpy(y))):
            res, _ = engine.solve_batched(
                oracle, X, yv, FWConfig(delta=1.0, kappa=KAPPA, max_iters=60, tol=1e-3,
                                        patience=10, telemetry=TelemetrySpec(capacity=64)),
                convert.lane_streams_from_reference([_stream(60, 300)] * 2, "cpu"), None,
                [5.0, 20.0], device="cpu")
            for lane in range(2):
                rec = ring_to_records(res.telemetry.lane(lane))
                np.testing.assert_array_equal(rec["k"], np.arange(res.iterations[lane]))
                assert not np.any(np.isnan(rec["objective"]))
                np.testing.assert_allclose(rec["objective"][-1],
                                           float(res.objective[lane]), rtol=1e-6)


class TestStepRuleEvents:
    def _events(self, prob, rule, backend="kernels", oracle=LASSO, y=None):
        res = _port(prob, backend, TelemetrySpec(capacity=256), oracle, y, step_rule=rule)
        return ring_to_records(res.telemetry), res

    def _ref_events(self, prob, rule):
        Xt, y, _ = prob
        with jax.threefry_partitionable(False):
            ref = ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y),
                                   RefConfig(step_rule=rule, telemetry=RefSpec(capacity=256),
                                             **_base_kw()), jax.random.PRNGKey(SEED))
        return ref_records(ref.telemetry)

    @pytest.mark.parametrize("backend", ["torch", "kernels"])
    def test_away_codes(self, prob, backend):
        rec, res = self._events(prob, "away", backend)
        ev = set(rec["event"].tolist())
        assert EVENT_AWAY in ev and ev <= {EVENT_FW, EVENT_AWAY, EVENT_DROP}
        assert set(self._ref_events(prob, "away")["event"].tolist()) <= {
            EVENT_FW, EVENT_AWAY, EVENT_DROP}
        np.testing.assert_array_equal(rec["k"], np.arange(len(rec["k"])))
        assert rec["n_dots"][-1] == res.n_dots

    @pytest.mark.parametrize("backend", ["torch", "kernels"])
    def test_pairwise_codes(self, prob, backend):
        rec, _ = self._events(prob, "pairwise", backend)
        ev = set(rec["event"].tolist())
        assert EVENT_PAIRWISE in ev and ev <= {EVENT_FW, EVENT_PAIRWISE, EVENT_DROP}
        assert EVENT_PAIRWISE in set(self._ref_events(prob, "pairwise")["event"].tolist())

    def test_drop_event_is_the_exact_zero(self, prob):
        """A drop step's away coordinate leaves the iterate exactly: every
        EVENT_DROP record of an away run sits on such a step."""
        rec, _ = self._events(prob, "away", "torch")
        drops = np.nonzero(rec["event"] == EVENT_DROP)[0]
        assert np.all(rec["lam"][drops] > 0)

    @pytest.mark.parametrize("backend", ["torch", "kernels"])
    def test_partan_one_record_per_iteration(self, prob, backend):
        rec, res = self._events(prob, "partan", backend)
        # the classic half-step's record is amended, not duplicated
        assert len(rec["k"]) == res.iterations
        assert set(rec["event"].tolist()) == {EVENT_PARTAN}
        np.testing.assert_array_equal(rec["k"], np.arange(res.iterations))
        assert rec["n_dots"][-1] == res.n_dots
        assert rec["objective"][-1] == float(res.objective)
        ref = self._ref_events(prob, "partan")
        assert len(ref["k"]) == len(rec["k"]) and set(ref["event"].tolist()) == {EVENT_PARTAN}

    @pytest.mark.parametrize("backend", ["torch", "kernels"])
    def test_lazy_hits_recorded(self, prob, backend):
        rec, res = self._events(prob, "lazy", backend)
        ev = set(rec["event"].tolist())
        assert EVENT_LAZY_HIT in ev and ev <= {EVENT_FW, EVENT_LAZY_HIT}
        assert not np.any(np.isnan(rec["gap"]))
        assert rec["n_dots"][-1] == res.n_dots
        assert EVENT_LAZY_HIT in set(self._ref_events(prob, "lazy")["event"].tolist())

    def test_logistic_and_en_rules_record(self, prob):
        y = prob[1]
        labels = (np.sign(y) + (y == 0)).astype(np.float32)
        for oracle, yv in ((LOGISTIC, labels), (ENOracle(0.7), y)):
            for rule in ("away", "partan", "lazy"):
                rec, res = self._events(prob, rule, "kernels", oracle, yv)
                np.testing.assert_array_equal(rec["k"], np.arange(res.iterations))
                np.testing.assert_allclose(rec["objective"][-1], float(res.objective),
                                           rtol=1e-6)


class TestStreaming:
    def _stream(self, prob, backend="torch", **kw):
        batches = []
        register_sink("port-test-sink", batches.append)
        try:
            res = _port(prob, backend, **kw)
        finally:
            unregister_sink("port-test-sink")
        return res, batches

    def _ref_stream(self, prob, **kw):
        Xt, y, _ = prob
        batches = []
        ref_register_sink("ref-test-sink", batches.append)
        try:
            with jax.threefry_partitionable(False):
                ref = ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y),
                                       RefConfig(**_base_kw(**kw)), jax.random.PRNGKey(SEED))
                ref.alpha.block_until_ready()
                jax.effects_barrier()
        finally:
            ref_unregister_sink("ref-test-sink")
        return ref, batches

    @pytest.mark.parametrize("case", ["wrap", "exact multiple", "early stop"])
    def test_batches_match_reference(self, prob, case):
        """The sink receives the reference's batches: full rings at each wrap,
        the remainder in one final flush (none when the run is an exact
        multiple of the capacity), every record once and in order."""
        # delta 20: this stream's runs at delta 150 meet a near-tie of two
        # vertices, each with a zero step, at k = 18 (the packages' rounding
        # picks either), which would leave the batches' i_star apart
        kw = {"wrap": dict(delta=20.0, max_iters=50),
              "exact multiple": dict(delta=20.0, max_iters=32),
              "early stop": dict(delta=20.0, tol=1e-3, patience=10, max_iters=400)}[case]
        cap = 64 if case == "early stop" else 16
        res, got = self._stream(prob, spec=TelemetrySpec(capacity=cap, stream_to="port-test-sink"),
                                **kw)
        ref, want = self._ref_stream(prob, telemetry=RefSpec(capacity=cap,
                                                             stream_to="ref-test-sink"), **kw)
        assert [len(b["record_index"]) for b in got] == [len(b["record_index"]) for b in want]
        if case == "wrap":
            assert [len(b["record_index"]) for b in got] == [16, 16, 16, 2]
        if case == "exact multiple":
            assert [len(b["record_index"]) for b in got] == [16, 16]
        it = res.iterations
        assert it == int(ref.iterations)
        assert res.telemetry.cursor == res.telemetry.flushed == it
        np.testing.assert_array_equal(np.concatenate([b["record_index"] for b in got]),
                                      np.arange(it))
        for g, w in zip(got, want):
            _assert_ring_parity(g, w)

    def test_unregistered_sink_is_noop(self, prob):
        res = _port(prob, "kernels", TelemetrySpec(capacity=8, stream_to="nobody-home"),
                    max_iters=20)
        assert res.telemetry.cursor == 20

    def test_flush_is_one_copy_per_capacity(self, prob):
        """The loop flushes only when the ring holds ``capacity`` unflushed
        records: 120 steps through 16 slots are 7 full batches and the
        final 8."""
        res, got = self._stream(prob, spec=TelemetrySpec(capacity=16,
                                                        stream_to="port-test-sink"))
        assert [len(b["k"]) for b in got] == [16] * 7 + [8]

    def test_fused_chunk_larger_than_the_ring_loses_records_between_flushes(self, prob):
        """A chunk of K > capacity records wraps the ring before the turn's
        flush, as the reference's does: the sink sees the last ``capacity``
        records of the chunk."""
        res, got = self._stream(prob, spec=TelemetrySpec(capacity=4, record_objective=False,
                                                        stream_to="port-test-sink"),
                                fuse_steps=8, max_iters=24)
        idx = np.concatenate([b["record_index"] for b in got])
        np.testing.assert_array_equal(idx, np.concatenate([np.arange(4, 8), np.arange(12, 16),
                                                           np.arange(20, 24)]))

    def test_history_keeps_a_callers_sink(self, prob):
        Xt, y, _ = prob
        got = []
        register_sink("hist-sink", got.append)
        try:
            engine.solve_with_history(
                LASSO, torch.from_numpy(Xt), torch.from_numpy(y),
                FWConfig(telemetry=TelemetrySpec(capacity=4, stream_to="hist-sink"),
                         **_base_kw()),
                convert.stream_from_reference(_stream(30, 300), "cpu"), 30, device="cpu")
        finally:
            unregister_sink("hist-sink")
        assert [len(b["k"]) for b in got] == [30]


class TestTracer:
    def test_spans_counters_and_validation(self):
        tr = Tracer("t")
        with tr.span("outer", cat="x", detail=1):
            with tr.span("inner"):
                pass
            tr.counter("widgets", 2)
            tr.counter("widgets", 3)
            tr.instant("mark", note="hi")
        assert tr.counter_table() == {"widgets": 5.0}
        table = tr.span_table()
        assert table["outer"]["count"] == 1 and table["inner"]["count"] == 1
        assert validate_chrome_trace(tr.to_chrome()) == []
        assert validate_chrome_trace(json.dumps(tr.to_chrome())) == []

    def test_use_tracer_stacks(self):
        tr = Tracer("scoped")
        default = get_tracer()
        with use_tracer(tr):
            assert get_tracer() is tr
        assert get_tracer() is default

    def test_validator_rejects_bad_traces(self):
        assert validate_chrome_trace("not json")
        assert validate_chrome_trace({"nope": 1})
        assert validate_chrome_trace({"traceEvents": [{"ph": "Z", "name": "x", "ts": 0}]})
        assert validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "x", "ts": 0}]})
        errs = validate_chrome_trace(
            {"traceEvents": [{"ph": "B", "name": "a", "ts": 0, "pid": 1, "tid": 1}]})
        assert any("unclosed" in e for e in errs)

    def test_save_roundtrip(self, tmp_path):
        tr = Tracer("t")
        with tr.span("s"):
            pass
        path_ = tr.save(tmp_path / "trace.json")
        with open(path_) as fh:
            assert validate_chrome_trace(fh.read()) == []

    @pytest.mark.parametrize("driver", ["fw_path", "fw_path_batched"])
    def test_path_trace_events_match_reference(self, prob, driver):
        """A traced path emits the reference's span, instant and counter
        names and categories: one point span a grid point (one chunk span a
        lane chunk), inside one path span."""
        Xt, y, _ = prob
        deltas = [5.0, 20.0, 60.0, DELTA]
        kw = dict(delta=1.0, kappa=KAPPA, max_iters=200, tol=1e-3, patience=10)
        ref_tr, tr = RefTracer("ref"), Tracer("port")
        with jax.threefry_partitionable(False), ref_use_tracer(ref_tr):
            getattr(ref_path, driver)(jnp.asarray(Xt), jnp.asarray(y), deltas, RefConfig(**kw),
                                      **({"lane_width": 2} if "batched" in driver else {}))
        if driver == "fw_path":
            streams = _path_streams(4, 1, 200)
            extra = dict(sampler_fn=lambda g: convert.stream_from_reference(streams[g][0], "cpu"))
        else:
            streams = _path_streams(2, 2, 200)
            extra = dict(lane_width=2, lane_sampler_fn=lambda c: convert.lane_streams_from_reference(
                streams[c], "cpu"))
        with use_tracer(tr):
            getattr(path, driver)(torch.from_numpy(Xt), torch.from_numpy(y), deltas,
                                  FWConfig(backend="torch", **kw), device="cpu", **extra)

        def names(t):
            return sorted({(e["name"], e.get("cat"), e["ph"]) for e in t.events
                           if e["ph"] != "M" and e["name"] != "fw_path/straggler_point"})

        assert names(tr) == names(ref_tr)
        assert validate_chrome_trace(tr.to_chrome()) == []
        spans = tr.span_table()
        if driver == "fw_path":
            assert spans["fw_path/point"]["count"] == 4 and spans["fw_path"]["count"] == 1
        else:
            assert spans["fw_path_batched/chunk"]["count"] == 2
            assert tr.counter_table() == ref_tr.counter_table()


class TestTimed:
    def test_no_stdout_by_default(self, capsys):
        tr = Tracer("t")
        with use_tracer(tr):
            with timed("quiet-block"):
                pass
        assert capsys.readouterr().out == ""
        assert tr.span_table()["quiet-block"]["count"] == 1

    def test_dict_and_timer_sinks(self):
        d, t = {}, Timer()
        with use_tracer(Tracer("t")):
            with timed("x", sink=d):
                pass
            with timed("x", sink=d):
                pass
            with timed("y", sink=t):
                pass
        assert d["x"] > 0 and len(d) == 1
        assert t.count == 1 and t.total > 0

    def test_timer_merge(self):
        a, b = Timer(total=1.0, count=2), Timer(total=0.5, count=3)
        a.merge(b)
        assert a.total == 1.5 and a.count == 5
        assert a.mean == pytest.approx(0.3)

    def test_verbose_opt_in(self, capsys):
        with use_tracer(Tracer("t")):
            with timed("loud", verbose=True):
                pass
        assert "[timed] loud:" in capsys.readouterr().out


class TestMonitors:
    def test_straggler_detection_fake_clock(self):
        """Injected clock (ROADMAP.md R4): steps of 1.0 s with one 10x
        outlier, no sleeps."""
        times = iter([0.0, 1.0, 2.0, 3.0, 4.0, 14.0, 15.0, 16.0])
        mon = StepMonitor(clock=lambda: next(times))
        flags = []
        for _ in range(4):
            mon.begin()
            flags.append(mon.end())
        assert flags == [False, False, True, False]
        assert mon.stragglers == [3]

    def test_heartbeat_json(self, tmp_path):
        times = iter([0.0, 1.0, 2.0, 12.0])
        hb = tmp_path / "hb.json"
        mon = StepMonitor(heartbeat_path=hb, clock=lambda: next(times))
        mon.begin()
        mon.end()
        mon.begin()
        assert mon.end() is True
        data = json.loads(hb.read_text())
        assert data["step"] == 2 and data["straggler"] is True
        assert data["stragglers"] == [2]
        assert data["step_time"] == pytest.approx(10.0)

    def test_the_port_has_no_runtime_monitor_module(self):
        with pytest.raises(ImportError):
            importlib.import_module("repro_torch.runtime.monitor")

    def test_lane_progress_monitor(self):
        times = iter([0.0, 1.0, 2.0, 3.0])
        mon = LaneProgressMonitor(max_iters=100,
                                  chunk_monitor=StepMonitor(clock=lambda: next(times)))
        tr = Tracer("t")
        with use_tracer(tr):
            mon.begin_chunk()
            rec = mon.end_chunk(0, [1.0, 2.0], [30, 50], 20, [True, True])
        assert rec["lane_saved"] == [20, 0] and rec["freeze_at"] == [30, None]
        s = mon.summary()
        assert s["saved_iters"] == 20 and s["frozen_lanes"] == 1
        assert tr.counter_table()["path/saved_iters"] == 20.0
        assert validate_chrome_trace(tr.to_chrome()) == []


class TestReport:
    def test_build_and_render(self, prob, tmp_path):
        tr = Tracer("report-test")
        with use_tracer(tr):
            with tr.span("solve"):
                res = _port(prob, "kernels", TelemetrySpec(capacity=40), max_iters=40)
        report = build_report(
            meta=default_meta(git_sha="deadbeef", purpose="test"),
            runs=[{"name": "lasso_kernels", "backend": "kernels",
                   "iterations": res.iterations, "n_dots": res.n_dots,
                   "objective": float(res.objective), "ring": res.telemetry}],
            tracer=tr,
        )
        assert report["runs"][0]["event_counts"] == {"fw": 40}
        assert report["meta"]["torch"] == torch.__version__ and "device" in report["meta"]
        md = render_markdown(report)
        assert "deadbeef" in md and "Convergence curve — lasso_kernels" in md
        assert "| solve |" in md
        paths = write_report(tmp_path, report)
        with open(paths["json"]) as fh:
            loaded = json.load(fh)
        assert loaded["runs"][0]["records"]["k"][0] == 0
        assert (tmp_path / "solver_report.md").exists()


class TestConvert:
    def test_telemetry_from_reference(self, prob):
        """A reference ring (its numpy leaves) carried into the port's: the
        same records, one ring and lane-stacked."""
        ref, _ = _pair(prob, "torch", "xla", spec=None, ref_spec=RefSpec(capacity=64))
        leaves = {k: np.asarray(v) for k, v in ref.telemetry._asdict().items()}
        ring = convert.telemetry_from_reference(leaves, "cpu")
        got, want = ring_to_records(ring), ref_records(ref.telemetry)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f].astype(got[f].dtype), err_msg=f)
        lanes = convert.telemetry_from_reference(
            {k: np.stack([v, v]) for k, v in leaves.items()}, "cpu")
        assert lanes.cursor == [120, 120] and lanes.dev_cursor.tolist() == [120, 120]
        np.testing.assert_array_equal(ring_to_records(lanes.lane(1))["k"], want["k"])

    def test_ring_storage_layout(self):
        """Each field is a view of the one int32 storage, which the kernels
        write by the same offsets (``RING_WORDS`` words a record)."""
        ring = tel_lib.init_ring(TelemetrySpec(capacity=5), "cpu")
        ring = tel_lib.record(ring, k=3, i_star=7, event=EVENT_PARTAN, stall=2, lam=0.5,
                              gap=float("nan"), objective=1.25, step_inf=0.75, n_dots=2**40 + 3)
        assert ring.buf.shape == (tel_lib.RING_WORDS * 5,) and ring.buf.dtype == torch.int32
        assert ring.buf[0] == 3 and ring.buf[5] == 7 and ring.buf[10] == EVENT_PARTAN
        assert ring.buf[15] == 2
        assert ring.buf[20:25].view(torch.float32)[0] == 0.5
        assert ring.buf[30:35].view(torch.float32)[0] == 1.25
        assert ring.buf[40:50].view(torch.int64)[0] == 2**40 + 3
        assert ring.cursor == 1 and ring.n_dots[1] == -1
