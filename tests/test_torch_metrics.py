"""The port's metrics plane (``repro_torch.obs.metrics``/``export``) on the
CPU, mirroring tests/test_metrics.py: the primitives, the registry and the
exposition, copied with the module; then the solver and path bridges
against the reference's on the same run (the same index streams, drawn
inside ``jax.threefry_partitionable(False)``, ROADMAP.md Queue 3 R1): the
same families, help strings, label names and counts, the labels' backend
the port's word for the reference's ('torch' for 'xla', 'kernels' for
'pallas'); latency values are the host's own.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FWConfig as RefConfig
from repro.core import engine as ref_engine
from repro.core import path as ref_path
from repro.core.fw_lasso import LASSO as REF_LASSO
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import TelemetrySpec as RefSpec
from repro.obs import install_ring_sink as ref_install_ring_sink
from repro.obs import unregister_sink as ref_unregister_sink
from repro.obs import use_registry as ref_use_registry

from repro_torch import convert
from repro_torch.core import LASSO, FWConfig, engine, path
from repro_torch.obs import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsServer,
    TelemetrySpec,
    Tracer,
    get_registry,
    install_registry,
    install_ring_sink,
    render_openmetrics,
    ring_batch_to_registry,
    scrape,
    snapshot_json,
    tracer_to_registry,
    unregister_sink,
    use_registry,
    validate_openmetrics,
)
from repro_torch.obs.metrics import GAP_BUCKETS

DELTA, SEED, KAPPA = 150.0, 42, 40
PORT_BACKEND = {"xla": "torch", "pallas": "kernels", "sparse": "sparse"}


def _base_kw(**kw):
    base = dict(delta=DELTA, kappa=KAPPA, sampling="uniform", max_iters=120, tol=0.0,
                patience=10**9)
    base.update(kw)
    return base


def _stream(n_steps, key, p=300):
    with jax.threefry_partitionable(False):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.randint(sub, (KAPPA,), 0, p)

        _, draws = jax.lax.scan(body, key, None, length=n_steps)
    return np.asarray(draws)


def _path_streams(n_splits, width, n_steps):
    """The reference path drivers' streams from PRNGKey(0), one list a point
    (width 1) or lane chunk."""
    with jax.threefry_partitionable(False):
        key, out = jax.random.PRNGKey(0), []
        for _ in range(n_splits):
            key, *subs = jax.random.split(key, width + 1)
            out.append([_stream(n_steps, s) for s in subs])
    return out


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    return np.ascontiguousarray(ds.X.T), ds.y


def _families(reg):
    """Every family's (kind, help, label names) and each series' value, or
    a histogram's sample count (latency values and time gauges are the
    host's own; the
    per-step sampled gap's count is that of its positive values, which the
    packages' roundings may move across zero at a step whose gap is a
    rounding of zero, so it is left out)."""
    out = {}
    for fam in reg.collect():
        series = {}
        for key, val in fam.series():
            key = tuple((k, PORT_BACKEND.get(v, v) if k == "backend" else v) for k, v in key)
            if fam.kind == "histogram":
                val = None if fam.name == "fw_sampled_gap" else val["count"]
            elif fam.name.endswith("_seconds"):
                val = None  # a gauge of host times
            series[key] = val
        out[fam.name] = (fam.kind, fam.help, tuple(fam.labelnames), series)
    return out


class TestPrimitives:
    def test_counter_monotone(self):
        c = Counter("c", "help")
        c.inc()
        c.inc(2.5)
        assert c.value() == 3.5
        with pytest.raises(ValueError):
            c.inc(-1.0)

    def test_counter_labels(self):
        c = Counter("c", "help", ("backend",))
        c.inc(1, backend="xla")
        c.inc(2, backend="sparse")
        assert c.value(backend="xla") == 1
        assert c.value(backend="sparse") == 2
        assert [dict(k)["backend"] for k, _ in c.series()] == ["sparse", "xla"]
        with pytest.raises(ValueError):
            c.inc(1)  # missing label
        with pytest.raises(ValueError):
            c.inc(1, backend="xla", extra="nope")

    def test_gauge_set_add(self):
        g = Gauge("g", "help")
        g.set(4.0)
        g.set(2.0)  # last write wins
        assert g.value() == 2.0
        g.add(0.5)
        assert g.value() == 2.5

    def test_histogram_buckets_and_quantiles(self):
        h = Histogram("h", "help", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 1.5, 3.0, 100.0):
            h.observe(v)
        snap = h.snapshot()
        assert snap["count"] == 5
        assert snap["sum"] == pytest.approx(106.5)
        # cumulative per le bound, +Inf implicit
        assert snap["buckets"] == [(1.0, 1), (2.0, 3), (4.0, 4),
                                   (math.inf, 5)]
        # p50: target 2.5 falls in (1, 2], interpolated 3/4 through it
        assert h.quantile(0.5) == pytest.approx(1.75)
        # quantile landing in +Inf clamps to the top finite bound
        assert h.quantile(0.99) == 4.0

    def test_histogram_empty_is_nan(self):
        h = Histogram("h", "help", buckets=(1.0,))
        assert math.isnan(h.quantile(0.5))
        assert h.snapshot() is None

    def test_histogram_bucket_validation(self):
        with pytest.raises(ValueError):
            Histogram("h", "help", buckets=())
        with pytest.raises(ValueError):
            Histogram("h", "help", buckets=(2.0, 1.0))
        with pytest.raises(ValueError):
            Histogram("h", "help", buckets=(1.0, 1.0))
        # a trailing +Inf is legal but implicit
        h = Histogram("h", "help", buckets=(1.0, math.inf))
        assert h.buckets == (1.0,)

    def test_exact_bucket_boundary_counts_le(self):
        h = Histogram("h", "help", buckets=(1.0, 2.0))
        h.observe(1.0)
        assert h.snapshot()["buckets"][0] == (1.0, 1)  # le is inclusive


class TestRegistry:
    def test_get_or_create_returns_same_family(self):
        reg = MetricsRegistry()
        a = reg.counter("fw_x", "first", ("l",))
        b = reg.counter("fw_x", "redeclared-help-ignored", ("l",))
        assert a is b

    def test_kind_and_label_conflicts_raise(self):
        reg = MetricsRegistry()
        reg.counter("fw_x", "", ("l",))
        with pytest.raises(ValueError):
            reg.gauge("fw_x", "")
        with pytest.raises(ValueError):
            reg.counter("fw_x", "", ("other",))

    def test_bucket_conflict_raises(self):
        reg = MetricsRegistry()
        reg.histogram("fw_h", "", buckets=(1.0, 2.0))
        with pytest.raises(ValueError):
            reg.histogram("fw_h", "", buckets=(1.0, 3.0))
        # re-declaring identical buckets is fine
        assert reg.histogram("fw_h", "", buckets=(1.0, 2.0)) is reg.get("fw_h")

    def test_collect_sorted(self):
        reg = MetricsRegistry()
        reg.counter("fw_b", "")
        reg.counter("fw_a", "")
        assert [m.name for m in reg.collect()] == ["fw_a", "fw_b"]

    def test_off_by_default_and_scoped_install(self):
        assert get_registry() is None
        reg = MetricsRegistry()
        with use_registry(reg):
            assert get_registry() is reg
            inner = MetricsRegistry()
            with use_registry(inner):
                assert get_registry() is inner
            assert get_registry() is reg
        assert get_registry() is None

    def test_process_install_uninstall(self):
        reg = MetricsRegistry()
        prev = install_registry(reg)
        try:
            assert prev is None
            assert get_registry() is reg
        finally:
            install_registry(None)
        assert get_registry() is None


class TestExport:
    def _populated(self):
        reg = MetricsRegistry()
        reg.counter("fw_things", "things seen", ("kind",)).inc(3, kind="a")
        reg.gauge("fw_depth", "queue depth").set(2.0)
        h = reg.histogram("fw_lat_seconds", "latency", buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(0.5)
        h.observe(5.0)
        return reg

    def test_render_validates_clean(self):
        text = render_openmetrics(self._populated())
        assert validate_openmetrics(text) == []
        assert text.endswith("# EOF\n")
        assert 'fw_things_total{kind="a"} 3' in text
        assert 'fw_lat_seconds_bucket{le="+Inf"} 3' in text
        assert 'quantile="0.5"' in text

    def test_validator_rejects_bad_exposition(self):
        assert validate_openmetrics("")  # no EOF
        assert validate_openmetrics("junk line !!\n# EOF\n")
        # counter sample without the _total suffix
        bad = ("# TYPE fw_c counter\nfw_c 1\n# EOF\n")
        assert any("_total" in p for p in validate_openmetrics(bad))
        # histogram with non-cumulative buckets
        bad = (
            "# TYPE fw_h histogram\n"
            'fw_h_bucket{le="1.0"} 5\n'
            'fw_h_bucket{le="+Inf"} 3\n'
            "fw_h_sum 1\nfw_h_count 3\n# EOF\n"
        )
        assert validate_openmetrics(bad)

    def test_snapshot_json(self):
        snap = snapshot_json(self._populated())
        assert set(snap) == {"fw_things", "fw_depth", "fw_lat_seconds"}
        lat = snap["fw_lat_seconds"]
        assert lat["kind"] == "histogram"
        (series,) = lat["series"]
        assert series["count"] == 3
        assert series["bucket_counts"] == [1, 2, 3]  # cumulative, le-ordered
        assert set(series["quantiles"]) == {"0.5", "0.95", "0.99"}
        assert json.dumps(snap)  # JSON-serializable end to end

    def test_http_endpoint_scrape(self):
        reg = self._populated()
        with MetricsServer(registry=reg, port=0) as srv:
            text = scrape(srv.url)
            assert validate_openmetrics(text) == []
            assert "fw_things_total" in text
            js = json.loads(scrape(srv.url + ".json"))
        assert "fw_lat_seconds" in js

    def test_server_follows_live_registry(self):
        """Constructed with registry=None the server serves whatever is
        installed at scrape time — the long-running-process shape."""
        with MetricsServer(port=0) as srv:
            reg = MetricsRegistry()
            reg.counter("fw_live", "").inc(7)
            with use_registry(reg):
                assert "fw_live_total 7" in scrape(srv.url)
            # registry popped -> empty (but valid) exposition
            assert validate_openmetrics(scrape(srv.url)) == []


class TestSolverBridges:
    def test_registry_on_is_bitwise_identical(self, prob):
        """The metrics shim never touches the trajectory: alpha, iterations
        and dot counts bit for bit with the registry installed or not."""
        Xt, y = prob
        runs = []
        for reg in (None, MetricsRegistry()):
            sampler = convert.stream_from_reference(_stream(120, jax.random.PRNGKey(SEED)),
                                                    "cpu")
            if reg is None:
                runs.append(engine.solve(LASSO, Xt, y, FWConfig(**_base_kw()), sampler,
                                         device="cpu"))
            else:
                with use_registry(reg):
                    runs.append(engine.solve(LASSO, Xt, y, FWConfig(**_base_kw()), sampler,
                                             device="cpu"))
        off, on = runs
        assert torch.equal(off.alpha, on.alpha)
        assert (off.iterations, off.n_dots) == (on.iterations, on.n_dots)

    @pytest.mark.parametrize("entry", ["solve", "solve_with_history", "solve_batched"])
    @pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
    def test_solve_families_match_reference(self, prob, entry, ref_backend):
        """Each entry point's families on the same run as the reference's:
        names, kinds, help strings, label names, totals and sample counts."""
        Xt, y = prob
        kw = _base_kw(report_gap=True, fuse_steps=8 if entry == "solve" else 1)
        ref_reg, reg = RefRegistry(), MetricsRegistry()
        key = jax.random.PRNGKey(SEED)
        ref_cfg = RefConfig(backend=ref_backend, interpret=True if ref_backend == "pallas"
                            else None, **kw)
        cfg = FWConfig(backend=PORT_BACKEND[ref_backend], **kw)
        with jax.threefry_partitionable(False), ref_use_registry(ref_reg):
            if entry == "solve":
                ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y), ref_cfg, key)
            elif entry == "solve_with_history":
                ref_engine.solve_with_history(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y),
                                              ref_cfg, key, 60)
            else:
                keys = jax.random.split(key, 2)
                ref_engine.solve_batched(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y),
                                         ref_cfg, keys, jnp.zeros((2, 300), jnp.float32),
                                         jnp.asarray([20.0, DELTA]))
        with use_registry(reg):
            if entry == "solve":
                engine.solve(LASSO, Xt, y, cfg, convert.stream_from_reference(
                    _stream(128, key), "cpu"), device="cpu")
            elif entry == "solve_with_history":
                engine.solve_with_history(LASSO, Xt, y, cfg, convert.stream_from_reference(
                    _stream(60, key), "cpu"), 60, device="cpu")
            else:
                with jax.threefry_partitionable(False):
                    keys = jax.random.split(key, 2)
                streams = [_stream(120, k) for k in keys]
                engine.solve_batched(LASSO, Xt, y, cfg,
                                     convert.lane_streams_from_reference(streams, "cpu"), None,
                                     [20.0, DELTA], device="cpu")
        assert _families(reg) == _families(ref_reg)
        lbl = dict(entry=entry, backend=cfg.backend, step_rule="classic")
        assert reg.get("fw_certified_gap").buckets == GAP_BUCKETS
        assert not math.isnan(reg.get("fw_solve_latency_seconds").quantile(0.5, **lbl))

    def test_no_registry_records_nothing(self, prob):
        """OFF state: entry points pass straight through (nothing to
        observe, no registry to fill)."""
        Xt, y = prob
        engine.solve(LASSO, Xt, y, FWConfig(**_base_kw(max_iters=5)),
                     convert.stream_from_reference(_stream(5, jax.random.PRNGKey(SEED)), "cpu"),
                     device="cpu")
        assert get_registry() is None

    def test_entry_attribute_forwarding(self):
        """The shim forwards attributes of the function it wraps."""
        assert engine.solve.__name__ == "solve"
        assert engine.solve_batched.__name__ == "solve_batched"
        assert engine.solve_prepared.__wrapped__.__name__ == "_solve_prepared"
        assert engine.solve.__doc__ == engine.solve.__wrapped__.__doc__

    def test_ring_batch_bridge(self):
        reg = MetricsRegistry()
        batch = {
            "k": np.arange(6),
            "event": np.asarray([0, 0, 1, 2, 0, 5]),
            "gap": np.asarray([1.0, 0.5, np.nan, -1.0, 10.0, 2.0]),
        }
        ring_batch_to_registry(batch, reg, backend="torch")
        assert reg.get("fw_ring_iterations_total").value(backend="torch") == 6
        ev = reg.get("fw_step_events_total")
        assert ev.value(backend="torch", event="fw") == 3
        assert ev.value(backend="torch", event="away") == 1
        assert ev.value(backend="torch", event="partan") == 1
        # only finite positive gaps land in the histogram
        assert reg.get("fw_sampled_gap").snapshot(backend="torch")["count"] == 4

    def test_ring_sink_streams_into_registry(self, prob):
        """TelemetrySpec(stream_to=install_ring_sink()) folds every ring flush
        into the live registry, as the reference's does on the same run."""
        Xt, y = prob
        reg, ref_reg = MetricsRegistry(), RefRegistry()
        name, ref_name = install_ring_sink(), ref_install_ring_sink()
        try:
            with use_registry(reg):
                engine.solve(LASSO, Xt, y, FWConfig(**_base_kw(
                    delta=20.0, max_iters=50, telemetry=TelemetrySpec(capacity=16,
                                                                      stream_to=name))),
                    convert.stream_from_reference(_stream(50, jax.random.PRNGKey(SEED)), "cpu"),
                    device="cpu")
            with jax.threefry_partitionable(False), ref_use_registry(ref_reg):
                res = ref_engine.solve(REF_LASSO, jnp.asarray(Xt), jnp.asarray(y), RefConfig(
                    **_base_kw(delta=20.0, max_iters=50,
                               telemetry=RefSpec(capacity=16, stream_to=ref_name))),
                    jax.random.PRNGKey(SEED))
                res.alpha.block_until_ready()
                jax.effects_barrier()
        finally:
            unregister_sink(name)
            ref_unregister_sink(ref_name)
        assert reg.get("fw_ring_iterations_total").value() == 50
        assert reg.get("fw_step_events_total").value(event="fw") == 50
        for fam in ("fw_ring_iterations_total", "fw_step_events_total", "fw_sampled_gap"):
            assert _families(reg)[fam] == _families(ref_reg)[fam]

    def test_tracer_bridge_is_incremental(self):
        tr = Tracer("t")
        reg = MetricsRegistry()
        with tr.span("load"):
            pass
        tr.counter("widgets", 2)
        tracer_to_registry(tr, reg)
        tracer_to_registry(tr, reg)  # idempotent on the same events
        assert reg.get("fw_span_seconds").snapshot(span="load")["count"] == 1
        assert reg.get("fw_trace_counter").value(counter="widgets") == 2
        with tr.span("load"):
            pass
        tr.counter("widgets", 3)
        tracer_to_registry(tr, reg)  # only the delta lands
        assert reg.get("fw_span_seconds").snapshot(span="load")["count"] == 2
        assert reg.get("fw_trace_counter").value(counter="widgets") == 5


class TestAcceptanceScrape:
    @pytest.mark.parametrize("driver", ["fw_path", "fw_path_batched"])
    def test_path_families_match_reference(self, prob, driver):
        """A path with a registry installed, in both packages on the same
        streams: the same families and counts (solves, lanes, freezes,
        saved iterations, point and chunk samples, the tracer's spans)."""
        Xt, y = prob
        deltas = [5.0, 20.0, 60.0, DELTA]
        kw = dict(delta=1.0, kappa=KAPPA, max_iters=300, tol=1e-4, patience=20)
        ref_reg, reg = RefRegistry(), MetricsRegistry()
        with jax.threefry_partitionable(False), ref_use_registry(ref_reg):
            getattr(ref_path, driver)(jnp.asarray(Xt), jnp.asarray(y), deltas, RefConfig(**kw),
                                      **({"lane_width": 4} if "batched" in driver else {}))
        if driver == "fw_path":
            streams = _path_streams(4, 1, 300)
            extra = dict(sampler_fn=lambda g: convert.stream_from_reference(streams[g][0], "cpu"))
        else:
            streams = _path_streams(1, 4, 300)
            extra = dict(lane_width=4, lane_sampler_fn=lambda c: convert.lane_streams_from_reference(
                streams[c], "cpu"))
        with use_registry(reg), use_tracer_scope():
            getattr(path, driver)(Xt, y, deltas, FWConfig(backend="torch", **kw), device="cpu",
                                  **extra)
        got, want = _families(reg), _families(ref_reg)
        # the span table's families: the reference's spans on its global
        # tracer accumulate across tests; the path's own spans are checked
        got.pop("fw_span_seconds"), want.pop("fw_span_seconds")
        got.pop("fw_trace_counter", None), want.pop("fw_trace_counter", None)
        # the straggler count: both packages set it from the host clock, so a
        # loaded host can mark a point slow in one run and not in the other
        got.pop("fw_monitor_stragglers", None), want.pop("fw_monitor_stragglers", None)
        assert got == want

    def test_batched_sparse_path_scrape(self, prob):
        """Scrape a live ``/metrics`` during a batched sparse path solve: the
        exposition validates and carries p50/p99 solve latency and the lane
        freeze counters."""
        Xt, y = prob
        Xs = Xt.copy()
        Xs[np.abs(Xs) < 0.7] = 0.0
        from repro_torch.sparse import SparseBlockMatrix

        mat = SparseBlockMatrix.from_dense(Xs, block_size=64)
        cfg = FWConfig(delta=1.0, kappa=KAPPA, sampling="uniform", max_iters=300, tol=1e-4,
                       patience=20, backend="sparse")
        reg = MetricsRegistry()
        with use_registry(reg), MetricsServer(registry=reg, port=0) as srv:
            path.fw_path_batched(mat, y, [5.0, 20.0, 60.0, DELTA], cfg, lane_width=4,
                                 device="cpu")
            text = scrape(srv.url)
        assert validate_openmetrics(text) == []
        assert "fw_lane_freezes_total" in text
        assert reg.get("fw_lanes_admitted").value(backend="sparse") == 4
        assert reg.get("fw_lane_freezes").value(backend="sparse") >= 1
        lat = reg.get("fw_solve_latency_seconds")
        lbl = dict(entry="solve_batched", backend="sparse", step_rule="classic")
        for q in (0.5, 0.99):
            assert not math.isnan(lat.quantile(q, **lbl))
        snap = reg.get("fw_path_point_seconds").snapshot(driver="batched", backend="sparse")
        assert snap["count"] == 4

    def test_sequential_path_points_observed(self, prob):
        Xt, y = prob
        reg = MetricsRegistry()
        with use_registry(reg):
            path.fw_path(Xt, y, [20.0, DELTA], FWConfig(**_base_kw(max_iters=60)), device="cpu")
        snap = reg.get("fw_path_point_seconds").snapshot(driver="sequential", backend="kernels")
        assert snap["count"] == 2
        # the path tracer's spans were folded in on completion
        assert reg.get("fw_span_seconds").snapshot(span="fw_path/point")["count"] >= 2


def use_tracer_scope():
    """A fresh tracer for one path (the port's global tracer would carry
    other tests' spans into the bridge)."""
    from repro_torch.obs import use_tracer

    return use_tracer(Tracer("path"))
