"""Solver observability layer (the reference's ``obs`` package, on torch).

Its parts, all off the hot path by default:
  * ``obs.telemetry`` — per-iteration metric rings on the device,
    carried in ``EngineState`` when ``FWConfig.telemetry`` is set
    (telemetry off launches what the loop launched before, bit for bit);
  * ``obs.trace`` — host-side nested span tracing emitting
    Chrome/Perfetto ``trace_event`` JSON plus an aggregate counter
    table;
  * ``obs.monitor`` / ``obs.report`` — EWMA straggler + lane-progress
    monitoring and markdown/JSON run-report rendering;
  * ``obs.metrics`` / ``obs.export`` — the aggregated metrics plane:
    a labeled Counter/Gauge/Histogram registry the raw primitives
    bridge into, exposed as OpenMetrics text / JSON snapshots / a
    background ``/metrics`` HTTP endpoint. OFF until a registry is
    installed (``install_registry`` / ``use_registry``).

NOTE: ``repro_torch.core.solver_config`` imports ``obs.telemetry``, so
this package must stay import-clean of ``repro_torch.core``.
"""
from repro_torch.obs.export import (
    MetricsServer,
    render_openmetrics,
    scrape,
    snapshot_json,
    validate_openmetrics,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    install_registry,
    install_ring_sink,
    ring_batch_to_registry,
    tracer_to_registry,
    use_registry,
)
from repro_torch.obs.monitor import LaneProgressMonitor, StepMonitor
from repro_torch.obs.report import build_report, default_meta, render_markdown, write_report
from repro_torch.obs.telemetry import (
    EVENT_AWAY,
    EVENT_DROP,
    EVENT_FW,
    EVENT_LAZY_HIT,
    EVENT_NAMES,
    EVENT_PAIRWISE,
    EVENT_PARTAN,
    TelemetryRing,
    TelemetrySpec,
    register_sink,
    ring_to_records,
    unregister_sink,
)
from repro_torch.obs.trace import (
    Tracer,
    get_tracer,
    traced,
    use_tracer,
    validate_chrome_trace,
)

__all__ = [
    "Counter", "EVENT_AWAY", "EVENT_DROP", "EVENT_FW", "EVENT_LAZY_HIT",
    "EVENT_NAMES", "EVENT_PAIRWISE", "EVENT_PARTAN", "Gauge", "Histogram",
    "LaneProgressMonitor", "MetricsRegistry", "MetricsServer", "StepMonitor",
    "Tracer", "TelemetryRing", "TelemetrySpec", "build_report", "default_meta",
    "get_registry",
    "get_tracer", "install_registry", "install_ring_sink", "register_sink",
    "render_markdown", "render_openmetrics", "ring_batch_to_registry",
    "ring_to_records", "scrape", "snapshot_json", "tracer_to_registry",
    "traced", "unregister_sink", "use_registry", "use_tracer",
    "validate_chrome_trace", "validate_openmetrics", "write_report",
]
