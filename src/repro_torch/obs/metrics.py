"""Aggregated metrics plane (the reference's ``obs/metrics.py``, ported by
copy).

A ``MetricsRegistry`` is the host-side aggregation layer that the raw
observability primitives — ``TelemetryRing`` flushes, ``Tracer``
spans/counters, ``StepMonitor``/``LaneProgressMonitor`` — feed, and that
the export layer (``repro_torch.obs.export``: OpenMetrics text, JSON
snapshots, the background ``/metrics`` HTTP endpoint) serves. Three
metric kinds, all labeled:

  * ``Counter`` — monotone totals (solves_total, lane_freezes_total);
  * ``Gauge``   — last-written values (queue depth, EWMA step time);
  * ``Histogram`` — fixed-bucket distributions with ``_sum``/``_count``
    and bucket-interpolated quantiles (p50/p95/p99). Buckets are FIXED
    at construction so two snapshots of the same metric are always
    mergeable/diffable — the same reason the paper's BENCH artifacts
    pin their shapes.

The plane is OFF by default: ``get_registry()`` returns None until a
registry is installed (``install_registry`` / ``use_registry``), and
every instrumentation site in the solver is gated on that — the
no-registry program is the pre-metrics program, matching the
``FWConfig.telemetry=None`` contract one layer down. All recording is
host-side and thread-safe; nothing here ever runs inside a jitted
function.
"""
from __future__ import annotations

import bisect
import math
import threading
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Default latency buckets (seconds): log-ish spacing from 100us to 2min,
# wide enough for both a single fused chunk and a full CI-scale path.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# Duality-gap magnitude buckets: the certified gap spans ~1e-8 .. 1e4
# across the regularization path, so decades are the natural resolution.
GAP_BUCKETS: Tuple[float, ...] = tuple(10.0 ** e for e in range(-8, 5))

# Shard-IO byte buckets: 4 KB .. 1 GB in powers of 4.
BYTES_BUCKETS: Tuple[float, ...] = tuple(float(4096 * 4 ** e) for e in range(10))

QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> _LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared labelnames {sorted(labelnames)}"
        )
    return tuple((name, str(labels[name])) for name in labelnames)


class Counter:
    """Monotone labeled counter."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({value})")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def series(self) -> List[Tuple[_LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())


class Gauge:
    """Last-value-wins labeled gauge (set / add)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)

    def add(self, value: float, **labels: str) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(value)

    def value(self, **labels: str) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def series(self) -> List[Tuple[_LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram:
    """Fixed-bucket labeled histogram with interpolated quantiles.

    ``buckets`` are the upper bounds (le) of each finite bucket; a +Inf
    bucket is implicit. ``quantile(q)`` linearly interpolates inside the
    bucket holding the q-th observation — exact enough for p50/p95/p99
    reporting at the fixed-bucket resolution, and computable from a
    scraped snapshot alone (the same arithmetic a Prometheus
    ``histogram_quantile`` applies server-side).
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
    ):
        if not buckets:
            raise ValueError(f"histogram {name} needs at least one bucket")
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name} buckets must strictly increase")
        if math.isinf(bounds[-1]):
            bounds = bounds[:-1]  # +Inf is implicit
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(bounds)
        self._series: Dict[_LabelKey, _HistSeries] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(self.labelnames, labels)
        idx = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            s = self._series.setdefault(key, _HistSeries(len(self.buckets)))
            s.counts[idx] += 1
            s.sum += float(value)
            s.count += 1

    def snapshot(self, **labels: str) -> Optional[Dict]:
        """{"buckets": [(le, cumulative_count)...], "sum", "count"} for
        one label set (None when never observed)."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return None
            cum, out = 0, []
            for le, c in zip(self.buckets + (math.inf,), s.counts):
                cum += c
                out.append((le, cum))
            return {"buckets": out, "sum": s.sum, "count": s.count}

    def quantile(self, q: float, **labels: str) -> float:
        """Interpolated q-quantile for one label set (NaN when empty)."""
        snap = self.snapshot(**labels)
        if snap is None or snap["count"] == 0:
            return float("nan")
        target = q * snap["count"]
        prev_le, prev_cum = 0.0, 0
        for le, cum in snap["buckets"]:
            if cum >= target:
                if math.isinf(le):
                    return self.buckets[-1] if self.buckets else float("nan")
                if cum == prev_cum:
                    return le
                frac = (target - prev_cum) / (cum - prev_cum)
                return prev_le + frac * (le - prev_le)
            prev_le, prev_cum = le, cum
        return float(snap["buckets"][-1][0])

    def series(self) -> List[Tuple[_LabelKey, Dict]]:
        with self._lock:
            keys = sorted(self._series)
        return [(k, self.snapshot(**dict(k))) for k in keys]


class MetricsRegistry:
    """Named metric families; get-or-create semantics so instrumentation
    sites can declare their metric inline without an init ceremony.
    Re-declaring a name with a different kind/labels/buckets is an error
    (two writers disagreeing about a metric is a bug, not a merge)."""

    def __init__(self, namespace: str = "fw"):
        self.namespace = namespace
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}({existing.labelnames})"
                    )
                if kw.get("buckets") is not None and tuple(
                    float(b) for b in kw["buckets"]
                ) != existing.buckets:
                    raise ValueError(f"metric {name!r} bucket mismatch")
                return existing
            metric = cls(name, help, labelnames, **{
                k: v for k, v in kw.items() if v is not None
            })
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames,
            buckets=tuple(buckets) if buckets is not None else LATENCY_BUCKETS_S,
        )

    def collect(self) -> List[object]:
        with self._lock:
            return [self._metrics[name] for name in sorted(self._metrics)]

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)


# --------------------------------------------------------------------------
# Install plumbing: the plane is OFF until a registry is installed
# --------------------------------------------------------------------------

_installed: Optional[MetricsRegistry] = None
_stack: List[MetricsRegistry] = []
_install_lock = threading.Lock()


def get_registry() -> Optional[MetricsRegistry]:
    """The active registry, or None — the OFF state every solver
    instrumentation site gates on."""
    with _install_lock:
        return _stack[-1] if _stack else _installed


def install_registry(registry: Optional[MetricsRegistry]) -> Optional[MetricsRegistry]:
    """Install ``registry`` process-wide (None uninstalls). Returns the
    previously installed registry."""
    global _installed
    with _install_lock:
        prev, _installed = _installed, registry
    return prev


@contextmanager
def use_registry(registry: MetricsRegistry):
    """Scoped install — the with-block's instrumentation lands on
    ``registry``; nesting wins innermost, like ``use_tracer``."""
    with _install_lock:
        _stack.append(registry)
    try:
        yield registry
    finally:
        with _install_lock:
            _stack.remove(registry)


# --------------------------------------------------------------------------
# Bridges from the raw observability primitives
# --------------------------------------------------------------------------

# telemetry-ring event names live in obs.telemetry; imported lazily in
# ring_batch_to_registry to keep this module import-light (export/server
# code paths must not pull torch transitively)


def ring_batch_to_registry(
    batch: Dict[str, np.ndarray], registry: MetricsRegistry, **labels: str
) -> None:
    """Fold one ring flush batch (``ring_to_records`` dict format) into
    the registry: iteration totals and per-event step counters. Usable
    directly as a streaming sink via ``install_ring_sink``."""
    from repro_torch.obs import telemetry as obs_telemetry

    n = len(batch.get("k", ()))
    if n == 0:
        return
    label_names = tuple(sorted(labels))
    registry.counter(
        "fw_ring_iterations_total",
        "solver iterations observed through telemetry-ring flushes",
        label_names,
    ).inc(n, **labels)
    events = np.asarray(batch["event"], np.int64)
    ctr = registry.counter(
        "fw_step_events_total",
        "step-rule events by kind (telemetry-ring event codes)",
        label_names + ("event",),
    )
    for code, name in enumerate(obs_telemetry.EVENT_NAMES):
        c = int((events == code).sum())
        if c:
            ctr.inc(c, event=name, **labels)
    gaps = np.asarray(batch.get("gap", ()), np.float64)
    gaps = gaps[np.isfinite(gaps) & (gaps > 0)]
    if gaps.size:
        hist = registry.histogram(
            "fw_sampled_gap",
            "per-iteration sampled FW duality gap (ring flushes)",
            label_names,
            buckets=GAP_BUCKETS,
        )
        for g in gaps:
            hist.observe(float(g), **labels)


RING_SINK_NAME = "metrics-registry"


def install_ring_sink(
    registry: Optional[MetricsRegistry] = None, name: str = RING_SINK_NAME,
    **labels: str,
) -> str:
    """Register a telemetry streaming sink that folds every flushed ring
    batch into the registry (the live one at flush time when ``registry``
    is None). Use as ``TelemetrySpec(stream_to=install_ring_sink())``.
    Returns the sink name; unregister with
    ``obs.telemetry.unregister_sink``."""
    from repro_torch.obs import telemetry as obs_telemetry

    def sink(batch):
        reg = registry if registry is not None else get_registry()
        if reg is not None:
            ring_batch_to_registry(batch, reg, **labels)

    obs_telemetry.register_sink(name, sink)
    return name


def tracer_to_registry(tracer, registry: MetricsRegistry) -> None:
    """Fold a Tracer's aggregate view into the registry: per-span-name
    duration histograms and the trace-time counter table. Incremental —
    a bridge position is kept on the tracer, so calling this repeatedly
    against the same (accumulating) tracer observes each span once and
    counters advance by their delta."""
    hist = registry.histogram(
        "fw_span_seconds",
        "host-side span durations by span name (Tracer bridge)",
        ("span",),
    )
    events = list(tracer.events)
    start = getattr(tracer, "_metrics_bridge_pos", 0)
    for ev in events[start:]:
        if ev.get("ph") == "X":
            hist.observe(ev.get("dur", 0.0) / 1e6, span=ev["name"])
    tracer._metrics_bridge_pos = len(events)
    ctr = registry.counter(
        "fw_trace_counter",
        "Tracer aggregate counters (trace-time sites for jitted code)",
        ("counter",),
    )
    for name, value in tracer.counter_table().items():
        already = ctr.value(counter=name)
        if value > already:
            ctr.inc(value - already, counter=name)
