"""Metrics exposition (the reference's ``obs/export.py``, ported by copy).

Serializes a ``MetricsRegistry`` three ways:

  * ``render_openmetrics`` — OpenMetrics/Prometheus text format, with
    cumulative ``_bucket{le=...}`` series, ``_sum``/``_count``, AND
    summary-style ``{quantile="0.5|0.95|0.99"}`` samples derived from
    the fixed buckets, so a scrape alone answers "what is p99 solve
    latency" without a query engine;
  * ``snapshot_json`` — a structured dict (same content, machine-first)
    for report artifacts;
  * ``MetricsServer`` — a daemon-thread HTTP endpoint serving
    ``/metrics`` (text) and ``/metrics.json``, the scrape surface the
    serving layer (ROADMAP direction 1) points Prometheus at.

``validate_openmetrics`` is the exposition checker CI's telemetry smoke
runs against a live scrape: TYPE/HELP lines, sample syntax, bucket
monotonicity and the ``# EOF`` terminator.

Import-light on purpose: no torch, no repro_torch.core — this module must be
loadable from a scrape-only process.
"""
from __future__ import annotations

import http.server
import json
import math
import re
import threading
import urllib.request
from typing import Dict, List, Optional

from repro_torch.obs.metrics import (
    QUANTILES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_ESCAPES = {"\\": "\\\\", "\n": "\\n", '"': '\\"'}


def _escape_label(v: str) -> str:
    return "".join(_ESCAPES.get(ch, ch) for ch in v)


def _labels_str(pairs, extra=()) -> str:
    items = [f'{k}="{_escape_label(v)}"' for k, v in (*pairs, *extra)]
    return "{" + ",".join(items) + "}" if items else ""


def render_openmetrics(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry as OpenMetrics text (ends with ``# EOF``)."""
    registry = registry if registry is not None else get_registry()
    lines: List[str] = []
    for metric in registry.collect() if registry is not None else ():
        name = metric.name
        if metric.help:
            lines.append(f"# HELP {name} {metric.help}")
        if isinstance(metric, Counter):
            lines.append(f"# TYPE {name} counter")
            for key, value in metric.series():
                lines.append(f"{name}_total{_labels_str(key)} {_fmt(value)}")
        elif isinstance(metric, Gauge):
            lines.append(f"# TYPE {name} gauge")
            for key, value in metric.series():
                lines.append(f"{name}{_labels_str(key)} {_fmt(value)}")
        elif isinstance(metric, Histogram):
            lines.append(f"# TYPE {name} histogram")
            for key, snap in metric.series():
                for le, cum in snap["buckets"]:
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels_str(key, (('le', _fmt(le)),))} {cum}"
                    )
                lines.append(f"{name}_sum{_labels_str(key)} {_fmt(snap['sum'])}")
                lines.append(f"{name}_count{_labels_str(key)} {snap['count']}")
                for q in QUANTILES:
                    val = metric.quantile(q, **dict(key))
                    lines.append(
                        f"{name}"
                        f"{_labels_str(key, (('quantile', _fmt(q)),))} {_fmt(val)}"
                    )
        else:  # pragma: no cover - registry only creates the three kinds
            raise TypeError(f"unknown metric kind {type(metric).__name__}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def snapshot_json(registry: Optional[MetricsRegistry] = None) -> Dict:
    """Machine-first snapshot: {metric: {kind, help, series: [...]}}."""
    registry = registry if registry is not None else get_registry()
    out: Dict[str, Dict] = {}
    for metric in registry.collect() if registry is not None else ():
        entry: Dict = {"kind": metric.kind, "help": metric.help, "series": []}
        if isinstance(metric, Histogram):
            entry["buckets"] = list(metric.buckets)
            for key, snap in metric.series():
                entry["series"].append(
                    {
                        "labels": dict(key),
                        "sum": snap["sum"],
                        "count": snap["count"],
                        "bucket_counts": [c for _, c in snap["buckets"]],
                        "quantiles": {
                            _fmt(q): metric.quantile(q, **dict(key))
                            for q in QUANTILES
                        },
                    }
                )
        else:
            for key, value in metric.series():
                entry["series"].append({"labels": dict(key), "value": value})
        out[metric.name] = entry
    return out


# --------------------------------------------------------------------------
# Exposition checker
# --------------------------------------------------------------------------

_METRIC_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    rf"^({_METRIC_NAME})(\{{.*\}})? (-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]Inf|NaN)$"
)
_LABELS_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def validate_openmetrics(text: str) -> List[str]:
    """Check OpenMetrics text; returns a list of problems (empty = valid).

    Validates: every non-comment line parses as a sample; TYPE declared
    before its samples; histogram buckets are cumulative (monotone,
    ending at +Inf == _count); counters use the _total suffix; the text
    terminates with ``# EOF``.
    """
    problems: List[str] = []
    lines = text.splitlines()
    if not lines or lines[-1].strip() != "# EOF":
        problems.append("missing '# EOF' terminator")
    types: Dict[str, str] = {}
    # per (hist-name, labels-minus-le): [(le, cum)...] in appearance order
    hist_buckets: Dict[tuple, List[tuple]] = {}
    hist_counts: Dict[tuple, float] = {}
    for ln, raw in enumerate(lines, 1):
        line = raw.rstrip()
        if not line or line == "# EOF":
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped",
                ):
                    problems.append(f"line {ln}: malformed TYPE: {line!r}")
                else:
                    types[parts[2]] = parts[3]
            elif len(parts) >= 2 and parts[1] not in ("HELP", "TYPE", "UNIT"):
                problems.append(f"line {ln}: unknown comment directive: {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {ln}: unparseable sample: {line!r}")
            continue
        name, labels_part, value_str = m.group(1), m.group(2), m.group(3)
        labels = dict(_LABELS_RE.findall(labels_part or ""))
        base = name
        for suffix in ("_total", "_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                base = name[: -len(suffix)]
                break
        mtype = types.get(base)
        if mtype is None:
            problems.append(f"line {ln}: sample {name!r} has no preceding TYPE")
            continue
        if mtype == "counter" and not name.endswith("_total"):
            problems.append(f"line {ln}: counter sample {name!r} missing _total")
        if mtype == "histogram":
            key = (base, tuple(sorted((k, v) for k, v in labels.items() if k != "le")))
            if name.endswith("_bucket"):
                if "le" not in labels:
                    problems.append(f"line {ln}: histogram bucket missing le label")
                    continue
                le = math.inf if labels["le"] == "+Inf" else float(labels["le"])
                hist_buckets.setdefault(key, []).append((le, float(value_str)))
            elif name.endswith("_count"):
                hist_counts[key] = float(value_str)
    for (base, lbls), buckets in hist_buckets.items():
        les = [le for le, _ in buckets]
        cums = [c for _, c in buckets]
        if les != sorted(les):
            problems.append(f"{base}{dict(lbls)}: bucket le bounds not sorted")
        if any(b > a for a, b in zip(cums[1:], cums)):
            problems.append(f"{base}{dict(lbls)}: bucket counts not cumulative")
        if not les or not math.isinf(les[-1]):
            problems.append(f"{base}{dict(lbls)}: missing le=+Inf bucket")
        elif (base, lbls) in hist_counts and cums[-1] != hist_counts[(base, lbls)]:
            problems.append(f"{base}{dict(lbls)}: +Inf bucket != _count")
    return problems


# --------------------------------------------------------------------------
# Background /metrics endpoint
# --------------------------------------------------------------------------


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "fw-metrics/1"

    def do_GET(self):  # noqa: N802 (http.server API)
        registry = self.server._metrics_registry_fn()
        if self.path.split("?")[0] == "/metrics":
            body = render_openmetrics(registry).encode()
            ctype = "application/openmetrics-text; version=1.0.0; charset=utf-8"
        elif self.path.split("?")[0] == "/metrics.json":
            body = json.dumps(snapshot_json(registry), indent=2).encode()
            ctype = "application/json"
        else:
            self.send_error(404, "try /metrics or /metrics.json")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet: scrapes are not stdout events
        pass


class MetricsServer:
    """Daemon-thread HTTP scrape endpoint.

    ``port=0`` (default) binds an ephemeral port, read it back from
    ``.port`` / ``.url``. Context manager for scoped use::

        with MetricsServer(registry) as srv:
            ...solve...
            text = urllib.request.urlopen(srv.url).read()
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._registry = registry
        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        # late-bound so a server started before install_registry still scrapes
        self._httpd._metrics_registry_fn = (
            (lambda: self._registry) if registry is not None else get_registry
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._httpd.server_address[0]}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fw-metrics", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def scrape(url: str, timeout: float = 5.0) -> str:
    """GET an exposition endpoint (convenience for tests/smoke)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()
