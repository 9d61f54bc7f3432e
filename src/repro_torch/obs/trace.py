"""Host-side span tracing (the reference's ``obs/trace.py``, ported by
copy: it imports nothing but the standard library).

A ``Tracer`` collects nested wall-clock spans, instant markers, and an
aggregate counter table, and emits them in the Chrome/Perfetto
``trace_event`` JSON format (the ``{"traceEvents": [...]}`` container
with ``ph: "X"`` complete events), so a solver run can be dropped
straight into https://ui.perfetto.dev or chrome://tracing.

Placement contract: spans measure HOST-side phases (path-driver grid
points, dispatch to completion). The port's loop is eager, so a span
closes when the host reaches its end, which precedes the device's end
unless the span's body waits for the device (the path driver's point
span closes after the point's objective is read back). The
per-iteration story lives in the telemetry ring
(``repro_torch.obs.telemetry``), not here.

There is always an active tracer: ``get_tracer()`` returns the tracer
installed by the innermost ``use_tracer(...)`` context, falling back to
a process-global default, so instrumentation points never need a
None-check and ``utils.timing.timed`` always has a sink.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

_VALID_PH = {"B", "E", "X", "i", "I", "C", "M", "b", "e", "n", "s", "t", "f"}


class Tracer:
    """Collects trace events; thread-safe appends, one timebase per
    instance (microseconds since construction)."""

    def __init__(self, name: str = "repro"):
        self.name = name
        self.events: List[dict] = []
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._add(
            {"name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
             "ts": 0, "args": {"name": name}}
        )

    # -- low-level ---------------------------------------------------------
    def _add(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        return threading.get_ident() & 0xFFFF

    # -- recording ---------------------------------------------------------
    @contextmanager
    def span(self, name: str, cat: str = "solver", **args: Any):
        """Nested wall-clock span -> one ``ph: "X"`` complete event."""
        ts = self._now_us()
        try:
            yield self
        finally:
            self._add(
                {"name": name, "cat": cat, "ph": "X", "ts": ts,
                 "dur": max(self._now_us() - ts, 0.0), "pid": self._pid,
                 "tid": self._tid(), "args": dict(args)}
            )

    def complete(self, name: str, t0: float, dur: float, cat: str = "solver",
                 **args: Any) -> None:
        """Record an already-measured span; ``t0`` is a
        ``time.perf_counter()`` reading, ``dur`` seconds."""
        self._add(
            {"name": name, "cat": cat, "ph": "X",
             "ts": max((t0 - self._t0) * 1e6, 0.0), "dur": max(dur, 0.0) * 1e6,
             "pid": self._pid, "tid": self._tid(), "args": dict(args)}
        )

    def instant(self, name: str, cat: str = "solver", **args: Any) -> None:
        self._add(
            {"name": name, "cat": cat, "ph": "i", "s": "t",
             "ts": self._now_us(), "pid": self._pid, "tid": self._tid(),
             "args": dict(args)}
        )

    def counter(self, name: str, value: float = 1.0, cat: str = "counter") -> None:
        """Accumulate into the aggregate counter table (and emit a ``C``
        event so the running value shows as a Perfetto counter track)."""
        with self._lock:
            total = self.counters.get(name, 0.0) + value
            self.counters[name] = total
            self.events.append(
                {"name": name, "cat": cat, "ph": "C", "ts": self._now_us(),
                 "pid": self._pid, "tid": 0, "args": {"value": total}}
            )

    # -- aggregation / output ----------------------------------------------
    def counter_table(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

    def span_table(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate: {name: {count, total_s, mean_s}}."""
        agg: Dict[str, Dict[str, float]] = {}
        with self._lock:
            events = list(self.events)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            row = agg.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += ev.get("dur", 0.0) / 1e6
        for row in agg.values():
            row["mean_s"] = row["total_s"] / max(row["count"], 1)
        return agg

    def to_chrome(self) -> dict:
        """The Chrome/Perfetto ``trace_event`` JSON object."""
        with self._lock:
            events = [dict(ev) for ev in self.events]
            counters = dict(self.counters)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"tracer": self.name, "counters": counters},
        }

    def save(self, path) -> str:
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wt") as fh:
            json.dump(self.to_chrome(), fh)
        return path


# --------------------------------------------------------------------------
# Active-tracer plumbing
# --------------------------------------------------------------------------

_default_tracer = Tracer("repro-default")
_stack: List[Tracer] = []
_stack_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The innermost ``use_tracer`` tracer, else the process default."""
    with _stack_lock:
        return _stack[-1] if _stack else _default_tracer


@contextmanager
def use_tracer(tracer: Tracer):
    """Install ``tracer`` as the active sink for the with-block."""
    with _stack_lock:
        _stack.append(tracer)
    try:
        yield tracer
    finally:
        with _stack_lock:
            _stack.remove(tracer)


def traced(name: Optional[str] = None, cat: str = "solver") -> Callable:
    """Decorator: run the function under a span on the active tracer."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with get_tracer().span(label, cat=cat):
                return fn(*a, **kw)

        return wrapper

    return deco


# --------------------------------------------------------------------------
# Perfetto / Chrome trace_event schema validation
# --------------------------------------------------------------------------


def validate_chrome_trace(obj) -> List[str]:
    """Validate a trace object (or already-serialized JSON string) against
    the Chrome ``trace_event`` schema subset Perfetto loads. Returns a
    list of error strings — empty means loadable."""
    errors: List[str] = []
    if isinstance(obj, (str, bytes)):
        try:
            obj = json.loads(obj)
        except json.JSONDecodeError as e:
            return [f"not valid JSON: {e}"]
    if isinstance(obj, list):
        events = obj  # the bare-array container format is also accepted
    elif isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level object has no 'traceEvents' array"]
    else:
        return [f"trace must be an object or array, got {type(obj).__name__}"]

    open_begins: Dict[tuple, int] = {}
    for n, ev in enumerate(events):
        where = f"event[{n}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _VALID_PH:
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing/non-string name")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"{where}: missing/non-numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs numeric dur >= 0")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: args must be an object")
        track = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            open_begins[track] = open_begins.get(track, 0) + 1
        elif ph == "E":
            if open_begins.get(track, 0) <= 0:
                errors.append(f"{where}: E event without matching B")
            else:
                open_begins[track] -= 1
    for track, n_open in open_begins.items():
        if n_open:
            errors.append(f"track {track}: {n_open} unclosed B event(s)")
    try:
        json.dumps(events)
    except (TypeError, ValueError) as e:
        errors.append(f"events not JSON-serializable: {e}")
    return errors
