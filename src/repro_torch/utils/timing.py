"""Wall-clock timing helpers used by benchmarks and the runtime monitor.

``timed`` no longer prints to stdout by default: every timed block lands
on the active ``repro_torch.obs.trace`` tracer as a completed ``"timed"`` span
(so benchmark phases show up in the same Perfetto artifact as the solver
spans), and ``sink`` optionally ALSO accumulates into a ``Timer`` or a
legacy ``{label: seconds}`` dict. Pass ``verbose=True`` for the old
print behavior — interleaving timings with CSV rows on stdout is now an
explicit opt-in, not the default.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from repro_torch.obs import trace as obs_trace


@dataclass
class Timer:
    """Accumulating timer. ``with timer:`` adds elapsed seconds to .total."""

    total: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def add(self, seconds: float, count: int = 1) -> "Timer":
        self.total += seconds
        self.count += count
        return self

    def merge(self, other: "Timer") -> "Timer":
        """Fold another Timer into this one — benchmarks aggregate
        per-arm timers with this instead of hand-rolled float dicts."""
        return self.add(other.total, other.count)


@contextmanager
def timed(label: str, sink=None, verbose: bool = False):
    """Time a block onto the active tracer (a ``ph:"X"`` span, cat
    ``"timed"``). ``sink`` may be a ``Timer`` or a dict mapping label ->
    accumulated seconds (the legacy shape)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    obs_trace.get_tracer().complete(label, t0, dt, cat="timed")
    if isinstance(sink, Timer):
        sink.add(dt)
    elif sink is not None:
        sink[label] = sink.get(label, 0.0) + dt
    if verbose:
        print(f"[timed] {label}: {dt:.4f}s")
