"""EWMA step monitoring and path-driver lane progress (the reference's
``obs/monitor.py``, ported by copy).

``StepMonitor`` is the straggler/heartbeat detector: EWMA step-time tracking, straggler flagging when a step
exceeds ``straggler_factor`` x the EWMA, and a JSON heartbeat file a
supervisor can watch. The clock is injectable so straggler logic is
testable without sleeps.

``LaneProgressMonitor`` attaches the same EWMA machinery to the batched
path driver's chunk cadence and keeps the per-lane story the driver's
aggregate result discards: per-lane iteration counts, the freeze point
of each early-converged lane, and the lane-iterations saved by pruning.
Summaries land on the active tracer as counters + instant events, so a
traced ``fw_path_batched`` run shows its lane behavior in the same
artifact as its spans.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclass
class StepMonitor:
    ewma_alpha: float = 0.1
    straggler_factor: float = 3.0  # step > factor * ewma => flag
    heartbeat_path: Optional[Path] = None
    clock: Callable[[], float] = time.perf_counter

    ewma: float = 0.0
    last_step_time: float = 0.0
    stragglers: List[int] = field(default_factory=list)
    _t0: float = field(default=0.0, repr=False)
    step: int = 0

    def begin(self):
        self._t0 = self.clock()

    def end(self) -> bool:
        """Record a step; returns True if this step was a straggler."""
        dt = self.clock() - self._t0
        self.last_step_time = dt
        self.step += 1
        is_straggler = False
        if self.ewma > 0 and dt > self.straggler_factor * self.ewma:
            self.stragglers.append(self.step)
            is_straggler = True
        self.ewma = dt if self.ewma == 0 else (
            self.ewma_alpha * dt + (1 - self.ewma_alpha) * self.ewma
        )
        reg = obs_metrics.get_registry()
        if reg is not None:
            # metrics-plane bridge: monitored-step durations + straggler
            # totals land in the registry alongside the tracer artifacts
            reg.histogram(
                "fw_monitor_step_seconds",
                "durations of StepMonitor-wrapped units (path points, "
                "lane chunks)",
            ).observe(dt)
            reg.gauge(
                "fw_monitor_step_ewma_seconds",
                "EWMA of monitored step durations (straggler baseline)",
            ).set(self.ewma)
            if is_straggler:
                reg.counter(
                    "fw_monitor_stragglers",
                    "monitored steps exceeding straggler_factor x EWMA",
                ).inc(1)
        if self.heartbeat_path is not None:
            self.heartbeat_path.write_text(
                json.dumps(
                    {
                        "step": self.step,
                        "t": time.time(),
                        "step_time": dt,
                        "ewma": self.ewma,
                        "straggler": is_straggler,
                        "stragglers": self.stragglers,
                    }
                )
            )
        return is_straggler


@dataclass
class LaneProgressMonitor:
    """Per-lane progress of one batched-path run (``fw_path_batched``)."""

    max_iters: int
    chunk_monitor: StepMonitor = field(default_factory=StepMonitor)
    chunks: List[dict] = field(default_factory=list)

    def begin_chunk(self):
        self.chunk_monitor.begin()

    def end_chunk(self, chunk_index: int, deltas, iterations, saved_iters: int,
                  converged) -> dict:
        """Record one lane chunk. ``iterations``/``converged`` are the
        per-lane values off the batched SolveResult; a lane that stopped
        before the chunk's slowest lane froze at ``iterations[i]`` — its
        freeze point — and was spared ``max(iters) - iters[i]`` lane
        iterations."""
        straggler = self.chunk_monitor.end()
        iters = [int(v) for v in iterations]
        longest = max(iters) if iters else 0
        rec = {
            "chunk": int(chunk_index),
            "seconds": self.chunk_monitor.last_step_time,
            "straggler": straggler,
            "deltas": [float(d) for d in deltas],
            "lane_iters": iters,
            "freeze_at": [it if it < longest else None for it in iters],
            "lane_saved": [longest - it for it in iters],
            "converged": [bool(c) for c in converged],
            "saved_iters": int(saved_iters),
        }
        self.chunks.append(rec)
        tracer = obs_trace.get_tracer()
        tracer.counter("path/lane_chunks", 1)
        tracer.counter("path/saved_iters", int(saved_iters))
        tracer.instant(
            "fw_path_batched/chunk", cat="path", chunk=rec["chunk"],
            lane_iters=iters, lane_saved=rec["lane_saved"],
            straggler=straggler,
        )
        reg = obs_metrics.get_registry()
        if reg is not None:
            reg.counter(
                "fw_monitor_lane_chunks", "batched-path lane chunks observed"
            ).inc(1)
            n_frozen = sum(1 for f in rec["freeze_at"] if f is not None)
            if n_frozen:
                reg.counter(
                    "fw_monitor_frozen_lanes",
                    "lanes that froze before their chunk's slowest lane",
                ).inc(n_frozen)
            if saved_iters:
                reg.counter(
                    "fw_monitor_saved_iterations",
                    "lane-iterations pruned, as seen by the lane monitor",
                ).inc(int(saved_iters))
        return rec

    def summary(self) -> dict:
        lane_iters = [it for c in self.chunks for it in c["lane_iters"]]
        saved = sum(c["saved_iters"] for c in self.chunks)
        return {
            "chunks": len(self.chunks),
            "lanes": len(lane_iters),
            "total_lane_iters": sum(lane_iters),
            "saved_iters": saved,
            "mean_chunk_seconds": self.chunk_monitor.ewma,
            "straggler_chunks": list(self.chunk_monitor.stragglers),
            "frozen_lanes": sum(
                1 for c in self.chunks for f in c["freeze_at"] if f is not None
            ),
        }
