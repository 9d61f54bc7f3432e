"""Seeded, deterministic fault injection (the reference's
``resilience/faults.py``, on the port's state).

The harness is a stack of :class:`FaultPlan` objects installed with the
``inject`` context manager. Production code calls the tiny hook
functions below at its fault sites; with no plan installed every hook is
a constant-time no-op, so the harness costs nothing outside tests. With a
plan installed, each hook consults the plan's deterministic spec list:
seeded byte flips, NaN/Inf state corruption, kills and delays all replay
bit-identically for a fixed ``REPRO_FAULT_SEED`` (or an explicit
``seed=``), and one seed picks the same poisoned element as the
reference's plan does (the same ``numpy`` generator calls).

Fault sites and their ``kind``:

  * ``shard_corrupt``: ``maybe_corrupt_bytes`` flips bytes of a shard
    file read (``sparse/io.py``) so the manifest checksum catches it;
  * ``co_nan`` / ``beta_nan``: ``maybe_corrupt_state`` poisons the
    oracle co-state / coefficient vector between guarded chunks (the
    watchdog's trip wire, ``resilience/guards.py``);
  * ``kill``: ``check_kill`` raises :class:`InjectedKill` at a path grid
    point / lane chunk (``core/path.py``), exercising checkpoint/resume;
  * ``delay``: ``maybe_delay`` sleeps inside a distributed dispatch
    (the distributed driver, ROADMAP.md Queue 1 item 13).

Matching: every hook call increments a per-``(kind, site)`` occurrence
counter; a spec fires when its kind matches, its ``site`` filter matches
(empty = any), the occurrence index equals ``at`` (or ``at < 0`` = any),
and the spec has firings left (``count``, one-shot by default, which is
what lets a bounded retry heal the fault). Fired events are logged on the
plan and counted in the metrics registry (``fw_faults_injected``).

Import-light on purpose: torch/numpy and the metrics plane only; the
engine imports nothing from here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics

KINDS = ("shard_corrupt", "co_nan", "beta_nan", "kill", "delay")

ENV_SEED = "REPRO_FAULT_SEED"


class InjectedKill(RuntimeError):
    """Raised by ``check_kill``: simulates a preempted host mid-path."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault to inject.

    Attributes:
      kind: one of :data:`KINDS`.
      at: occurrence index (per ``(kind, site)`` hook-call counter) to
        fire at; ``-1`` fires on any occurrence (bounded by ``count``).
      site: site-name filter; empty matches every site of the kind
        (a shard file name for ``shard_corrupt``, ``"path_point"`` /
        ``"path_chunk"`` for ``kill``).
      value: poison payload for ``co_nan`` / ``beta_nan`` (default NaN).
      count: number of firings before the spec is spent (1 = one-shot,
        the default: retries then see clean behavior and heal).
      seconds: sleep duration for ``delay``.
      n_bytes: bytes to flip for ``shard_corrupt`` (0 = size-scaled).
    """

    kind: str
    at: int = 0
    site: str = ""
    value: float = float("nan")
    count: int = 1
    seconds: float = 0.0
    n_bytes: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")


class FaultPlan:
    """A seeded, ordered set of faults plus the firing log."""

    def __init__(self, specs, seed: Optional[int] = None):
        if seed is None:
            seed = int(os.environ.get(ENV_SEED, "0"))
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.specs: List[FaultSpec] = list(specs)
        self._remaining: List[int] = [s.count for s in self.specs]
        self._seen: Dict[Tuple[str, str], int] = {}
        self.events: List[dict] = []

    def fired(self, kind: Optional[str] = None) -> List[dict]:
        """Events fired so far (optionally filtered by kind)."""
        if kind is None:
            return list(self.events)
        return [e for e in self.events if e["kind"] == kind]

    def _observe(self, kind: str, site: str) -> None:
        reg = obs_metrics.get_registry()
        if reg is not None:
            reg.counter(
                "fw_faults_injected",
                "faults injected by the resilience test harness",
                ("kind", "site"),
            ).inc(1, kind=kind, site=site or "any")

    def fire(self, kind: str, site: str) -> List[FaultSpec]:
        """Match and consume the specs firing at this hook call."""
        idx = self._seen.get((kind, site), 0)
        self._seen[(kind, site)] = idx + 1
        hits = []
        for i, spec in enumerate(self.specs):
            if spec.kind != kind or self._remaining[i] <= 0:
                continue
            if spec.site and spec.site != site:
                continue
            if spec.at >= 0 and spec.at != idx:
                continue
            self._remaining[i] -= 1
            self.events.append({"kind": kind, "site": site, "at": idx})
            self._observe(kind, site)
            hits.append(spec)
        return hits


_PLANS: List[FaultPlan] = []


def active_plan() -> Optional[FaultPlan]:
    return _PLANS[-1] if _PLANS else None


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Install ``plan`` for the dynamic extent of the with-block."""
    _PLANS.append(plan)
    try:
        yield plan
    finally:
        _PLANS.remove(plan)


# --------------------------------------------------------------------------
# Hook functions (no-ops with no active plan)
# --------------------------------------------------------------------------


def maybe_corrupt_bytes(site: str, data: bytes) -> bytes:
    """Shard-read corruption site: flip seeded byte positions of one read
    so the coo-npz-v1 manifest checksum catches the damage."""
    plan = active_plan()
    if plan is None:
        return data
    hits = plan.fire("shard_corrupt", site)
    if not hits or not data:
        return data
    buf = bytearray(data)
    for spec in hits:
        n = spec.n_bytes or max(1, len(buf) // 4096)
        pos = plan.rng.integers(0, len(buf), size=n)
        for q in pos:
            buf[q] ^= 0xFF
    return bytes(buf)


def _poison_leaf(leaf: torch.Tensor, value: float, rng) -> torch.Tensor:
    """A new tensor: ``leaf`` with one element set to ``value`` (the
    reference's ``.at[q].set``). ``leaf`` itself is never written, so a
    snapshot that shares it keeps its values."""
    q = int(rng.integers(0, leaf.shape[0]))
    bad = leaf.clone()
    bad[q] = value
    return bad


def maybe_corrupt_state(state, index_unused: int = 0):
    """Numerical-corruption site between guarded chunks: poison one entry
    of the co-state (``co_nan``: the first floating co field with
    ``ndim >= 1`` in the co NamedTuple's field order, the residual of
    ``LassoCo``) or of beta (``beta_nan``). ``state`` is an
    ``engine.EngineState``; returns it (possibly) poisoned."""
    plan = active_plan()
    if plan is None:
        return state
    for spec in plan.fire("co_nan", "engine_state"):
        co = state.co
        for name, leaf in zip(co._fields, co):
            if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 and leaf.is_floating_point():
                co = co._replace(**{name: _poison_leaf(leaf, spec.value, plan.rng)})
                break
        state = state._replace(co=co)
    for spec in plan.fire("beta_nan", "engine_state"):
        state = state._replace(beta=_poison_leaf(state.beta, spec.value, plan.rng))
    return state


def check_kill(site: str, index_hint: int = 0) -> None:
    """Kill site: raise :class:`InjectedKill` when a kill spec fires. The
    hook-call occurrence order gives the grid/chunk index semantics (the
    hook runs once per grid point / chunk, in order)."""
    plan = active_plan()
    if plan is None:
        return
    if plan.fire("kill", site):
        raise InjectedKill(f"injected kill at {site}[{index_hint}]")


def maybe_delay(site: str) -> None:
    """Straggler site: sleep when a delay spec fires (the distributed
    dispatch timeout's fixture)."""
    plan = active_plan()
    if plan is None:
        return
    for spec in plan.fire("delay", site):
        time.sleep(spec.seconds)

