"""Per-iteration metric rings on the device (the reference's
``obs/telemetry.py``, on torch).

A ``TelemetryRing`` is a fixed-size buffer of per-iteration solver
records (winner index, step size, step-rule event code, sampled duality
gap, objective, stopping statistics, cumulative dot-product count),
carried on ``engine.EngineState.tel`` and filled inside the loop.
Telemetry is OFF by default (``FWConfig.telemetry is None``): no ring
exists and every recording site is skipped, so the default loop launches
what it launched before, bit for bit.

Overhead contract when ON: one record a step written on the device, with
no host read. On the kernels' backends the lasso's and the elastic-net's
step tail writes it inside its one launch, and a fused chunk's replay
writes its K records inside its one launch
(``kernels/step_tail``, ``kernels/fused_step``); elsewhere ``record``
writes it with a few plain scalar writes. A flush to the host sink
(``stream_to``) is one copy of the ring, made only when the ring holds
``capacity`` unflushed records (about to wrap) and once at the end of
the solve.

The cursor and ``flushed`` are host integers: the host knows every
record the loop writes (one a step, none for a frozen lane or a masked
fused step, an ``amend_last`` that does not advance), so a record's slot
``cursor % capacity`` and the flush test need no read of the device. A
lane ring (the batched engine's) has a leading lane axis, a host cursor
a lane, and ``dev_cursor``, the lanes' cursors on the device, which the
lane tail reads for each lane's slot and advances.

Storage: one int32 buffer of ``RING_WORDS * capacity`` words a ring, the
fields as rows of ``capacity`` words: ``k``, ``i_star``, ``event``,
``stall`` (int32), ``lam``, ``gap``, ``objective``, ``step_inf``
(float32 bits), then ``n_dots`` (int64, two words a record). The fields
are views of it (``ring.k``, ``ring.lam``, ...). Unlike the reference's
float32 count (exact only to 2^24, ROADMAP.md R3), ``n_dots`` is int64
and exact; an empty slot holds -1 there.

The ring wraps: with ``capacity = C`` the last C records survive;
``cursor`` counts ALL records ever written. ``ring_to_records`` gives the
chronological host-side view, with the reference's keys and dtypes but
``n_dots`` in int64.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

# step-rule event codes (ring ``event`` field)
EVENT_FW = 0  # classic Frank-Wolfe vertex step
EVENT_AWAY = 1  # away-step over the tracked active set
EVENT_PAIRWISE = 2  # pairwise mass transfer
EVENT_DROP = 3  # away/pairwise step that hit g_max: atom dropped exactly
EVENT_LAZY_HIT = 4  # lazy LMO served the step from the winner cache
EVENT_PARTAN = 5  # classic step + PARTAN extrapolation

EVENT_NAMES = ("fw", "away", "pairwise", "drop", "lazy-hit", "partan")


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Telemetry config, riding inside ``FWConfig``.

    Attributes:
      capacity: ring slots; the last ``capacity`` iterations survive.
      record_objective: record the oracle objective and the sampled FW
        duality gap per step (O(1) scalars for the lasso and the
        elastic-net, inside the step's tail kernel; one O(m) reduction for
        the logistic). When on, a fused chunk runs as K unfused steps (the
        fused kernel emits no per-step objective; the steps are the fused
        solve's bit for bit); with it off the fused kernel runs and its
        replay records each step's (i_star, lam, stall) with NaN objective
        and gap.
      stream_to: name of a host sink registered via ``register_sink`` to
        receive record batches when the ring is about to wrap and once at
        the end of the solve (sequential solves; the batched engine keeps
        its lane rings on the device and surfaces them on the result).
    """

    capacity: int = 256
    record_objective: bool = True
    stream_to: Optional[str] = None

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"telemetry capacity must be >= 1, got {self.capacity}")


# names of the record fields, in storage order
RECORD_FIELDS = (
    "k", "i_star", "event", "stall", "lam", "gap", "objective",
    "step_inf", "n_dots",
)
_INT_FIELDS = ("k", "i_star", "event", "stall")
_FLOAT_FIELDS = ("lam", "gap", "objective", "step_inf")
RING_WORDS = 10  # int32 words a record: 4 int32, 4 float32, 1 int64
# each field's first row of ``capacity`` words in the storage
FIELD_ROW = {name: i for i, name in enumerate(_INT_FIELDS + _FLOAT_FIELDS)}
FIELD_ROW["n_dots"] = 8


def _field(buf: torch.Tensor, name: str, capacity: int) -> torch.Tensor:
    """The ``(..., capacity)`` view of one field in a ring's storage."""
    row = FIELD_ROW[name]
    if name == "n_dots":
        return buf[..., row * capacity:(row + 2) * capacity].view(torch.int64)
    view = buf[..., row * capacity:(row + 1) * capacity]
    return view.view(torch.float32) if name in _FLOAT_FIELDS else view


def _np_field(buf: np.ndarray, name: str, capacity: int) -> np.ndarray:
    row = FIELD_ROW[name]
    if name == "n_dots":
        return buf[..., row * capacity:(row + 2) * capacity].view(np.int64)
    view = buf[..., row * capacity:(row + 1) * capacity]
    return view.view(np.float32) if name in _FLOAT_FIELDS else view


class TelemetryRing(NamedTuple):
    """The ring: host totals ``cursor`` and ``flushed`` (not modulo; a list
    of ints a lane for a lane ring) and the device storage ``buf``
    (``(RING_WORDS * C,)`` int32, ``(L, RING_WORDS * C)`` for lanes). The
    record fields are views of ``buf``, each ``(C,)`` (``(L, C)``)."""

    cursor: Any
    flushed: Any
    buf: torch.Tensor
    dev_cursor: Optional[torch.Tensor] = None  # lanes: (L,) int64 cursors on the device

    @property
    def capacity(self) -> int:
        return self.buf.shape[-1] // RING_WORDS

    def field(self, name: str) -> torch.Tensor:
        return _field(self.buf, name, self.capacity)

    k = property(lambda self: self.field("k"))
    i_star = property(lambda self: self.field("i_star"))
    event = property(lambda self: self.field("event"))
    stall = property(lambda self: self.field("stall"))
    lam = property(lambda self: self.field("lam"))
    gap = property(lambda self: self.field("gap"))
    objective = property(lambda self: self.field("objective"))
    step_inf = property(lambda self: self.field("step_inf"))
    n_dots = property(lambda self: self.field("n_dots"))

    @property
    def lanes(self) -> Optional[int]:
        return None if self.buf.dim() == 1 else self.buf.shape[0]

    def lane(self, lane: int) -> "TelemetryRing":
        """Lane ``lane`` of a lane ring, as a ring of its own (a view)."""
        return TelemetryRing(self.cursor[lane], self.flushed[lane], self.buf[lane])


def init_ring(spec: TelemetrySpec, device, lanes: Optional[int] = None) -> TelemetryRing:
    """An empty ring on ``device`` (``lanes`` of them stacked): ``k`` and
    ``i_star`` -1, ``event`` and ``stall`` 0, the floats NaN, ``n_dots`` -1."""
    c = spec.capacity
    shape = (RING_WORDS * c,) if lanes is None else (lanes, RING_WORDS * c)
    buf = torch.zeros(shape, dtype=torch.int32, device=device)
    for name in ("k", "i_star", "n_dots"):
        _field(buf, name, c).fill_(-1)
    for name in _FLOAT_FIELDS:
        _field(buf, name, c).fill_(float("nan"))
    if lanes is None:
        return TelemetryRing(0, 0, buf)
    return TelemetryRing([0] * lanes, [0] * lanes, buf,
                         torch.zeros(lanes, dtype=torch.int64, device=device))


def _set(dst: torch.Tensor, value) -> None:
    """One field of one record: a device copy of a tensor (cast to the
    field's dtype), or a fill with a host number; neither waits for the
    device."""
    if isinstance(value, torch.Tensor):
        dst.copy_(value.reshape(()))
    else:
        dst.fill_(value)


def write_record(buf: torch.Tensor, capacity: int, slot: int, **fields) -> None:
    """Write the given fields at ``slot`` of one ring's storage ``buf``:
    the plain record, a few scalar writes on the device."""
    for name, value in fields.items():
        _set(_field(buf, name, capacity)[slot], value)


def record(ring: TelemetryRing, lane: Optional[int] = None, **fields) -> TelemetryRing:
    """Write one record (every field of ``RECORD_FIELDS``) at the cursor's
    slot (wrapping) and advance the cursor; of lane ``lane`` for a lane
    ring (its device cursor advances too). The plain record: O(1) scalar
    writes, no host read."""
    missing = set(RECORD_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"a record needs every field; missing {sorted(missing)}")
    c = ring.capacity
    if lane is None:
        write_record(ring.buf, c, ring.cursor % c, **fields)
        return ring._replace(cursor=ring.cursor + 1)
    cursor = list(ring.cursor)
    write_record(ring.buf[lane], c, cursor[lane] % c, **fields)
    cursor[lane] += 1
    ring.dev_cursor[lane] += 1
    return ring._replace(cursor=cursor)


def amend_last(ring: TelemetryRing, **fields) -> TelemetryRing:
    """Overwrite fields of the most recent record in place (the cursor does
    NOT advance): used where a step's final statistics supersede what its
    inner classic step recorded (PARTAN), and for the objective of a step
    whose co-state was refreshed after its tail recorded."""
    c = ring.capacity
    write_record(ring.buf, c, (ring.cursor - 1) % c, **fields)
    return ring


def advance(ring: TelemetryRing, n: int = 1, lanes=None) -> TelemetryRing:
    """The host cursor after a kernel wrote ``n`` records (one lane), or
    after one record of each lane in ``lanes`` (a host list of bools)."""
    if lanes is None:
        return ring._replace(cursor=ring.cursor + n)
    return ring._replace(cursor=[c + 1 if a else c for c, a in zip(ring.cursor, lanes)])


def history_spec(spec: Optional[TelemetrySpec], n_iters: int) -> TelemetrySpec:
    """The spec ``solve_with_history`` runs under: capacity = n_iters
    (slot t IS iteration t, no wrap) with per-step objectives on; a
    caller-provided spec keeps its streaming sink."""
    base = spec if spec is not None else TelemetrySpec()
    return dataclasses.replace(
        base, capacity=max(int(n_iters), 1), record_objective=True
    )


def _records(buf: np.ndarray, capacity: int, cursor: int, n: int) -> Dict[str, np.ndarray]:
    start = cursor - n
    idx = (start + np.arange(n)) % capacity
    out = {name: _np_field(buf, name, capacity)[idx] for name in RECORD_FIELDS}
    out["record_index"] = start + np.arange(n)
    return out


def ring_to_records(ring: TelemetryRing, limit: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Chronological host-side view of the live ring contents: a dict of
    1-D numpy arrays (oldest surviving record first) plus the absolute
    ``record_index`` of each row; one copy of the ring to the host. A
    single ring only: take ``ring.lane(l)`` of a lane ring first."""
    if ring.lanes is not None:
        raise ValueError("ring_to_records takes one ring; pass ring.lane(l) of a lane ring")
    cursor, cap = int(ring.cursor), ring.capacity
    n = min(cursor, cap)
    if limit is not None:
        n = min(n, int(limit))
    return _records(ring.buf.cpu().numpy(), cap, cursor, n)


# --------------------------------------------------------------------------
# Host streaming sinks (flushes when the ring would wrap, and at the end)
# --------------------------------------------------------------------------

_SINKS: Dict[str, Callable[[Dict[str, np.ndarray]], None]] = {}


def register_sink(name: str, fn: Callable[[Dict[str, np.ndarray]], None]) -> None:
    """Register a host callable receiving record batches (the dict format
    of ``ring_to_records``) for ``TelemetrySpec(stream_to=name)``."""
    _SINKS[name] = fn


def unregister_sink(name: str) -> None:
    _SINKS.pop(name, None)


def stream_flush(ring: TelemetryRing, spec: Optional[TelemetrySpec], *,
                 final: bool) -> TelemetryRing:
    """Flush unstreamed records to the spec's host sink. ``final=False``
    flushes only when the ring is full of unflushed records (about to
    wrap), the loop-turn cadence; ``final=True`` flushes the remainder
    (end of solve, patience stop) and makes no empty batch. The test is
    on host integers; a flush is one copy of the ring to the host. A no-op
    when the spec has no sink."""
    if spec is None or spec.stream_to is None:
        return ring
    pending = ring.cursor - ring.flushed
    if not final and pending < spec.capacity:
        return ring
    fn = _SINKS.get(spec.stream_to)
    n = min(pending, spec.capacity)
    if fn is not None and n > 0:
        fn(_records(ring.buf.cpu().numpy(), spec.capacity, ring.cursor, n))
    return ring._replace(flushed=ring.cursor)
