"""K6: the setup pass over the block-ELL layout (paper §4.2),

    zty[f]    = sum_k values[f, k] * y[rows[f, k]]
    znorm2[f] = sum_k values[f, k]^2

for every feature f < p, in one sweep over the stored slots, f32 or bf16
storage, f32 out. The padded tail features are not computed (the
reference computes and slices them off).

Replaces the Pallas kernel ``sparse_colstats_fused`` at
``src/repro/kernels/sparse_colstats/sparse_colstats.py:55`` (entry at :44).

Bound on an H100: bytes. The sweep must read every value slot of the p
features (the padding is found only by reading it), the row of each
stored nonzero, and write two floats per feature: p*nnz_max*4 + nnz*4 +
2*p*4 + m*4 bytes. At the E2006-log1p size (p = 4,272,227, nnz_max 66,
137.3 M nonzeros, m = 16,087, f32) that is about 1.71 GB, about 0.51 ms
at 3.35 TB/s.

Design: a streaming kernel that reads the row slots of padding not at
all, one block of 32 warps per SM. The features come in tiles of 64 (32
where that leaves too few stages), whole 16-byte units of values and of
rows; each block of the persistent grid stages y in shared memory once,
then takes every grid-th tile in turn, with one ``__syncthreads`` a tile:

- a tile's values arrive by one bulk asynchronous copy (Hopper's TMA,
  tracked by an mbarrier) into a ring of value stages, started by one
  thread ``stages - lag - 1`` tiles ahead;
- when they have landed, the block fetches the tile's row slots 16 bytes
  (4 slots) at a time with ``cp.async`` into a ring of ``lag + 1`` row
  slots, but only a chunk beside which a value is stored: a chunk of
  padding is zero-filled without a read (row 0, as a padded slot holds;
  its zero values add exact zeros). At the E2006-log1p size about half
  the row bytes are padding;
- ``lag`` tiles later warp k takes, for every feature of the tile, the
  partial that lane k of a warp summing the feature in ``slot_dot``'s
  order would hold (slots k, k+32, ...), into shared memory; one tile
  later a thread per feature and sum adds the 32 partials in
  ``warp_sum``'s butterfly order and writes them, coalesced. The sums are
  therefore bitwise those of a warp summing the feature from global
  memory (as the kernel still does for its last features; for finite y),
  without a warp's 10 dependent shuffles per feature or its idle lanes
  on the slots past 64.

``plan`` picks y's staging, the tile, the rows' lag (2 if that leaves
three value tiles in flight, else 1) and the value stages (at most 8)
within the 224 KB of dynamic shared memory a block may take: y (rounded
to 128 bytes), the value stages, the row slots and two buffers of
partials. At the E2006-log1p size (f32): y 64,384 bytes, tiles of 64
features, 5 value stages (3 in flight), lag 1. Past the m at which that
does not fit, y is read through L2; past an nnz_max at which a ring of
32-feature tiles does not fit (about 330 slots in f32), there is no ring
and every feature is summed from global memory, a warp a feature, as are
the last ``p % tile_feats`` features.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (values, rows, y, zty, zn2, p, nnz_max, m, tile_feats, stages, lag, y_bytes, dtype, stream)
_ARGTYPES = [_PTR] * 5 + [_I64] + [_I32] * 7 + [_PTR]

SMEM_BYTES = 224 * 1024  # OPTIN_SMEM_BYTES of csrc/common.cuh
MAX_STAGES = 8
# (tile_feats, the fewest value tiles in flight worth taking it with), larger first
TILINGS = ((64, 2), (32, 1))
PART_BYTES = 2 * 2 * 33 * 4  # a feature's two buffers of 33 (dot, sq) lane partials


class Plan(NamedTuple):
    tile_feats: int  # features a tile, a multiple of 32; 0: no ring
    stages: int  # value stages; the rows have lag + 1 slots
    lag: int  # tiles between a tile's row fetch and its partials
    y_bytes: int  # shared memory for y (0: read through L2)

    def smem_bytes(self, nnz_max: int, elem_bytes: int) -> int:
        slots = self.tile_feats * nnz_max
        return (self.y_bytes + self.stages * slots * elem_bytes + (self.lag + 1) * slots * 4
                + self.tile_feats * PART_BYTES)


def plan(m: int, nnz_max: int, elem_bytes: int) -> Plan:
    """The kernel's tiling for y of length ``m`` and ``nnz_max`` slots of
    ``elem_bytes`` (4 or 2) a feature: y staged if it fits, then the
    larger tile if enough value tiles can be in flight beside it, the rows
    two tiles behind their values if that leaves three value tiles in
    flight (else one), and as many value stages as fit (at most 8)."""
    y_bytes = -(-4 * m // 128) * 128
    for yb in (y_bytes, 0):
        for feats, fewest in TILINGS:
            for lag in (2, 1):
                rest = Plan(feats, 0, lag, yb).smem_bytes(nnz_max, elem_bytes)
                stages = min(MAX_STAGES, (SMEM_BYTES - rest) // (feats * nnz_max * elem_bytes))
                if stages - lag - 1 >= (3 if lag == 2 else fewest):
                    return Plan(feats, stages, lag, yb)
    return Plan(0, 0, 0, y_bytes if y_bytes <= SMEM_BYTES else 0)


def sparse_colstats_plain(values, rows, y, p: int):
    """The plain PyTorch version (the XLA branch of the reference's
    ``sparse/ops.py::sparse_colstats``): f32 sums, the tail sliced off."""
    vals = values.float()
    gathered = y.float().index_select(0, rows.reshape(-1)).view(rows.shape)
    zty = (vals * gathered).sum(dim=2).reshape(-1)[:p]
    znorm2 = (vals * vals).sum(dim=2).reshape(-1)[:p]
    return zty, znorm2


def sparse_colstats(values: torch.Tensor, rows: torch.Tensor, y: torch.Tensor, p: int):
    """``(zty, znorm2)``, each ``(p,)`` f32. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises: ``values`` and
    ``rows`` must start on 16-byte boundaries, as every array the port
    allocates does)."""
    if values.dim() != 3 or rows.shape != values.shape or y.dim() != 1:
        raise ValueError(
            f"need values and rows (nblocks, bs, nnz_max) and y (m,), got "
            f"{tuple(values.shape)}, {tuple(rows.shape)}, {tuple(y.shape)}"
        )
    if not 0 <= p <= values.shape[0] * values.shape[1]:
        raise ValueError(f"p = {p} outside the {values.shape[0] * values.shape[1]} features")
    if values.device.type == "cpu":
        return sparse_colstats_plain(values, rows, y, p)
    if rows.dtype != torch.int32:
        raise TypeError(f"the row slots must be int32, got {rows.dtype}")
    yf = y.float().contiguous()
    dev = _build.require_cuda(values, rows, yf)
    if values.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError("sparse_colstats needs values and rows on 16-byte boundaries")
    zty = torch.empty(p, dtype=torch.float32, device=dev)
    zn2 = torch.empty(p, dtype=torch.float32, device=dev)
    if p == 0:
        return zty, zn2
    code = _build.dtype_code(values)
    nnz_max = values.shape[2]
    pl = plan(yf.numel(), nnz_max, values.element_size())
    fn = _build.function("sparse_colstats", "sparse_colstats_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), rows.data_ptr(), yf.data_ptr(), zty.data_ptr(),
                 zn2.data_ptr(), p, nnz_max, yf.numel(), *pl, code, _build.stream(dev))
        sparse_colstats.launches += 1
    _build.check("sparse_colstats", err, "sparse_colstats")
    return zty, zn2


sparse_colstats.launches = 0
