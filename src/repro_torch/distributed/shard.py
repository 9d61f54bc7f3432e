"""Mesh placement for the FW design matrix (the reference's
``distributed/shard.py``), on ``torch.distributed``.

The mesh is a process group of ``n_data * n_model`` ranks. Rank r sits at
the coordinates ``(r // n_model, r % n_model)``, ``jax.make_mesh``'s
row-major order, so each rank's tile is the reference's mesh cell. One
sharding vocabulary over the ``("data", "model")`` axes:

    dense Xt (p, m)      rank (d, mo) holds the tile (p_local, m_local):
                         the features [mo * p_local, (mo + 1) * p_local)
                         and the samples [d * m_local, (d + 1) * m_local)
    sparse block-ELL     rank (d, mo) holds a LOCAL SparseBlockMatrix of
                         nb_local blocks: its feature block range's
                         nonzeros that fall in its sample slice, with LOCAL
                         row indices
    y (m,)               the rank's (m_local,) slice
    beta, ColStats       replicated (O(p) a rank)

Feature and sample axes zero-pad up to equal per-rank shapes: padded
features score exactly 0 and never win the argmax (global index >= p),
padded samples carry y = 0 and all-zero matrix entries, so every dot they
touch adds exactly 0 (the logistic oracle masks its loss on y != 0). The
ELL budget is the global max over the cells, so every rank shares one
width; with one data slice the cells are pure block slices of the input
matrix (the same slots in the same order), which keeps a uniform-sampling
lasso run bit for bit the single-device one.

A ``ShardedOperand`` holds only this rank's tile, on the card unless the
caller passes another device (the tests pass the CPU). The mesh's
collectives are ``all_reduce(SUM)`` on the operand's device: NCCL on the
card, gloo on the CPU (and, where the caller builds the group so, on CUDA
tensors: gloo takes them for ``all_reduce`` and ``broadcast``).

``load_sharded_matrix`` maps the coo-npz-v1 row-range shards
(``sparse/io.py``) onto the mesh: a rank opens only the shards that
overlap its sample slice (``sparse.io.shards_for_rows``).
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.solver_config import DistSpec
from repro_torch.sparse import io as sparse_io
from repro_torch.sparse.matrix import SparseBlockMatrix

# every group the mesh makes fails a collective after this long rather than
# hang (init_process_group's own timeout is the caller's)
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ``(n_data, n_model)`` mesh of ranks: the default group (``world``),
    this rank's data group (the ranks of its model coordinate, which split
    the samples) and its model group (the ranks of its data coordinate,
    which split the features)."""

    n_data: int
    n_model: int
    rank: int
    world: object
    data_group: object
    model_group: object
    backend: str

    @property
    def coords(self) -> Tuple[int, int]:
        return self.rank // self.n_model, self.rank % self.n_model

    def axis(self, name: str):
        """``(group, size)`` of the axis ``"world"`` (both), ``"data"`` or
        ``"model"``."""
        if name == "data":
            return self.data_group, self.n_data
        if name == "model":
            return self.model_group, self.n_model
        if name == "world":
            return self.world, self.n_data * self.n_model
        raise ValueError(f"no mesh axis {name!r}: 'world', 'data' or 'model'")


def fw_mesh(n_data: int = 1, n_model: Optional[int] = None) -> Mesh:
    """The ``(n_data, n_model)`` mesh over the initialized default group
    (``torch.distributed.init_process_group``, world size ``n_data *
    n_model``); with only ``n_data`` given, "model" takes the rest of the
    world. Every rank must call it, in the same order as any other group it
    makes. Each subgroup gets the timeout ``DEFAULT_TIMEOUT_S``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "fw_mesh needs torch.distributed's default group: call "
            "torch.distributed.init_process_group(backend, init_method=..., world_size=..., "
            "rank=...) on every rank first"
        )
    world = dist.get_world_size()
    if n_model is None:
        n_model = world // n_data
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) needs {n_data * n_model} ranks, the "
                         f"default group has {world}")
    rank = dist.get_rank()
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    d, mo = rank // n_model, rank % n_model
    data_group = model_group = None
    # every rank makes every group, in one order
    for c in range(n_model):
        g = dist.new_group([dd * n_model + c for dd in range(n_data)], timeout=timeout)
        if c == mo:
            data_group = g
    for r in range(n_data):
        g = dist.new_group([r * n_model + cc for cc in range(n_model)], timeout=timeout)
        if r == d:
            model_group = g
    return Mesh(n_data, n_model, rank, dist.group.WORLD, data_group, model_group,
                dist.get_backend())


def mesh_spec(mesh: Mesh) -> DistSpec:
    """The ``DistSpec`` of a mesh: its shape and the reference's axis
    names."""
    return DistSpec(n_data=mesh.n_data, n_model=mesh.n_model)


def check_device(mesh: Mesh, device: torch.device) -> torch.device:
    """The operand's device, checked against the mesh's backend: NCCL
    reduces CUDA tensors only; gloo reduces CPU tensors, and CUDA ones only
    where torch has CUDA. No other backend is taken."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to place the "
                           "operand on the CPU (a gloo mesh)")
    if mesh.backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL mesh reduces CUDA tensors only, not {device}")
    if mesh.backend not in ("nccl", "gloo"):
        raise ValueError(f"the mesh's backend {mesh.backend!r} is neither NCCL nor gloo")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh operand lives on the card or the CPU, not {device}")
    return device


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedOperand:
    """This rank's tile of a mesh-placed (design matrix, targets) pair and
    the static geometry, what ``repro_torch.distributed.driver`` solves on.

    Exactly one of the dense ``Xt`` (the ``(p_local, m_local)`` tile) and
    the sparse ``mat`` (the local ``SparseBlockMatrix`` of ``nb_local``
    blocks, ``m_local`` samples) is set. ``p``/``m`` are the true global
    sizes; ``y`` is the rank's ``(m_local,)`` slice.
    """

    mesh: Mesh
    spec: DistSpec
    p: int
    m: int
    m_local: int
    y: torch.Tensor
    Xt: Optional[torch.Tensor] = None
    mat: Optional[SparseBlockMatrix] = None
    block_size: int = 0
    nnz_max: int = 0
    nb_local: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return self.tile.dtype

    @property
    def device(self) -> torch.device:
        return self.y.device

    @property
    def layout(self) -> str:
        return "dense" if self.Xt is not None else "sparse"

    @property
    def tile(self):
        """The local matrix the engine runs on: the dense tile or the local
        ``SparseBlockMatrix``."""
        return self.Xt if self.Xt is not None else self.mat

    @property
    def values(self) -> torch.Tensor:
        return self.mat.values

    @property
    def rows(self) -> torch.Tensor:
        return self.mat.rows

    @property
    def p_local(self) -> int:
        if self.Xt is not None:
            return self.Xt.shape[0]
        return self.nb_local * self.block_size

    @property
    def off(self) -> int:
        """The global index of the tile's first feature."""
        return self.mesh.coords[1] * self.p_local

    @property
    def geom(self) -> tuple:
        return (self.layout, self.p, self.m, self.m_local, self.p_local, self.block_size,
                self.nnz_max, self.nb_local)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _resolve_nnz_budget(required: int, nnz_max: Optional[int]) -> int:
    """The global ELL budget: the densest (cell, feature) count by default;
    an explicit budget that is too small raises (entries are never dropped,
    the ``SparseBlockMatrix.from_coo`` rule)."""
    if nnz_max is None:
        nnz_max = max(1, required)
    elif required > nnz_max:
        raise ValueError(
            f"nnz budget {nnz_max} too small: densest (cell, feature) has {required} nonzeros "
            f"(pass nnz_max>={required})"
        )
    return max(1, int(nnz_max))


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _slice_pad(a, lo: int, hi: int, n: int, device, axis_len: int):
    """Entries [lo, hi) of ``a``'s first axis as a tensor of ``n`` on
    ``device``, zero past ``axis_len``; ``a`` itself (no copy) when it is
    the whole axis on that device."""
    if lo == 0 and hi >= axis_len and n == axis_len and isinstance(a, torch.Tensor) \
            and a.device == device:
        return a.contiguous()
    part = a[lo:min(hi, axis_len)]
    out = torch.zeros((n,) + tuple(part.shape[1:]), dtype=_as_tensor(part[:0], "cpu").dtype,
                      device=device)
    out[:part.shape[0]] = _as_tensor(part, device)
    return out


def _place_y(y, spec: DistSpec, mesh: Mesh, m: int, m_loc: int, device) -> torch.Tensor:
    d = mesh.coords[0]
    return _slice_pad(y, d * m_loc, (d + 1) * m_loc, m_loc, device, m)


def shard_dense(Xt, y, mesh: Mesh, *, device="cuda") -> ShardedOperand:
    """Place a dense feature-major ``(p, m)`` matrix (numpy or a tensor) on
    the mesh: this rank's tile of ``(ceil(p / n_model), ceil(m / n_data))``,
    zero-padded past ``p`` and ``m``, on ``device``. A one-rank mesh given a
    tensor on that device keeps it (no copy)."""
    dev = check_device(mesh, device)
    spec = mesh_spec(mesh)
    p, m = Xt.shape
    p_loc, m_loc = _ceil_div(p, spec.n_model), _ceil_div(m, spec.n_data)
    d, mo = mesh.coords
    if spec.n_data == 1 and spec.n_model == 1:
        tile = _as_tensor(Xt, dev).contiguous()
    else:
        rows = _slice_pad(Xt, mo * p_loc, (mo + 1) * p_loc, p_loc, "cpu" if not isinstance(
            Xt, torch.Tensor) else Xt.device, p)
        cols = rows[:, d * m_loc:min((d + 1) * m_loc, m)]
        tile = torch.zeros((p_loc, m_loc), dtype=cols.dtype, device=dev)
        tile[:, :cols.shape[1]] = cols.to(dev)
    return ShardedOperand(mesh=mesh, spec=spec, p=p, m=m, m_local=m_loc,
                          y=_place_y(y, spec, mesh, m, m_loc, dev), Xt=tile)


def _local_mat(values, rows, p_loc: int, m_loc: int, bs: int, nnz: int) -> SparseBlockMatrix:
    return SparseBlockMatrix(values=values, rows=rows, p=p_loc, m=m_loc, block_size=bs,
                             nnz_max=nnz)


def _assemble_cells(samp, feat, vals, m: int, p: int, spec: DistSpec, block_size: int,
                    nnz_max: Optional[int], dtype, d_keep: int, mo_keep: int):
    """COO triplets -> the block-ELL arrays of the cell ``(d_keep,
    mo_keep)``, with LOCAL rows (the reference's ``_assemble_cells``, one
    cell kept): the budget is the densest (cell, feature) count over every
    cell, and slot order within a feature is the stable input order, as
    ``SparseBlockMatrix.from_coo``'s. Returns ``(values, rows, m_local,
    nb_local, nnz_max)``, the arrays ``(nb_local, block_size, nnz_max)``."""
    m_loc = _ceil_div(m, spec.n_data)
    nb_loc = _ceil_div(_ceil_div(p, block_size), spec.n_model)
    p_cell = nb_loc * block_size
    n_cells_feat = spec.n_model * p_cell
    d = samp // m_loc
    key = d * n_cells_feat + feat
    counts = np.bincount(key, minlength=spec.n_data * n_cells_feat)
    nnz_max = _resolve_nnz_budget(int(counts.max()) if counts.size else 0, nnz_max)
    keep = (d == d_keep) & (feat // p_cell == mo_keep)
    k_keep = key[keep]
    order = np.argsort(k_keep, kind="stable")
    k_s = k_keep[order]
    # a feature's slots: its entries' positions past its first one
    first = np.searchsorted(k_s, k_s, side="left")
    slot = np.arange(k_s.size) - first
    f_loc = (k_s % n_cells_feat) - mo_keep * p_cell
    values = np.zeros((p_cell, nnz_max), dtype)
    rows_out = np.zeros((p_cell, nnz_max), np.int32)
    values[f_loc, slot] = vals[keep][order].astype(dtype)
    rows_out[f_loc, slot] = (samp[keep][order] - d_keep * m_loc).astype(np.int32)
    shape = (nb_loc, block_size, nnz_max)
    return values.reshape(shape), rows_out.reshape(shape), m_loc, nb_loc, nnz_max


def shard_sparse(mat: SparseBlockMatrix, y, mesh: Mesh, *, nnz_max: Optional[int] = None,
                 device="cuda") -> ShardedOperand:
    """Place a ``SparseBlockMatrix`` on the mesh (this rank's cell).

    With one data slice the cell is a pure BLOCK SLICE of the input arrays,
    the same slots in the same order (a view, when the matrix already lies
    on ``device`` with a whole number of blocks a rank), which keeps the
    scores' bits. With ``n_data > 1`` the nonzeros re-bucket by (sample
    slice, feature range) as the reference's COO assembler does (stored
    zeros, which carry nothing, are dropped)."""
    dev = check_device(mesh, device)
    spec = mesh_spec(mesh)
    p, m = mat.shape
    bs = mat.block_size
    d, mo = mesh.coords
    if spec.n_data == 1:
        if nnz_max is not None and nnz_max < mat.nnz_max:
            raise ValueError(
                f"nnz budget {nnz_max} too small: densest (cell, feature) has {mat.nnz_max} "
                f"nonzeros (pass nnz_max>={mat.nnz_max})"
            )
        nb_loc = _ceil_div(mat.nblocks, spec.n_model)
        padded = mat.pad_geometry(nblocks=spec.n_model * nb_loc, nnz_max=nnz_max)
        sl = slice(mo * nb_loc, (mo + 1) * nb_loc)
        values = padded.values[sl].to(dev).contiguous()
        rows = padded.rows[sl].to(dev).contiguous()
        return ShardedOperand(mesh=mesh, spec=spec, p=p, m=m, m_local=m,
                              y=_place_y(y, spec, mesh, m, m, dev),
                              mat=_local_mat(values, rows, nb_loc * bs, m, bs, padded.nnz_max),
                              block_size=bs, nnz_max=padded.nnz_max, nb_local=nb_loc)
    if mat.dtype == torch.bfloat16:
        raise TypeError("re-bucketing a bf16 matrix across sample slices is not supported; "
                        "shard the f32 matrix and cast the tile")
    vals_np = mat.values.detach().cpu().numpy().reshape(-1, mat.nnz_max)
    rows_np = mat.rows.detach().cpu().numpy().reshape(-1, mat.nnz_max)
    feat, slot = np.nonzero(vals_np)
    keep = feat < p
    feat, slot = feat[keep], slot[keep]
    values, rows, m_loc, nb_loc, nnz = _assemble_cells(
        rows_np[feat, slot].astype(np.int64), feat.astype(np.int64), vals_np[feat, slot], m, p,
        spec, bs, nnz_max, vals_np.dtype, d, mo)
    local = _local_mat(torch.from_numpy(values).to(dev), torch.from_numpy(rows).to(dev),
                       nb_loc * bs, m_loc, bs, nnz)
    return ShardedOperand(mesh=mesh, spec=spec, p=p, m=m, m_local=m_loc,
                          y=_place_y(y, spec, mesh, m, m_loc, dev), mat=local, block_size=bs,
                          nnz_max=nnz, nb_local=nb_loc)


def _global_max(mesh: Mesh, value: int, device) -> int:
    """The largest of the ranks' ``value``: one all_reduce(SUM) of a
    world-long buffer in which each rank writes its own entry."""
    buf = torch.zeros(mesh.n_data * mesh.n_model, dtype=torch.float64, device=device)
    buf[mesh.rank] = float(value)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.world)
    return int(buf.max().item())


def load_sharded_matrix(shard_dir, mesh: Mesh, *, block_size: int = 256,
                        nnz_max: Optional[int] = None, dtype: torch.dtype = torch.float32,
                        device="cuda") -> ShardedOperand:
    """coo-npz-v1 shards -> this rank's cell, reading only the shards that
    overlap its sample slice (``sparse.io.iter_shards_for_rows``). Two
    streaming passes as the reference's: the per-(cell, feature) counts of
    the slice size the ELL budget (the ranks' largest, through one
    ``all_reduce``), then the fill pass scatters each shard chunk's entries
    of this rank's feature range into its cell, the reference's cell arrays
    bit for bit."""
    dev = check_device(mesh, device)
    spec = mesh_spec(mesh)
    manifest = sparse_io.read_manifest(shard_dir)
    m, p = int(manifest["m"]), int(manifest["p"])
    m_loc = _ceil_div(m, spec.n_data)
    nb_loc = _ceil_div(_ceil_div(p, block_size), spec.n_model)
    p_cell = nb_loc * block_size
    n_cells_feat = spec.n_model * p_cell
    d, mo = mesh.coords
    lo, hi = d * m_loc, min(m, (d + 1) * m_loc)

    counts = np.zeros(n_cells_feat, np.int64)
    y_dtype = np.float32
    for chunk, _ in sparse_io.iter_shards_for_rows(shard_dir, lo, hi, manifest=manifest):
        y_dtype = chunk.y.dtype  # the stored target dtype
        within = (chunk.rows >= lo) & (chunk.rows < hi)
        counts += np.bincount(chunk.cols[within], minlength=n_cells_feat)
    required = _global_max(mesh, int(counts.max()) if counts.size else 0, dev)
    nnz_max = _resolve_nnz_budget(required, nnz_max)

    values = np.zeros((p_cell, nnz_max), np.float32)
    rows_out = np.zeros((p_cell, nnz_max), np.int32)
    y = np.zeros(m_loc, y_dtype)
    cursor = np.zeros(p_cell, np.int64)
    f0 = mo * p_cell
    for chunk, off in sparse_io.iter_shards_for_rows(shard_dir, lo, hi, manifest=manifest):
        r0, r1 = max(off, lo), min(off + chunk.y.shape[0], hi)
        if r1 > r0:
            y[r0 - lo:r1 - lo] = chunk.y[r0 - off:r1 - off]
        within = (chunk.rows >= lo) & (chunk.rows < hi) & (chunk.cols >= f0) \
            & (chunk.cols < f0 + p_cell)
        cols = chunk.cols[within] - f0
        order = np.argsort(cols, kind="stable")
        cs = cols[order]
        uniq, first, cnt = np.unique(cs, return_index=True, return_counts=True)
        local = np.arange(cs.size) - np.repeat(first, cnt)
        slot = cursor[cs] + local
        values[cs, slot] = chunk.vals[within][order]
        rows_out[cs, slot] = (chunk.rows[within][order] - lo).astype(np.int32)
        cursor[uniq] += cnt
    shape = (nb_loc, block_size, nnz_max)
    local = _local_mat(torch.from_numpy(values.reshape(shape)).to(device=dev, dtype=dtype),
                       torch.from_numpy(rows_out.reshape(shape)).to(dev), p_cell, m_loc,
                       block_size, nnz_max)
    return ShardedOperand(mesh=mesh, spec=spec, p=p, m=m, m_local=m_loc,
                          y=torch.from_numpy(y).to(dev), mat=local, block_size=block_size,
                          nnz_max=nnz_max, nb_local=nb_loc)
