"""Block-ELL storage of the feature-major design matrix (the reference's
``sparse/matrix.py``).

Features (columns of X = rows of the feature-major Xt) are grouped into
aligned blocks of ``block_size``, and every feature stores its nonzeros as
a fixed-width (ELL) row of ``nnz_max`` slots,

    values[b, t, k]  value of the k-th nonzero of feature b*block_size+t
    rows[b, t, k]    sample index of that nonzero

zero-padded past the feature's true nnz: a padded slot holds value 0 at
row 0, so gathers stay in bounds and scatter-adds change nothing. The
feature axis is zero-padded up to a whole number of blocks: a padded
feature scores exactly 0, and the solver masks indices >= p out of the
argmax.

``from_coo`` and ``from_dense`` are numpy copies of the reference's, so
the two packages hold bit-identical arrays for the same input;
``from_coo_torch`` builds the same arrays with tensor ops on any device
(the paper-size build on the card, 137 M triplets).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class SparseBlockMatrix:
    """Feature-major sparse design matrix in block-ELL layout.

    The logical shape is ``(p, m)``, the orientation of the dense ``Xt``,
    with ``p`` the true feature count (``values`` covers ``nblocks *
    block_size >= p`` features, the tail zero-padded).
    """

    values: torch.Tensor  # (nblocks, block_size, nnz_max) f32 (bf16 accepted for storage)
    rows: torch.Tensor  # (nblocks, block_size, nnz_max) int32 sample indices
    p: int  # true feature count
    m: int  # sample count
    block_size: int
    nnz_max: int  # per-feature nnz budget (ELL width)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.p, self.m)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nblocks(self) -> int:
        return self.values.shape[0]

    @property
    def p_padded(self) -> int:
        return self.nblocks * self.block_size

    @property
    def nbytes(self) -> int:
        """Storage footprint (values + row indices)."""
        slots = self.nblocks * self.block_size * self.nnz_max
        return slots * (self.values.element_size() + 4)

    def to(self, device) -> "SparseBlockMatrix":
        """The matrix on ``device`` (no copy when it is already there)."""
        return dataclasses.replace(self, values=self.values.to(device),
                                   rows=self.rows.to(device))

    def to_dense(self) -> torch.Tensor:
        """The dense feature-major ``Xt (p, m)``. Padded slots add +0.0, so
        they never clobber a real entry."""
        pp = self.p_padded
        feat = torch.arange(pp, device=self.device).repeat_interleave(self.nnz_max)
        flat = feat * self.m + self.rows.reshape(-1).long()
        dense = torch.zeros(pp * self.m, dtype=self.dtype, device=self.device)
        dense.index_add_(0, flat, self.values.reshape(-1))
        return dense.view(pp, self.m)[: self.p]

    @classmethod
    def from_coo(
        cls,
        sample_rows: np.ndarray,
        feature_cols: np.ndarray,
        vals: np.ndarray,
        shape: Tuple[int, int],
        *,
        block_size: int = 256,
        nnz_max: Optional[int] = None,
        dtype=np.float32,
    ) -> "SparseBlockMatrix":
        """Build from COO triplets in the (sample, feature) = (m, p)
        orientation of svmlight files, on the host. Duplicate coordinates
        are assumed absent. The nnz budget defaults to the densest
        feature's count; a larger one pads, a smaller one raises (entries
        are never dropped)."""
        m, p = shape
        sample_rows = np.asarray(sample_rows, np.int64)
        feature_cols = np.asarray(feature_cols, np.int64)
        vals = np.asarray(vals)
        if sample_rows.size and (sample_rows.min() < 0 or sample_rows.max() >= m):
            raise ValueError("sample row index out of range for shape")
        if feature_cols.size and (feature_cols.min() < 0 or feature_cols.max() >= p):
            raise ValueError("feature column index out of range for shape")
        counts = np.bincount(feature_cols, minlength=p)
        nnz_max = _nnz_budget(int(counts.max()) if counts.size else 0, nnz_max)

        nblocks = -(-p // block_size)
        pp = nblocks * block_size
        values = np.zeros((pp, nnz_max), dtype)
        rows = np.zeros((pp, nnz_max), np.int32)
        order = np.argsort(feature_cols, kind="stable")
        fc = feature_cols[order]
        starts = np.zeros(p + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(fc.size) - starts[fc]
        values[fc, slot] = vals[order].astype(dtype)
        rows[fc, slot] = sample_rows[order].astype(np.int32)
        return cls(
            values=torch.from_numpy(values.reshape(nblocks, block_size, nnz_max)),
            rows=torch.from_numpy(rows.reshape(nblocks, block_size, nnz_max)),
            p=p, m=m, block_size=block_size, nnz_max=nnz_max,
        )

    @classmethod
    def from_coo_torch(
        cls,
        sample_rows: torch.Tensor,
        feature_cols: torch.Tensor,
        vals: torch.Tensor,
        shape: Tuple[int, int],
        *,
        block_size: int = 256,
        nnz_max: Optional[int] = None,
    ) -> "SparseBlockMatrix":
        """``from_coo`` with tensor ops, on the triplets' device: a stable
        sort by feature, then slot = position - the feature's first
        position. On the CPU it gives ``from_coo``'s arrays bit for bit;
        the values keep ``vals``' dtype."""
        m, p = shape
        dev = vals.device
        sample_rows = sample_rows.to(dev)
        feature_cols = feature_cols.to(device=dev, dtype=torch.int64)
        if sample_rows.numel() and bool((sample_rows.min() < 0) | (sample_rows.max() >= m)):
            raise ValueError("sample row index out of range for shape")
        if feature_cols.numel() and bool((feature_cols.min() < 0) | (feature_cols.max() >= p)):
            raise ValueError("feature column index out of range for shape")
        counts = torch.bincount(feature_cols, minlength=p)
        nnz_max = _nnz_budget(int(counts.max()) if counts.numel() else 0, nnz_max)

        nblocks = -(-p // block_size)
        pp = nblocks * block_size
        fc, order = torch.sort(feature_cols, stable=True)
        starts = torch.zeros(p + 1, dtype=torch.int64, device=dev)
        starts[1:] = torch.cumsum(counts, 0)
        flat = fc * nnz_max + (torch.arange(fc.numel(), device=dev) - starts[fc])
        del fc, starts
        values = torch.zeros(pp * nnz_max, dtype=vals.dtype, device=dev)
        rows = torch.zeros(pp * nnz_max, dtype=torch.int32, device=dev)
        values[flat] = vals[order]
        rows[flat] = sample_rows[order].to(torch.int32)
        return cls(
            values=values.view(nblocks, block_size, nnz_max),
            rows=rows.view(nblocks, block_size, nnz_max),
            p=p, m=m, block_size=block_size, nnz_max=nnz_max,
        )

    @classmethod
    def from_dense(
        cls,
        Xt,
        *,
        block_size: int = 256,
        nnz_max: Optional[int] = None,
    ) -> "SparseBlockMatrix":
        """Convert a dense feature-major ``Xt (p, m)`` array (numpy or a
        CPU tensor)."""
        Xt = np.asarray(Xt)
        p, m = Xt.shape
        feat, samp = np.nonzero(Xt)
        return cls.from_coo(samp, feat, Xt[feat, samp], (m, p), block_size=block_size,
                            nnz_max=nnz_max, dtype=Xt.dtype)

    def astype(self, dtype: torch.dtype) -> "SparseBlockMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))

    def pad_geometry(self, *, nblocks: Optional[int] = None,
                     nnz_max: Optional[int] = None) -> "SparseBlockMatrix":
        """Grow the storage geometry to (nblocks, block_size, nnz_max) with
        zero padding; shrinking raises (entries are never dropped)."""
        nblocks = self.nblocks if nblocks is None else int(nblocks)
        nnz_max = self.nnz_max if nnz_max is None else int(nnz_max)
        if nblocks < self.nblocks or nnz_max < self.nnz_max:
            raise ValueError(
                f"pad_geometry cannot shrink ({self.nblocks}, {self.nnz_max})"
                f" -> ({nblocks}, {nnz_max})"
            )
        if nblocks == self.nblocks and nnz_max == self.nnz_max:
            return self
        pad = (0, nnz_max - self.nnz_max, 0, 0, 0, nblocks - self.nblocks)
        return dataclasses.replace(
            self,
            values=torch.nn.functional.pad(self.values, pad),
            rows=torch.nn.functional.pad(self.rows, pad),
            nnz_max=nnz_max,
        )

    def density(self) -> float:
        """Structural density: stored nonzeros over the logical p*m."""
        nnz = int(torch.count_nonzero(self.values))
        return nnz / float(max(1, self.p * self.m))


def _nnz_budget(required: int, nnz_max: Optional[int]) -> int:
    if nnz_max is None:
        return max(1, required)
    if required > nnz_max:
        raise ValueError(
            f"nnz budget {nnz_max} too small: densest feature has "
            f"{required} nonzeros (pass nnz_max>={required})"
        )
    return max(1, int(nnz_max))
