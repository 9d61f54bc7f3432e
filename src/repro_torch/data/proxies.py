"""Offline proxies for the paper's benchmark datasets (Table 1), the
reference's ``data/proxies.py``.

The datasets themselves (Pyrim, Triazines, E2006-tfidf, E2006-log1p) are
not shipped, so synthetic proxies match their published (m, p) and their
structure: sparse columns for the text datasets, dense correlated columns
for the QSAR ones.

* ``make_proxy``: a dense (m, p) ``Dataset``, refused above a memory
  budget (E2006-log1p at scale 1.0 would need ~270 GB);
* ``make_sparse_coo`` / ``make_sparse_proxy``: the text datasets as COO
  triplets and a block-ELL ``SparseBlockMatrix``, never densified. These
  are numpy copies of the reference's: the same seed gives the same
  triplets and arrays;
* ``make_sparse_wide_problem``: ``make_sparse_coo``'s recipe drawn on a
  device with a ``torch.Generator`` and assembled there
  (``SparseBlockMatrix.from_coo_torch``), for the published sizes (137 M
  triplets for E2006-log1p) that the host would build slowly.
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import Dataset, standardize
from repro_torch.sparse.matrix import SparseBlockMatrix

# Default dense-build budget (bytes); override per call or via env.
DENSE_BUDGET_ENV = "REPRO_DENSE_BUDGET_BYTES"
DEFAULT_DENSE_BUDGET = 2 << 30  # 2 GiB


class ProxySpec(NamedTuple):
    m: int
    t: int  # test examples
    p: int
    col_density: float  # fraction of nonzeros per predictor column
    n_relevant: int  # informative features in the generating model


# Published sizes (paper Table 1) with qualitative structure.
PROXY_SPECS: Dict[str, ProxySpec] = {
    "pyrim": ProxySpec(m=74, t=0, p=201_376, col_density=1.0, n_relevant=60),
    "triazines": ProxySpec(m=186, t=0, p=635_376, col_density=1.0, n_relevant=150),
    "e2006-tfidf": ProxySpec(m=16_087, t=3_308, p=150_360, col_density=0.01, n_relevant=150),
    "e2006-log1p": ProxySpec(m=16_087, t=3_308, p=4_272_227, col_density=0.002, n_relevant=300),
}


class SparseDataset(NamedTuple):
    """Sparse proxy: the feature-major block-ELL matrix and the targets.
    Columns have unit l2 norm (no centering: it would densify the matrix)
    and y is centered."""

    mat: SparseBlockMatrix
    y: np.ndarray  # (m,) float32, centered
    coef: Optional[np.ndarray]  # generating coefficients (pre-scaling)
    name: str


def dense_proxy_bytes(name: str, scale: float = 1.0, dtype_bytes: int = 4) -> int:
    """Estimated bytes of the dense (m+t, p) build ``make_proxy`` performs."""
    spec = PROXY_SPECS[name]
    m = max(32, int(spec.m * scale))
    t = int(spec.t * scale)
    p = max(256, int(spec.p * scale))
    return (m + t) * p * dtype_bytes


def _dense_budget(max_dense_bytes: Optional[int]) -> int:
    if max_dense_bytes is not None:
        return int(max_dense_bytes)
    return int(os.environ.get(DENSE_BUDGET_ENV, DEFAULT_DENSE_BUDGET))


def _sizes(spec: ProxySpec, scale: float):
    m = max(32, int(spec.m * scale))
    p = max(256, int(spec.p * scale))
    n_rel = max(8, int(spec.n_relevant * min(1.0, scale * 2)))
    return m, p, n_rel


def make_proxy(name: str, scale: float = 1.0, seed: int = 0,
               max_dense_bytes: Optional[int] = None) -> Dataset:
    """A dense proxy dataset. ``scale`` < 1 shrinks m, t and p uniformly;
    1.0 is the published size. Raises MemoryError (with the estimate) when
    the dense build would exceed ``max_dense_bytes`` (default
    $REPRO_DENSE_BUDGET_BYTES or 2 GiB)."""
    spec = PROXY_SPECS[name]
    budget = _dense_budget(max_dense_bytes)
    est = dense_proxy_bytes(name, scale)
    if est > budget:
        hint = (
            " Use make_sparse_proxy (sparse-native, no densification)."
            if spec.col_density < 1.0
            else " Lower `scale` or raise the budget."
        )
        raise MemoryError(
            f"dense build of {name!r} at scale={scale:g} needs ~{est:,} bytes "
            f"({est / 2**30:.2f} GiB) > budget {budget:,} bytes.{hint}"
        )
    m, p, n_rel = _sizes(spec, scale)
    t = int(spec.t * scale)

    rng = np.random.default_rng(seed)
    n = m + t
    if spec.col_density >= 1.0:
        # QSAR-like: dense, mildly correlated columns (product features).
        base = rng.standard_normal((n, max(16, p // 64))).astype(np.float32)
        mix = rng.standard_normal((base.shape[1], p)).astype(np.float32) / np.sqrt(
            base.shape[1]
        )
        X = base @ mix + 0.5 * rng.standard_normal((n, p)).astype(np.float32)
    else:
        # Text-like: sparse nonnegative counts, heavy-tailed.
        X = np.zeros((n, p), np.float32)
        nnz_per_row = max(4, int(spec.col_density * p))
        for i in range(n):
            idx = rng.choice(p, size=nnz_per_row, replace=False)
            X[i, idx] = rng.exponential(1.0, size=nnz_per_row).astype(np.float32)

    coef = np.zeros(p, np.float32)
    support = rng.choice(p, size=n_rel, replace=False)
    coef[support] = rng.standard_normal(n_rel).astype(np.float32) * 10.0
    y = X @ coef + 0.5 * rng.standard_normal(n).astype(np.float32)

    ds = Dataset(
        X=X[:m],
        y=y[:m].astype(np.float32),
        X_test=X[m:] if t else None,
        y_test=y[m:].astype(np.float32) if t else None,
        coef=coef,
        name=f"{name}-scale{scale:g}",
    )
    return standardize(ds)


def make_sparse_coo(m: int, p: int, col_density: float, n_relevant: int, seed: int = 0):
    """Text-like sparse regression triplets, never densified.

    Per row, ``int(col_density*p)`` feature slots are drawn with
    replacement and deduplicated, with exponential values; the response is
    accumulated by scatter from a sparse generating coefficient vector.
    Returns (rows, cols, vals, y, coef) with unit-norm columns and centered
    y."""
    rng = np.random.default_rng(seed)
    nnz_per_row = max(4, int(col_density * p))
    rows_l, cols_l = [], []
    for i in range(m):
        idx = np.unique(rng.integers(0, p, size=nnz_per_row))
        rows_l.append(np.full(idx.size, i, np.int64))
        cols_l.append(idx)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = rng.exponential(1.0, size=rows.size).astype(np.float32)

    # unit l2 column norms (no centering: keeps the matrix sparse)
    norm2 = np.zeros(p, np.float64)
    np.add.at(norm2, cols, vals.astype(np.float64) ** 2)
    norms = np.sqrt(norm2)
    norms[norms < 1e-12] = 1.0
    vals = (vals / norms[cols]).astype(np.float32)

    coef = np.zeros(p, np.float32)
    support = rng.choice(p, size=min(n_relevant, p), replace=False)
    coef[support] = rng.standard_normal(support.size).astype(np.float32) * 10.0
    y = np.zeros(m, np.float64)
    np.add.at(y, rows, (vals * coef[cols]).astype(np.float64))
    y += 0.05 * rng.standard_normal(m)
    y -= y.mean()
    return rows, cols, vals, y.astype(np.float32), coef


def make_sparse_proxy(name: str, scale: float = 1.0, seed: int = 0, block_size: int = 256,
                      nnz_max: Optional[int] = None) -> SparseDataset:
    """Sparse proxy for the text datasets (E2006-*): the block-ELL matrix
    built straight from ``make_sparse_coo``'s triplets on the host, memory
    O(nnz)."""
    spec = PROXY_SPECS[name]
    if spec.col_density >= 1.0:
        raise ValueError(f"{name!r} is a dense (QSAR-like) dataset; use make_proxy")
    m, p, n_rel = _sizes(spec, scale)
    rows, cols, vals, y, coef = make_sparse_coo(m, p, spec.col_density, n_rel, seed=seed)
    mat = SparseBlockMatrix.from_coo(rows, cols, vals, (m, p), block_size=block_size,
                                     nnz_max=nnz_max)
    return SparseDataset(mat=mat, y=y, coef=coef, name=f"{name}-sparse-scale{scale:g}")


def make_sparse_wide_problem(m: int, p: int, col_density: float, n_relevant: int,
                             seed: int = 0, device="cuda", block_size: int = 256,
                             nnz_max: Optional[int] = None):
    """``make_sparse_coo``'s recipe on ``device``, assembled there into a
    ``SparseBlockMatrix``: per row ``int(col_density*p)`` uniform feature
    draws with replacement, deduplicated; exponential values; unit column
    norms summed in f64; ``n_relevant`` coefficients N(0, 1) * 10; y by
    scatter in f64, plus N(0, 0.05^2) noise, centered.

    The draws come from a ``torch.Generator`` seeded with ``seed``, so they
    differ from ``make_sparse_coo``'s (the construction is the same, the
    numbers are not). At E2006-log1p's size (m = 16,087, p = 4,272,227,
    137 M triplets) the numpy version spends its time in ``np.add.at`` and a
    137 M-element argsort; this one sorts and scatters on the device.
    Returns ``(mat, y, coef)``: y (m,) f32 and coef (p,) f32 on ``device``.
    """
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    nnz_per_row = max(4, int(col_density * p))
    rows_per_draw = max(1, (1 << 24) // nnz_per_row)
    rows_l, cols_l = [], []
    for r0 in range(0, m, rows_per_draw):
        n = min(rows_per_draw, m - r0)
        draws = torch.randint(0, p, (n, nnz_per_row), generator=g, device=dev)
        draws = torch.sort(draws, dim=1).values
        keep = torch.ones_like(draws, dtype=torch.bool)
        keep[:, 1:] = draws[:, 1:] != draws[:, :-1]
        cols_l.append(draws[keep])
        rows_l.append(torch.arange(r0, r0 + n, dtype=torch.int32, device=dev)
                      .repeat_interleave(keep.sum(dim=1)))
    cols, rows = torch.cat(cols_l), torch.cat(rows_l)
    del cols_l, rows_l
    vals = torch.empty(cols.numel(), device=dev).exponential_(1.0, generator=g)
    mat = SparseBlockMatrix.from_coo_torch(rows, cols, vals, (m, p), block_size=block_size,
                                           nnz_max=nnz_max)
    del rows, cols, vals

    # unit l2 column norms over each feature's slots, in f64
    slots = mat.values.view(-1, mat.nnz_max)
    for chunk in slots.split(1 << 20):
        norms = chunk.double().square().sum(dim=1).sqrt()
        norms[norms < 1e-12] = 1.0
        chunk.copy_(chunk.double() / norms[:, None])

    coef = torch.zeros(p, dtype=torch.float32, device=dev)
    support = torch.randperm(p, generator=g, device=dev)[: min(n_relevant, p)]
    coef[support] = torch.randn(support.numel(), generator=g, device=dev) * 10.0
    # y = X coef: the support's few slots, summed on the host in slot order
    sup_vals = slots.index_select(0, support) * coef[support][:, None]
    sup_rows = mat.rows.view(-1, mat.nnz_max).index_select(0, support)
    y = torch.zeros(m, dtype=torch.float64)
    y.index_add_(0, sup_rows.reshape(-1).cpu(), sup_vals.reshape(-1).double().cpu())
    y = y.to(dev) + 0.05 * torch.randn(m, generator=g, device=dev, dtype=torch.float64)
    y -= y.mean()
    return mat, y.float(), coef
