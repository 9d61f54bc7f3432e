"""svmlight/libsvm text IO and .npz shard streaming (the reference's
``sparse/io.py``; the files are the same files).

Two interchange layers feed the sparse backend:

* ``load_svmlight`` / ``save_svmlight``: the text format the paper's real
  datasets (E2006-tfidf / E2006-log1p) ship in: one sample per line,
  ``label idx:val idx:val ...`` with 1-based indices by convention.
* ``write_shards`` / ``iter_shards`` / ``load_shards_as_matrix``: the
  coo-npz-v1 row-range shards (``rows`` int32 local, ``cols`` int64,
  ``vals``, ``y``, ``row_offset``) plus a JSON manifest with each file's
  sha256, so multi-GB datasets convert once and then load shard by shard
  out of core. Every read is verified against the manifest and retried
  with bounded backoff (``fw_shard_checksum_failures``,
  ``fw_shard_retries``); persistent damage raises ``ShardIntegrityError``.

The readers and writers are numpy copies of the reference's. The matrix
assembly makes the reference's two passes over the shards: the
per-feature counts on the host, then the block-ELL fill on ``device`` (the
card by default): each verified shard's triplets go to the device, are
sorted by feature (stably), and land in the slot ``cursor[feature] +
rank within the feature``, so the slot order is the reference's (by shard,
then by position in the shard).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer, traced
from repro_torch.resilience import faults as _faults
from repro_torch.sparse.matrix import SparseBlockMatrix, _nnz_budget

MANIFEST_NAME = "manifest.json"
SHARD_FORMAT = "coo-npz-v1"

# Bounded exponential backoff for checksum-failed shard reads: transient
# damage (a torn network-filesystem read, an injected byte flip) heals on
# re-read; persistent on-disk corruption exhausts the retries and raises.
SHARD_READ_RETRIES = 3
SHARD_RETRY_BASE_S = 0.05


class ShardIntegrityError(RuntimeError):
    """A shard file failed its manifest sha256 on every read attempt."""


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _shard_checksums(out_dir, names) -> Dict[str, str]:
    """sha256 of each just-written shard file, for the manifest."""
    sums = {}
    for name in names:
        with open(os.path.join(out_dir, name), "rb") as fh:
            sums[name] = _sha256_hex(fh.read())
    return sums


def _read_shard_bytes_verified(shard_dir, name: str, expected: Optional[str]) -> bytes:
    """Read one shard file, verify it against the manifest checksum, and
    retry with exponential backoff on mismatch. ``expected=None`` (a
    manifest without checksums) skips verification. The arrays are parsed
    from the verified buffer, so what was checked is what is used."""
    path = os.path.join(shard_dir, name)
    reg = obs_metrics.get_registry()
    for attempt in range(SHARD_READ_RETRIES + 1):
        with open(path, "rb") as fh:
            data = fh.read()
        data = _faults.maybe_corrupt_bytes(name, data)
        if expected is None or _sha256_hex(data) == expected:
            return data
        if reg is not None:
            reg.counter(
                "fw_shard_checksum_failures",
                "shard reads whose bytes failed the manifest sha256",
                ("shard",),
            ).inc(1, shard=name)
        if attempt < SHARD_READ_RETRIES:
            time.sleep(SHARD_RETRY_BASE_S * (2**attempt))
            if reg is not None:
                reg.counter(
                    "fw_shard_retries",
                    "checksum-failed shard reads retried with backoff",
                    ("shard",),
                ).inc(1, shard=name)
    raise ShardIntegrityError(
        f"shard {name!r} failed its manifest sha256 on {SHARD_READ_RETRIES + 1} read "
        "attempts: on-disk corruption; re-convert the dataset"
    )


def verify_shards(shard_dir, *, manifest: Optional[dict] = None) -> List[str]:
    """Names of shard files whose on-disk bytes fail the manifest sha256
    (empty list = healthy, or a manifest without checksums). Reads the
    disk directly, not through the fault-injection hook, so it reports the
    true on-disk state."""
    if manifest is None:
        manifest = read_manifest(shard_dir)
    sums = manifest.get("checksums")
    if not sums:
        return []
    bad = []
    for name in manifest["shards"]:
        try:
            with open(os.path.join(shard_dir, name), "rb") as fh:
                ok = _sha256_hex(fh.read()) == sums.get(name)
        except OSError:
            ok = False
        if not ok:
            bad.append(name)
    return bad


class COOData(NamedTuple):
    """COO triplets in (sample, feature) orientation plus targets."""

    rows: np.ndarray  # (nnz,) sample indices
    cols: np.ndarray  # (nnz,) feature indices
    vals: np.ndarray  # (nnz,) float32
    y: np.ndarray  # (m,) float32 labels/targets
    shape: Tuple[int, int]  # (m, p)


# --------------------------------------------------------------------------
# svmlight / libsvm text format
# --------------------------------------------------------------------------


@traced("sparse_io/load_svmlight", cat="io")
def load_svmlight(path, *, n_features: Optional[int] = None, zero_based="auto",
                  dtype=np.float32) -> COOData:
    """Parse an svmlight/libsvm text file into COO triplets.

    ``zero_based='auto'`` treats the file as 0-based only when a 0 index
    appears (the libsvm convention is 1-based): a 0-based file whose
    feature 0 has no nonzeros reads as 1-based, so pass ``zero_based``
    whenever the writer's convention is known. ``qid:`` tokens and ``#``
    comments are ignored. ``n_features`` widens p beyond the max seen
    index. This reader holds the full COO set in memory;
    ``convert_svmlight_to_shards`` streams one shard of rows at a time.
    """
    rows, cols, vals, y = [], [], [], []
    with open(path, "rt") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            y.append(float(parts[0]))
            r = len(y) - 1
            for tok in parts[1:]:
                if tok.startswith("qid:"):
                    continue
                i, v = tok.split(":")
                rows.append(r)
                cols.append(int(i))
                vals.append(float(v))
    rows_a = np.asarray(rows, np.int64)
    cols_a = np.asarray(cols, np.int64)
    vals_a = np.asarray(vals, dtype)
    if zero_based == "auto":
        zero_based = bool(cols_a.size) and int(cols_a.min()) == 0
    if not zero_based:
        cols_a = cols_a - 1
    if cols_a.size and cols_a.min() < 0:
        raise ValueError("negative feature index after base adjustment")
    p = int(cols_a.max()) + 1 if cols_a.size else 0
    if n_features is not None:
        if n_features < p:
            raise ValueError(f"n_features={n_features} < max index + 1 = {p}")
        p = n_features
    return COOData(rows_a, cols_a, vals_a, np.asarray(y, np.float32), (len(y), p))


@traced("sparse_io/save_svmlight", cat="io")
def save_svmlight(path, data: COOData, *, zero_based: bool = False) -> None:
    """Write COO triplets as svmlight text (1-based indices by default),
    sorted by (row, col)."""
    m, _ = data.shape
    order = np.lexsort((data.cols, data.rows))
    rows, cols, vals = data.rows[order], data.cols[order], data.vals[order]
    base = 0 if zero_based else 1
    starts = np.searchsorted(rows, np.arange(m + 1))
    with open(path, "wt") as fh:
        for r in range(m):
            feats = " ".join(
                f"{int(c) + base}:{float(v):.9g}"
                for c, v in zip(cols[starts[r]:starts[r + 1]], vals[starts[r]:starts[r + 1]])
            )
            fh.write(f"{float(data.y[r]):.9g} {feats}".rstrip() + "\n")


# --------------------------------------------------------------------------
# .npz row-range shards + manifest
# --------------------------------------------------------------------------


def _write_manifest(out_dir, m: int, p: int, rows_per_shard: int, names) -> str:
    manifest = {
        "format": SHARD_FORMAT,
        "m": int(m),
        "p": int(p),
        "rows_per_shard": int(rows_per_shard),
        "shards": names,
        "checksums": _shard_checksums(out_dir, names),
    }
    manifest_path = os.path.join(out_dir, MANIFEST_NAME)
    with open(manifest_path, "wt") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest_path


@traced("sparse_io/write_shards", cat="io")
def write_shards(out_dir, data: COOData, *, rows_per_shard: int = 4096) -> str:
    """Split a COO dataset into row-range .npz shards + a JSON manifest.

    Returns the manifest path. Shard k holds rows [k*rows_per_shard,
    (k+1)*rows_per_shard) with local row indices and its slice of y, so a
    consumer never needs more than one shard in memory. (The stable sort
    by row is linear on triplets already in row order.)
    """
    os.makedirs(out_dir, exist_ok=True)
    m, p = data.shape
    n_shards = max(1, -(-m // rows_per_shard))
    order = np.argsort(data.rows, kind="stable")
    rows, cols, vals = data.rows[order], data.cols[order], data.vals[order]
    bounds = np.searchsorted(rows, np.arange(n_shards + 1) * rows_per_shard)
    names = []
    for k in range(n_shards):
        lo_row = k * rows_per_shard
        hi_row = min(m, lo_row + rows_per_shard)
        sl = slice(bounds[k], bounds[k + 1])
        name = f"shard_{k:05d}.npz"
        np.savez(
            os.path.join(out_dir, name),
            rows=(rows[sl] - lo_row).astype(np.int32),
            cols=cols[sl].astype(np.int64),
            vals=vals[sl],
            y=data.y[lo_row:hi_row],
            row_offset=np.int64(lo_row),
        )
        names.append(name)
    return _write_manifest(out_dir, m, p, rows_per_shard, names)


@traced("sparse_io/convert_svmlight_to_shards", cat="io")
def convert_svmlight_to_shards(svm_path, out_dir, *, rows_per_shard: int = 4096,
                               zero_based: bool = False, n_features: Optional[int] = None,
                               dtype=np.float32) -> str:
    """Stream an svmlight text file straight into the shard layout, one
    shard of rows in memory at a time. ``zero_based`` must be stated
    (default: the libsvm 1-based convention). Returns the manifest path."""
    os.makedirs(out_dir, exist_ok=True)
    base = 0 if zero_based else 1
    names = []
    max_col = -1
    m = 0

    rows_l: list = []
    cols_l: list = []
    vals_l: list = []
    y_l: list = []

    def _flush():
        nonlocal rows_l, cols_l, vals_l, y_l
        k = len(names)
        name = f"shard_{k:05d}.npz"
        np.savez(
            os.path.join(out_dir, name),
            rows=np.asarray(rows_l, np.int32),
            cols=np.asarray(cols_l, np.int64),
            vals=np.asarray(vals_l, dtype),
            y=np.asarray(y_l, np.float32),
            row_offset=np.int64(k * rows_per_shard),
        )
        names.append(name)
        rows_l, cols_l, vals_l, y_l = [], [], [], []

    with open(svm_path, "rt") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            y_l.append(float(parts[0]))
            r_local = m % rows_per_shard
            m += 1
            for tok in parts[1:]:
                if tok.startswith("qid:"):
                    continue
                i, v = tok.split(":")
                c = int(i) - base
                if c < 0:
                    raise ValueError("negative feature index after base adjustment")
                max_col = max(max_col, c)
                rows_l.append(r_local)
                cols_l.append(c)
                vals_l.append(float(v))
            if m % rows_per_shard == 0:
                _flush()
    if y_l or not names:
        _flush()

    p = max_col + 1
    if n_features is not None:
        if n_features < p:
            raise ValueError(f"n_features={n_features} < max index + 1 = {p}")
        p = n_features
    return _write_manifest(out_dir, m, p, rows_per_shard, names)


def read_manifest(shard_dir) -> dict:
    with open(os.path.join(shard_dir, MANIFEST_NAME), "rt") as fh:
        manifest = json.load(fh)
    if manifest.get("format") != SHARD_FORMAT:
        raise ValueError(f"unknown shard format {manifest.get('format')!r}")
    return manifest


def iter_shards(shard_dir) -> Iterator[Tuple[COOData, int]]:
    """Stream (chunk, row_offset) pairs; chunk row ids are global."""
    manifest = read_manifest(shard_dir)
    yield from iter_shards_for_rows(shard_dir, 0, manifest["m"], manifest=manifest)


def shards_for_rows(manifest: dict, lo: int, hi: int) -> list:
    """Shard names overlapping the row range [lo, hi): manifest arithmetic
    (shard k holds rows [k*R, (k+1)*R)), no file IO."""
    if manifest.get("format") != SHARD_FORMAT:
        raise ValueError(f"unknown shard format {manifest.get('format')!r}")
    R = int(manifest["rows_per_shard"])
    names = manifest["shards"]
    lo = max(0, lo)
    hi = min(int(manifest["m"]), hi)
    if hi <= lo:
        return []
    first = lo // R
    last = -(-hi // R)  # ceil: the shard holding row hi-1, inclusive
    return names[first:last]


def iter_shards_for_rows(shard_dir, lo: int, hi: int, *,
                         manifest: Optional[dict] = None) -> Iterator[Tuple[COOData, int]]:
    """Stream only the shards overlapping rows [lo, hi) (global row ids,
    like ``iter_shards``); ``manifest`` skips the re-read when the caller
    already holds it."""
    if manifest is None:
        manifest = read_manifest(shard_dir)
    p = manifest["p"]
    checksums = manifest.get("checksums") or {}
    reg = obs_metrics.get_registry()
    for name in shards_for_rows(manifest, lo, hi):
        t0 = time.perf_counter()
        data = _read_shard_bytes_verified(shard_dir, name, checksums.get(name))
        with np.load(io.BytesIO(data)) as z:
            off = int(z["row_offset"])
            chunk = COOData(
                z["rows"].astype(np.int64) + off,
                z["cols"].astype(np.int64),
                z["vals"],
                z["y"],
                (manifest["m"], p),
            )
        if reg is not None:
            elapsed = time.perf_counter() - t0
            n_bytes = len(data)
            reg.counter("fw_shard_reads", "coo-npz-v1 shard files opened").inc(1)
            reg.counter("fw_shard_read_bytes", "on-disk bytes of shard files read").inc(n_bytes)
            reg.histogram(
                "fw_shard_read_seconds",
                "wall time per shard .npz open + array materialization",
            ).observe(elapsed)
            reg.histogram(
                "fw_shard_file_bytes",
                "on-disk size distribution of shard files read",
                buckets=obs_metrics.BYTES_BUCKETS,
            ).observe(float(n_bytes))
        yield chunk, off


@traced("sparse_io/load_shards", cat="io")
def load_shards(shard_dir) -> COOData:
    """Concatenate all shards back into one in-memory COO dataset."""
    manifest = read_manifest(shard_dir)
    chunks = [c for c, _ in iter_shards(shard_dir)]
    return COOData(
        np.concatenate([c.rows for c in chunks]),
        np.concatenate([c.cols for c in chunks]),
        np.concatenate([c.vals for c in chunks]),
        np.concatenate([c.y for c in chunks]),
        (manifest["m"], manifest["p"]),
    )


@traced("sparse_io/load_shards_as_matrix", cat="io")
def load_shards_as_matrix(shard_dir, *, block_size: int = 256, nnz_max: Optional[int] = None,
                          dtype: torch.dtype = torch.float32, device="cuda"):
    """Two-pass streaming assembly: shards -> ``(SparseBlockMatrix, y)`` on
    ``device`` (the card unless told otherwise).

    Pass 1 (span ``sparse_io/count_pass``) sums the per-feature nnz counts
    on the host (``np.bincount``), which sizes the ELL budget; pass 2
    (``sparse_io/fill_pass``) moves each verified shard's triplets to the
    device and fills the block-ELL slots there. Peak extra memory is one
    shard (and its sort) beside the output arrays. The arrays are the
    reference's, bit for bit, on any device.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to assemble the "
                           "matrix on the CPU")
    manifest = read_manifest(shard_dir)
    m, p = manifest["m"], manifest["p"]
    tracer = get_tracer()
    with tracer.span("sparse_io/count_pass", cat="io"):
        counts = np.zeros(p, np.int64)
        for chunk, _ in iter_shards(shard_dir):
            counts += np.bincount(chunk.cols, minlength=p)
    nnz_max = _nnz_budget(int(counts.max()) if p else 0, nnz_max)

    nblocks = -(-p // block_size)
    pp = nblocks * block_size
    with tracer.span("sparse_io/fill_pass", cat="io"):
        values = torch.zeros(pp * nnz_max, dtype=dtype, device=dev)
        rows = torch.zeros(pp * nnz_max, dtype=torch.int32, device=dev)
        y = torch.zeros(m, dtype=torch.float32, device=dev)
        cursor = torch.zeros(p, dtype=torch.int64, device=dev)
        for chunk, lo in iter_shards(shard_dir):
            y[lo:lo + chunk.y.shape[0]] = torch.from_numpy(chunk.y).to(dev)
            cs, order = torch.sort(torch.from_numpy(chunk.cols).to(dev), stable=True)
            n_col = torch.bincount(cs, minlength=p)
            first = torch.cumsum(n_col, 0) - n_col  # the feature's first position in cs
            flat = cs * nnz_max + cursor[cs] + (torch.arange(cs.numel(), device=dev) - first[cs])
            values[flat] = torch.from_numpy(chunk.vals).to(dev)[order].to(dtype)
            rows[flat] = torch.from_numpy(chunk.rows).to(dev)[order].to(torch.int32)
            cursor += n_col
    mat = SparseBlockMatrix(
        values=values.view(nblocks, block_size, nnz_max),
        rows=rows.view(nblocks, block_size, nnz_max),
        p=p, m=m, block_size=block_size, nnz_max=nnz_max,
    )
    return mat, y
