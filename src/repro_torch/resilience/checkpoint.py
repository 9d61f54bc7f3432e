"""Path-level checkpoint/resume (the reference's
``resilience/checkpoint.py``).

Packs the path drivers' loop state (the completed ``PathPoint`` list, the
path's sampler seed, the warm-start carry vector and the lane-pruning
total) into the atomic checkpoint layout of ``checkpoint.manager`` (tmp
dir + fsync + rename, per-group sha256 digests), and restores it for
``fw_path(..., resume_from=)`` / ``fw_path_batched(..., resume_from=)``.

The port's path state holds no PRNG key: a point's (or lane chunk's)
sampler is a pure function of ``(seed, index)`` (``sampler_fn(g)``,
``lane_sampler_fn(c)``). So ``POS_GROUP`` stores the ``seed`` where the
reference stores ``key``/``key_typed``, and ``load_path_checkpoint``
returns it in the key's place. With the warm start a pure function of the
carried alpha, a run killed at any point and resumed from its last
checkpoint replays the remaining points bit for bit.

The nnz coefficient vectors are stored ragged: one concatenated value /
index array plus per-point lengths. The manager widens a bfloat16 carry
to float32 on disk; the path driver casts it back to the design's dtype.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt_manager

PATH_GROUP = "path_points"
POS_GROUP = "path_pos"


def pack_points(points) -> Dict[str, np.ndarray]:
    """PathPoint list -> flat dict of arrays (manager-serializable)."""
    if points:
        idx_cat = np.concatenate([np.asarray(pt.alpha_nnz_idx, np.int64) for pt in points])
        val_cat = np.concatenate([np.asarray(pt.alpha_nnz_val) for pt in points])
    else:
        idx_cat = np.zeros(0, np.int64)
        val_cat = np.zeros(0, np.float32)
    return {
        "reg": np.asarray([pt.reg for pt in points], np.float64),
        "objective": np.asarray([pt.objective for pt in points], np.float64),
        "l1": np.asarray([pt.l1 for pt in points], np.float64),
        "gap": np.asarray([pt.gap for pt in points], np.float64),
        "seconds": np.asarray([pt.seconds for pt in points], np.float64),
        "active": np.asarray([pt.active for pt in points], np.int64),
        "iterations": np.asarray([pt.iterations for pt in points], np.int64),
        "n_dots": np.asarray([pt.n_dots for pt in points], np.int64),
        "nnz_len": np.asarray([np.asarray(pt.alpha_nnz_idx).shape[0] for pt in points],
                              np.int64),
        "nnz_idx": idx_cat,
        "nnz_val": val_cat,
    }


def unpack_points(flat: Dict[str, np.ndarray]) -> list:
    from repro_torch.core.path import PathPoint  # lazy: core.path imports us

    lens = np.asarray(flat["nnz_len"], np.int64)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    points = []
    for i in range(lens.shape[0]):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        points.append(
            PathPoint(
                reg=float(flat["reg"][i]),
                objective=float(flat["objective"][i]),
                l1=float(flat["l1"][i]),
                active=int(flat["active"][i]),
                iterations=int(flat["iterations"][i]),
                n_dots=int(flat["n_dots"][i]),
                seconds=float(flat["seconds"][i]),
                alpha_nnz_idx=np.asarray(flat["nnz_idx"][lo:hi], np.int64),
                alpha_nnz_val=np.asarray(flat["nnz_val"][lo:hi]),
                gap=float(flat["gap"][i]),
            )
        )
    return points


def save_path_checkpoint(directory, index: int, seed: int, carry, points,
                         saved_iters: int = 0, *, keep: int = 3) -> None:
    """Atomic snapshot at a grid-point / lane-chunk boundary.

    ``index`` is the next point (or chunk) to run, ``seed`` the path's
    sampler seed, ``carry`` the warm-start alpha the next point starts from
    (a tensor or array)."""
    pos = {
        "next": np.int64(index),
        "seed": np.int64(seed),
        "carry": carry,
        "saved": np.int64(saved_iters),
    }
    ckpt_manager.save_checkpoint(
        directory, index, {POS_GROUP: pos, PATH_GROUP: pack_points(points)}
    )
    ckpt_manager.prune_checkpoints(directory, keep=keep)


def load_path_checkpoint(directory):
    """Latest valid path checkpoint, or None.

    Returns ``(next_index, seed, carry, points, saved_iters)``, ``carry`` a
    CPU tensor as stored (a bfloat16 carry comes back widened to float32)."""
    loaded = ckpt_manager.load_latest_raw(directory)
    if loaded is None:
        return None
    _, state = loaded
    pos = state[POS_GROUP]
    points = unpack_points(state[PATH_GROUP])
    return (int(pos["next"]), int(pos["seed"]), torch.from_numpy(pos["carry"]), points,
            int(pos["saved"]))
