"""Fault-tolerant checkpointing (the reference's ``checkpoint/manager.py``).

  * atomic commits: write to a temp dir, fsync, rename; a crash mid-save
    never corrupts the latest checkpoint;
  * full logical arrays are saved, on the host, so a checkpoint restores
    on any device;
  * rotation with retention, resume-from-latest;
  * an async save thread: the caller hands over a host copy and goes on
    while the previous checkpoint serializes.

A state is a dict of named groups; a group is a tree of nested dicts,
NamedTuples, lists and tuples whose leaves are tensors or numpy arrays
(None leaves are skipped, as a pytree's are).

On disk the layout is the reference's, so a directory written by either
package reads in the other through ``load_latest_raw``:
``step_%010d/`` directories, one ``<group>.npz`` a group with the leaf
paths joined by ``/`` as keys (dict keys sorted, NamedTuple fields by
name, sequence items by index), and a ``manifest.json`` with each file's
``sha256_16``. bfloat16 leaves are widened to float32 in the npz (npz has
no bf16); a template's dtype restores them on load.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_NATIVE_KINDS = set("fiub")  # float/int/uint/bool numpy kinds


def _items(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a tree, in the reference's pytree order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array the npz can hold (bf16 widened to f32);
    ``copy`` makes sure it shares no memory with the leaf (a CPU tensor's
    ``numpy()`` is a view)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.to("cpu", copy=copy).numpy()
    arr = np.array(leaf, copy=copy) if copy else np.asarray(leaf)
    if arr.dtype.kind not in _NATIVE_KINDS or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten_with_paths(tree, copy: bool = False) -> Dict[str, np.ndarray]:
    """The tree's leaves on the host, keyed by their ``/``-joined paths (a
    flat dict of arrays is itself a tree that flattens to the same keys)."""
    return {"/".join(path): _host(leaf, copy) for path, leaf in _items(tree)}


def map_tree(fn, tree, prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf ``x`` replaced by ``fn(path, x)``
    (``path`` as ``_items`` gives it; None leaves stay None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, prefix + (name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _unflatten_like(template, flat: Dict[str, np.ndarray]):
    """``template``'s structure with each leaf read from ``flat`` in the
    template leaf's dtype (and, for a tensor, on its device)."""

    def leaf(path, like):
        arr = flat["/".join(path)]
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
        tdtype = getattr(like, "dtype", None)
        if tdtype is not None and str(arr.dtype) != str(tdtype):
            arr = arr.astype(tdtype)
        return arr

    return map_tree(leaf, template)


def save_checkpoint(directory: str | Path, step: int, state: Dict[str, Any]) -> Path:
    """Atomic checkpoint save. ``state`` is a dict of named trees."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:010d}"
    tmp = Path(tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory))
    manifest = {"step": step, "groups": {}, "time": time.time()}
    try:
        for name, tree in state.items():
            flat = _flatten_with_paths(tree)
            fname = f"{name}.npz"
            np.savez(tmp / fname, **flat)
            digest = hashlib.sha256((tmp / fname).read_bytes()).hexdigest()[:16]
            manifest["groups"][name] = {"file": fname, "sha256_16": digest}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        with open(tmp / "manifest.json") as f:
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _verify(path: Path) -> bool:
    try:
        manifest = json.loads((path / "manifest.json").read_text())
        for info in manifest["groups"].values():
            digest = hashlib.sha256((path / info["file"]).read_bytes()).hexdigest()[:16]
            if digest != info["sha256_16"]:
                return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def _latest_valid(directory: Path) -> Optional[Tuple[Path, dict]]:
    """The newest checkpoint directory that passes its integrity check, and
    its manifest; corrupt or partial ones are skipped."""
    if not directory.exists():
        return None
    candidates = sorted(
        (d for d in directory.iterdir() if d.name.startswith("step_")), reverse=True
    )
    for cand in candidates:
        if _verify(cand):
            return cand, json.loads((cand / "manifest.json").read_text())
    return None


def load_latest(directory: str | Path, templates: Dict[str, Any]):
    """Restore the newest valid checkpoint; returns (step, state) or None.

    Corrupt/partial checkpoints (failed integrity check) are skipped: the
    restart path after a mid-save crash.
    """
    found = _latest_valid(Path(directory))
    if found is None:
        return None
    cand, manifest = found
    state = {}
    for name, template in templates.items():
        with np.load(cand / manifest["groups"][name]["file"]) as data:
            state[name] = _unflatten_like(template, dict(data))
    return manifest["step"], state


def load_latest_raw(directory: str | Path):
    """Restore the newest valid checkpoint without templates: returns
    ``(step, {group: {leaf_path: np.ndarray}})`` or None (the template-free
    twin of ``load_latest`` for callers that own their layout, as
    ``resilience.checkpoint`` does). Corrupt/partial checkpoints are skipped
    as ``load_latest`` skips them."""
    found = _latest_valid(Path(directory))
    if found is None:
        return None
    cand, manifest = found
    state = {}
    for name, info in manifest["groups"].items():
        with np.load(cand / info["file"]) as data:
            state[name] = {k: data[k] for k in data.files}
    return manifest["step"], state


def prune_checkpoints(directory: str | Path, keep: int = 3) -> None:
    """Drop all but the newest ``keep`` checkpoints (the functional save
    path's twin of ``CheckpointManager``'s rotation)."""
    directory = Path(directory)
    if not directory.exists() or keep <= 0:
        return
    ckpts = sorted(d for d in directory.iterdir() if d.name.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


class CheckpointManager:
    """Rotation plus optional async (background-thread) saves."""

    def __init__(
        self,
        directory: str | Path,
        *,
        keep: int = 3,
        async_save: bool = False,
    ):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.save_count = 0

    def wait(self):
        """Wait for the save in flight; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Dict[str, Any]):
        # copy to the host before returning: the caller may update its
        # tensors in place as soon as this returns
        host_state = {name: _flatten_with_paths(tree, copy=True) for name, tree in state.items()}

        def _do():
            save_checkpoint(self.directory, step, host_state)
            prune_checkpoints(self.directory, self.keep)

        def _background():
            try:
                _do()
            except Exception as err:  # kept for wait() to re-raise
                self._error = err

        self.save_count += 1
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=_background, daemon=True)
            self._thread.start()
        else:
            _do()

    def restore(self, templates: Dict[str, Any]):
        self.wait()
        return load_latest(self.directory, templates)
