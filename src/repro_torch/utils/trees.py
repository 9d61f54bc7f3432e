"""Tree helpers (parameter counting, byte accounting) shared across
subsystems (the port of ``repro.utils.trees``).

A tree is an ``nn.Module`` (its parameters), a tensor or numpy array, or a
dict, list, tuple or NamedTuple of trees; None leaves count nothing.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch import nn


def tree_leaves(tree) -> Iterator:
    """The tensors and arrays of ``tree``, depth first."""
    if tree is None:
        return
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    """``tree``'s dicts with each other leaf ``x`` replaced by ``fn(x)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_param_count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            itemsize = x.element_size()
        else:
            dt = getattr(x, "dtype", None)
            itemsize = np.dtype(dt).itemsize if dt is not None else 4
        total += int(np.prod(x.shape)) * itemsize
    return total
