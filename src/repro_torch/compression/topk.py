"""Top-k gradient compression with error feedback (the port of
``repro.compression.topk``).

For bandwidth-limited DP all-reduces: transmit only the top-k magnitude
entries per leaf, accumulate the residual locally (error feedback, Stich
et al. 2018) so the compression error is re-injected on later steps —
convergence is preserved while wire bytes drop by ~p/k.

Gradients are a dict of tensors (nested or not); the transform is a pure
function (tested for the EF invariant), and
``examples/torch_compressed_dp.py`` all-reduces its sparse values over a
``torch.distributed`` group.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.utils.trees import tree_leaves, tree_map


class CompressionState(NamedTuple):
    error: Any  # per-leaf residual (error feedback memory), the grads' tree


def init_compression(grads) -> CompressionState:
    return CompressionState(
        error=tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                       grads))


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    flat = torch.abs(x.reshape(-1))
    if k >= flat.shape[0]:
        return torch.ones_like(x, dtype=torch.bool)
    thresh = torch.topk(flat, k).values[-1]  # the k-th largest magnitude
    return (torch.abs(x) >= thresh) & (torch.abs(x) > 0)


def compress_decompress(
    grads,
    state: CompressionState,
    ratio: float = 0.01,
    min_k: int = 16,
) -> Tuple[Any, CompressionState]:
    """Returns (sparse grads ready for all-reduce, new error state)."""
    if isinstance(grads, dict):
        outs = {k: compress_decompress(g, CompressionState(error=state.error[k]), ratio, min_k)
                for k, g in grads.items()}
        return ({k: o[0] for k, o in outs.items()},
                CompressionState(error={k: o[1].error for k, o in outs.items()}))
    gf = grads.float() + state.error  # error feedback injection
    k = max(int(ratio * gf.numel()), min(min_k, gf.numel()))
    sent = torch.where(_topk_mask(gf, k), gf, 0.0)
    return sent.to(grads.dtype), CompressionState(error=gf - sent)


def wire_bytes_saved(grads, ratio: float) -> Tuple[int, int]:
    """(dense_bytes, compressed_bytes) — index+value encoding estimate."""
    leaves = list(tree_leaves(grads))
    dense = sum(g.numel() * 4 for g in leaves)
    comp = sum(max(int(ratio * g.numel()), 16) * 8 for g in leaves)  # 4B value + 4B index
    return dense, comp
