"""Projection and proximal operators of the baseline solvers (the
reference's ``core/projections.py``): the building blocks of the paper's
Table-2 competitors (FISTA and projected accelerated gradient).

Plain PyTorch, in the reference's operation order: the reference computes
them with XLA ops, not in a Pallas kernel, so ``torch.sort`` and
``torch.cumsum`` take their place.
"""
from __future__ import annotations

import torch


def soft_threshold(x: torch.Tensor, thr) -> torch.Tensor:
    """Prox of ``thr * ||.||_1``: sign(x) * max(|x| - thr, 0)."""
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thr, 0.0)


def project_l1_ball(v: torch.Tensor, radius) -> torch.Tensor:
    """Euclidean projection of ``v`` onto the l1 ball of the given radius.

    Duchi et al. (2008) sort-based algorithm, O(p log p). Returns ``v``
    unchanged when it is already inside the ball (selected on the device,
    as the reference does: no host read).
    """
    abs_v = torch.abs(v)
    inside = torch.sum(abs_v) <= radius

    u = torch.sort(abs_v, descending=True).values
    css = torch.cumsum(u, dim=0)
    k = torch.arange(1, v.shape[0] + 1, dtype=v.dtype, device=v.device)
    cond = u * k > (css - radius)
    # rho = last index where cond holds (guaranteed >= 1 when outside ball)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    rho = torch.max(torch.where(cond, k, zero))
    rho = torch.clamp_min(rho, 1.0)
    theta = (torch.sum(torch.where(cond, u, zero)) - radius) / rho
    projected = soft_threshold(v, torch.clamp_min(theta, 0.0))
    return torch.where(inside, v, projected)
