"""GPipe-style pipeline parallelism over a ``torch.distributed`` group (the
port of ``repro.parallel.pipeline``).

One rank a stage: microbatches stream through the pipeline with the
classic (n_micro + n_stages - 1)-tick schedule, each tick's activations
shifted one stage on with point-to-point sends. Differentiable end to end:
a shift is an autograd function whose backward sends the gradient one
stage back, and the final outputs, broadcast from the last stage, carry
their gradient back to it. Held against sequential execution in
``tests/test_torch_pipeline.py``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _exchange(send: torch.Tensor | None, to: int | None, recv_like: torch.Tensor,
              frm: int | None, group) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` and receive a tensor shaped as
    ``recv_like`` from ``frm`` (zeros where ``frm`` is None), both in
    flight together."""
    reqs = []
    out = torch.zeros_like(recv_like)
    if frm is not None:
        reqs.append(dist.irecv(out, src=frm, group=group))
    if to is not None:
        reqs.append(dist.isend(send.contiguous(), dst=to, group=group))
    for r in reqs:
        r.wait()
    return out


class _Shift(torch.autograd.Function):
    """y on stage s -> the activation entering stage s + 1 (zeros into
    stage 0); the backward sends the gradient to stage s - 1."""

    @staticmethod
    def forward(ctx, y, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        return _exchange(y, nxt, y, prev, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.prev, grad, ctx.nxt, ctx.group), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's value on every rank. The ranks hold one value, so
    the last stage's gradient is the mean of the ranks' gradients (each
    rank's loss one copy of the same loss)."""

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        out = x.detach().clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        g = g / dist.get_world_size(ctx.group)
        if dist.get_rank() != ctx.src:
            g = torch.zeros_like(g)
        return g, None, None


class _Join(torch.autograd.Function):
    """``ys`` with every shift's output joined to it in the graph (no value
    of theirs is read): the backward then reaches each shift on every rank,
    so each rank runs every shift's backward, in the same tick order, and
    the sends and receives pair up."""

    @staticmethod
    def forward(ctx, ys, *bufs):
        ctx.n_bufs = len(bufs)
        return ys.clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + tuple(torch.zeros_like(grad[0]) for _ in range(ctx.n_bufs))


def make_pipeline_fn(
    group,  # the torch.distributed group, one rank a stage (None: the default group)
    stage_fn: Callable,  # (stage_params, x) -> y, same shape
    n_stages: int,
):
    """Returns pipe(params_stacked, xs) -> ys.

    params_stacked: a tensor, or a dict of tensors, with leading dim
    n_stages; the rank of stage s reads its slice s (its gradient lands
    there; the other slices' stay zero, as the reference's sharded gradient
    holds each stage's on its own device).
    xs: (n_micro, mb, ...) microbatched inputs (the same on every rank).
    ys: (n_micro, mb, ...) outputs of the final stage (on every rank).
    """

    def pipe(params_stacked, xs):
        grp = group or dist.group.WORLD
        world = dist.get_world_size(grp)
        if world != n_stages:
            raise ValueError(f"{n_stages} stages on a group of {world} ranks")
        stage = dist.get_rank(grp)
        prev = dist.get_global_rank(grp, stage - 1) if stage > 0 else None
        nxt = dist.get_global_rank(grp, stage + 1) if stage < n_stages - 1 else None
        last = dist.get_global_rank(grp, n_stages - 1)
        if isinstance(params_stacked, dict):
            params_stage = {k: v[stage] for k, v in params_stacked.items()}
        else:
            params_stage = params_stacked[stage]
        n_micro = xs.shape[0]
        T = n_micro + n_stages - 1

        buf = torch.zeros_like(xs[0])
        outs, bufs = [None] * n_micro, []
        first = torch.tensor(stage == 0, device=xs.device)
        for t in range(T):
            inject = t if t < n_micro else 0
            x_in = torch.where(first, xs[inject], buf)  # buf stays in the graph on stage 0
            y = stage_fn(params_stage, x_in)
            # last stage records its output at position t - (n_stages - 1)
            out_slot = t - (n_stages - 1)
            if stage == n_stages - 1 and out_slot >= 0:
                outs[out_slot] = y
            # shift activations forward one stage
            buf = _Shift.apply(y, prev, nxt, grp)
            bufs.append(buf)
        if stage == n_stages - 1:
            ys = torch.stack(outs)
        else:
            ys = torch.zeros((n_micro,) + tuple(xs.shape[1:]), dtype=xs.dtype, device=xs.device)
        # broadcast final outputs from the last stage to all ranks
        return _FromLast.apply(_Join.apply(ys, *bufs), last, grp)

    return pipe
