"""Train and serve steps (the port of ``repro.training.train_step``).

train_step: microbatched gradient accumulation -> clip -> AdamW/Adafactor
update with a cosine schedule. Microbatching bounds the activations at
large (batch x seq); the counts per (arch x shape) are the reference's
``launch/cells.py``.

serve_step: one-token greedy decode against the preallocated cache, which
it updates in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models import sharding as sh_lib
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizers as opt_lib


def _split_microbatches(batch: Dict, n: int):
    """(B, ...) -> n dicts of (B//n, ...), in order. A DTensor (its rows
    sharded over the data axes, as the reference's constraint on the split
    keeps them) is split on each rank's own rows: microbatch i is every
    rank's i-th block of its rows, with no collective (the step sums the
    same rows' gradients, grouped otherwise than the plain split's)."""
    def split(v, i):
        if sh_lib.is_dtensor(v):
            loc = v.to_local()
            part = loc.reshape((n, loc.shape[0] // n) + tuple(loc.shape[1:]))[i]
            return sh_lib.wrap_local(part, v.device_mesh, v.placements,
                                     (v.shape[0] // n,) + tuple(v.shape[1:]))
        return v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]

    return [{k: split(v, i) for k, v in batch.items()} for i in range(n)]


def _reduce_grads(params, grads: Dict) -> Dict:
    """Each DTensor gradient laid out as its parameter (the gradient
    reductions: a ``Partial`` sum over the ranks that shared the
    parameter's work becomes an all-reduce or a reduce-scatter); plain
    tensors as they are."""
    out = {}
    for n, g in grads.items():
        if sh_lib.is_dtensor(g):
            p = params.get_parameter(n)
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
        out[n] = g
    return out


@torch.no_grad()
def _clip_in_place(grads: Dict, max_norm: float):
    """``optimizers.clip_by_global_norm`` over the step's own gradients,
    written back into them (the same values: each cast to f32, scaled, cast
    back), so that no second copy of the gradients is made."""
    norm = opt_lib.global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


def make_train_step(
    cfg: ModelConfig,
    *,
    microbatches: int = 1,
    dp_axes: Tuple[str, ...] | None = None,
    accum_dtype=torch.float32,
    base_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    weight_decay: float = 0.1,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the parameters and the optimizer's state are updated in
    place.

    Each microbatch's gradient is added into an ``accum_dtype`` sum in
    order, then divided by the count (the grads then have that dtype);
    with one microbatch they keep the parameters' dtype. ``dp_axes`` names
    the mesh axes that carry the batch (the reference's constraint for the
    microbatch split): DTensor batches are split on each rank's rows
    whatever it names, so it is read by nothing. On a mesh (DTensor
    parameters) each microbatch's gradients are reduced to their
    parameters' layouts. ``weight_decay`` is taken and, as in the
    reference, not passed on: each optimizer keeps its own default."""
    del dp_axes, weight_decay

    def loss_and_grad(params, mb):
        names, plist = zip(*[(n, p) for n, p in params.named_parameters() if p.requires_grad])
        with torch.enable_grad():
            loss, metrics = model_lib.loss_fn(params, mb, cfg)
            grads = torch.autograd.grad(loss, plist)
        grads = _reduce_grads(params, dict(zip(names, grads)))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state: opt_lib.OptState, batch: Dict):
        if microbatches > 1:
            gsum, lsum = None, 0.0
            for mb in _split_microbatches(batch, microbatches):
                loss, _, grads = loss_and_grad(params, mb)
                if gsum is None:
                    gsum = {n: torch.zeros_like(g, dtype=accum_dtype) if sh_lib.is_dtensor(g)
                            else torch.zeros(g.shape, dtype=accum_dtype, device=g.device)
                            for n, g in grads.items()}
                for n, g in grads.items():
                    gsum[n].add_(g.to(accum_dtype))
                del grads
                lsum = lsum + loss
            grads = {n: g.div_(microbatches) for n, g in gsum.items()}
            loss = lsum / microbatches
            metrics = {"loss": loss}
        else:
            loss, metrics, grads = loss_and_grad(params, batch)

        grads, gnorm = _clip_in_place(grads, max_grad_norm)
        # schedule uses the post-increment step (step 0 would give lr=0)
        lr = opt_lib.cosine_schedule(opt_state.step + 1, base_lr=base_lr, warmup=warmup,
                                     total=total_steps)
        params, opt_state = opt_lib.apply_optimizer(cfg.optimizer, grads, opt_state, params, lr)
        metrics = dict(metrics)
        metrics.update({"grad_norm": gnorm, "lr": lr, "step": opt_state.step})
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, tokens (B,1), cache) -> (next_tokens, logits, cache)."""

    def serve_step(params, tokens, cache):
        logits, cache = model_lib.decode_step(params, tokens, cache, cfg)
        # the first maximum on ties, as jnp.argmax takes it
        next_tokens = sh_lib.argmax_last(logits[:, -1, :]).to(torch.int32)
        return next_tokens[:, None], logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        return model_lib.prefill(params, batch, cfg, max_seq)

    return prefill_step


def init_train_state(key, cfg: ModelConfig, device="cuda"):
    """``(params, opt_state)``: the model drawn from ``key`` on ``device``
    with gradients on for every parameter, and its optimizer's state."""
    params = model_lib.init_params(key, cfg, device)
    for p in params.parameters():
        p.requires_grad_(True)
    opt_state = opt_lib.init_optimizer(cfg.optimizer, params)
    return params, opt_state
