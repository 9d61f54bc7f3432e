"""Serve steps (the port of ``repro.training.train_step``'s
``make_serve_step`` and ``make_prefill_step``).

serve_step: one-token greedy decode against the preallocated cache, which
it updates in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, tokens (B,1), cache) -> (next_tokens, logits, cache)."""

    def serve_step(params, tokens, cache):
        logits, cache = model_lib.decode_step(params, tokens, cache, cfg)
        # the first maximum on ties, as jnp.argmax takes it
        next_tokens = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tokens[:, None], logits, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        return model_lib.prefill(params, batch, cfg, max_seq)

    return prefill_step
