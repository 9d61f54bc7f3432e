"""The (architecture x input-shape) cell plan for the multi-pod dry run
(the port of ``repro.launch.cells``).

Four LM shapes:
  train_4k    seq 4096,   global_batch 256   -> train_step
  prefill_32k seq 32768,  global_batch 32    -> prefill
  decode_32k  cache 32768, global_batch 128  -> serve_step (1 new token)
  long_500k   cache 524288, global_batch 1   -> serve_step; SSM/hybrid only

The shape-only builders (``batch_specs_for``, ``decode_inputs_for``,
``params_spec_for``, ``opt_spec_for``) return fake tensors
(``FakeTensorMode``): the reference's shapes and dtypes, no memory. Called
under an active fake mode they make that mode's tensors, else a new mode's;
``device`` is the fake tensors' device ('cuda' needs no card).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# microbatch counts for train_4k, sized so the layers' carries stay within
# a few GB/device at dp=16
TRAIN_MICROBATCHES: Dict[str, int] = {
    "mamba2_130m": 1,
    "internlm2_20b": 16,
    "deepseek_7b": 8,
    "gemma2_9b": 8,
    "qwen2_72b": 16,
    "internvl2_76b": 16,
    "arctic_480b": 16,
    "kimi_k2_1t_a32b": 16,
    "hymba_1_5b": 4,
    "seamless_m4t_medium": 2,
}

# MoE/huge archs shard the expert/mlp dim over 'data' too while serving so
# bf16 params fit
SERVE_MLP_DATA = {"arctic_480b", "kimi_k2_1t_a32b", "internvl2_76b"}


def cell_skip_reason(arch: str, shape: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.supports_long_context:
        return "full-attention arch: 500k decode is quadratic-regime (DESIGN.md)"
    return None


def iter_cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape, cell_skip_reason(arch, shape)


# ---------------------------------------------------------------------------
# Shape-only stand-ins for every model input
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _fake(tensors=()):
    """The fake mode that is active or that ``tensors`` belong to, entered;
    else a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = detect_fake_mode(list(tensors))
    if mode is not None:
        with mode:
            yield mode
        return
    with FakeTensorMode() as mode:
        yield mode


def _dtype(name) -> torch.dtype:
    return getattr(torch, name)


def batch_specs_for(cfg: ModelConfig, shape: ShapeSpec, device="cpu") -> Dict:
    """Training/prefill batch stand-ins."""
    B = shape.global_batch
    S = shape.seq_len
    dt = _dtype(cfg.dtype)
    with _fake():
        batch = {"tokens": torch.empty((B, S + 1) if shape.kind == "train" else (B, S),
                                       dtype=torch.int32, device=device)}
        if cfg.n_prefix_embeds:
            batch["patches"] = torch.empty((B, cfg.n_prefix_embeds, cfg.d_model), dtype=dt,
                                           device=device)
        if cfg.n_enc_layers:
            # encoder memory length: full seq for training, capped for serving
            enc_len = S if shape.kind == "train" else min(S, 4096)
            batch["frames"] = torch.empty((B, enc_len, cfg.d_model), dtype=dt, device=device)
    return batch


def decode_inputs_for(cfg: ModelConfig, shape: ShapeSpec, device="cpu"):
    """(tokens, cache) stand-ins for serve_step."""
    from repro_torch.models import model as model_lib

    B, S = shape.global_batch, shape.seq_len
    with _fake():
        tokens = torch.empty((B, 1), dtype=torch.int32, device=device)
        cache = model_lib.init_cache(cfg, B, S, dtype=cfg.dtype, device=device)
        if cfg.n_enc_layers:
            cache["memory"] = torch.empty((B, min(S, 4096), cfg.d_model),
                                          dtype=_dtype(cfg.dtype), device=device)
    return tokens, cache


def params_spec_for(cfg: ModelConfig, device="cpu"):
    """The port's model (``init_params``) on fake tensors."""
    from repro_torch.models import model as model_lib

    with _fake():
        model = model_lib.init_params(0, cfg, device="cpu")
        if torch.device(device).type != "cpu":
            for mod in model.modules():  # fake tensors' device is a label: relabel each
                for k, p in mod._parameters.items():
                    if p is not None:
                        mod._parameters[k] = torch.nn.Parameter(
                            torch.empty_like(p, device=device), requires_grad=p.requires_grad)
    return model


def opt_spec_for(cfg: ModelConfig, params_spec):
    """The optimizer's state for ``params_spec`` (the reference's, leaf for
    leaf, a layer stack's leaves stacked), on fake tensors."""
    from repro_torch.training import optimizers as opt_lib

    with _fake(opt_lib.named_leaves(params_spec).values()):
        return opt_lib.init_optimizer(cfg.optimizer, params_spec)
