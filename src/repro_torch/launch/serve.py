"""Serving launcher: prefill a batch of synthetic requests, decode N tokens
greedily with the serve step, report the prefill's seconds and tokens/s
(the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_7b            # the card, full width
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_7b --reduced --device cpu

The weights are random, drawn on the device from seed 0 (the prompts
from seed 1). On the card it also prints the card's name and power limit
(``nvidia-smi``) and the peak device memory; matmuls there run with TF32
off and bf16 products accumulated in f32 (``set_matmul_precision``), as
the reference's are.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training import make_serve_step


def set_matmul_precision() -> None:
    """The reference's matmul numerics on the card: no TF32, and bf16
    products accumulated in f32 (cuBLAS's reduced-precision bf16 split-K
    reductions off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" on
    the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def synthetic_batch(cfg: ModelConfig, batch: int, prompt_len: int, gen: torch.Generator,
                    n_frames: int = 32) -> dict:
    """Random prompts (and a VLM's patches, an encoder's frames) drawn on
    the generator's device."""
    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                                   device=dev)}
    if cfg.n_prefix_embeds:
        out["patches"] = torch.randn((batch, cfg.n_prefix_embeds, cfg.d_model), generator=gen,
                                     device=dev)
    if cfg.n_enc_layers:
        out["frames"] = torch.randn((batch, n_frames, cfg.d_model), generator=gen, device=dev)
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: ModelConfig, batch: int, prompt_len: int, tokens: int, device="cuda",
        log=print) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``tokens`` steps greedily; returns the numbers it printed and
    the generated tokens ((batch, tokens) on the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_matmul_precision()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(0, cfg, dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = synthetic_batch(cfg, batch, prompt_len, gen)
    max_seq = prompt_len + tokens + cfg.n_prefix_embeds + 8
    log(f"[serve] {cfg.name} ({cfg.dtype}): {n_params:,} parameters drawn on {dev} "
        f"in {init_s:.2f} s")

    t0 = time.perf_counter()
    logits, cache = M.prefill(params, inputs, cfg, max_seq=max_seq)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    log(f"[serve] prefill {batch}x{prompt_len}: {prefill_s:.4f} s")

    serve = make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    out, steps = [], []
    t_all = time.perf_counter()
    for _ in range(tokens):
        t0 = time.perf_counter()
        tok, _, cache = serve(params, tok, cache)
        _sync(dev)
        steps.append(time.perf_counter() - t0)
        out.append(tok)
    dt = time.perf_counter() - t_all
    steady = statistics.median(steps[1:]) if len(steps) > 1 else steps[0]
    log(f"[serve] {batch * tokens} tokens in {dt:.2f}s ({batch * tokens / dt:.1f} tok/s); "
        f"a step {steady * 1e3:.3f} ms (median past the first; the first "
        f"{steps[0] * 1e3:.3f} ms), {batch / steady:.1f} tok/s steady")
    res = dict(arch=cfg.name, params=n_params, init_s=init_s, prefill_s=prefill_s,
               decode_s=dt, step_ms=steady * 1e3, first_step_ms=steps[0] * 1e3,
               tok_s=batch * tokens / dt, steady_tok_s=batch / steady, card=card_line(dev),
               tokens=torch.cat(out, dim=1).cpu())
    if dev.type == "cuda":
        res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"[serve] card: {res['card']}; peak device memory {res['peak_gb']:.2f} GB")
    return res


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return 0, run(cfg, args.batch, args.prompt_len, args.tokens, args.device)


if __name__ == "__main__":
    sys.exit(main()[0])
