"""Training launcher (the port of ``repro.launch.train``): the trainer
over the step-addressable synthetic stream, with checkpoints and resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b --reduced --device cpu

Runs on the card unless given ``--device cpu``; the weights are random,
drawn on the device from seed 0. On the card matmuls run with TF32 off and
bf16 products accumulated in f32 (``serve.set_matmul_precision``), and it
prints the card's name and power limit and the peak device memory.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.lm_pipeline import batch_at_step
from repro_torch.launch.serve import card_line, set_matmul_precision
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        set_matmul_precision()
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    def data_fn(step):
        return batch_at_step(cfg, step, batch=args.batch, seq_len=args.seq, seed=0)

    trainer = Trainer(
        cfg,
        TrainerConfig(
            total_steps=args.steps,
            checkpoint_every=args.ckpt_every,
            checkpoint_dir=f"{args.ckpt_dir}/{args.arch}",
            base_lr=args.lr,
            microbatches=args.microbatches,
        ),
        data_fn,
        device=dev,
    )
    params, opt_state, start = trainer.init_or_restore()
    del params, opt_state
    print(f"[train] {args.arch} starting at step {start}")
    t0 = time.time()
    trainer.run()
    dt = time.time() - t0
    n = len(trainer.history)
    out = dict(arch=args.arch, start=start, steps=n, seconds=dt, history=list(trainer.history),
               stragglers=len(trainer.monitor.stragglers), card=card_line(dev))
    if n:
        print(
            f"[train] done: {n} steps in {dt:.1f}s "
            f"({dt / max(n, 1):.2f}s/step), loss {trainer.history[0]:.3f} -> "
            f"{trainer.history[-1]:.3f}, stragglers={out['stragglers']}"
        )
    else:
        print(f"[train] nothing to do: the checkpoint is at step {start} of {args.steps}")
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"[train] card: {out['card']}; peak device memory {out['peak_gb']:.2f} GB")
    return 0, out


if __name__ == "__main__":
    sys.exit(main()[0])
