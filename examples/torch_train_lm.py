"""End-to-end LM training on the PyTorch port: data pipeline -> train
step -> checkpoints -> resume, on a small model of an assigned
architecture's family (``examples/train_lm.py``'s run, on the card).

    PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2_130m --steps 120
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
    # kill it mid-run and re-run: it resumes from the latest checkpoint.

~20M parameters by default; --d-model/--layers scale it up.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.engine import resolve_device  # noqa: E402
from repro_torch.data.lm_pipeline import batch_at_step  # noqa: E402
from repro_torch.launch.serve import card_line, set_matmul_precision  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.utils import tree_param_count  # noqa: E402


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2_130m")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/example_lm")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        set_matmul_precision()
    full = get_config(args.arch)
    cfg = full.reduced(
        d_model=args.d_model,
        n_layers=args.layers,
        d_ff=args.d_model * 3 if full.d_ff else 0,
        vocab_size=4096,
        head_dim=64,
    )

    def data_fn(step):
        return batch_at_step(cfg, step, batch=args.batch, seq_len=args.seq, seed=0)

    trainer = Trainer(
        cfg,
        TrainerConfig(
            total_steps=args.steps,
            checkpoint_every=max(args.steps // 4, 10),
            checkpoint_dir=f"{args.ckpt_dir}/{args.arch}",
            base_lr=args.lr,
            async_checkpoint=True,
        ),
        data_fn,
        device=dev,
    )
    params, _, start = trainer.init_or_restore()
    n_params = tree_param_count(params)
    del params
    print(f"[train_lm] arch={args.arch} params={n_params / 1e6:.1f}M start_step={start} "
          f"device={dev}")
    t0 = time.time()
    trainer.run()
    n = len(trainer.history)
    dt = time.time() - t0
    out = dict(params=n_params, start=start, steps=n, seconds=dt, history=list(trainer.history),
               checkpoints=trainer.ckpt.save_count, card=card_line(dev))
    print(f"[train_lm] {n} steps in {dt:.1f}s ({dt / max(n, 1) * 1000:.0f} ms/step)")
    if n:
        print(f"[train_lm] loss: {trainer.history[0]:.3f} -> {trainer.history[-1]:.3f} "
              f"(copy-motif data is learnable; expect a clear drop)")
    print(f"[train_lm] stragglers flagged: {len(trainer.monitor.stragglers)}; "
          f"checkpoints: {trainer.ckpt.save_count} (async); card: {out['card']}")
    return 0, out


if __name__ == "__main__":
    sys.exit(main()[0])
