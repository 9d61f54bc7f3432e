"""Find how many of an architecture's layers one card can train at its
published widths: for each depth, a child process draws the model in its
recipe (its dtype and optimizer, remat), trains 2 steps at the reference's
train_4k shape (16 x 4,096 tokens in its microbatches) and reports
``torch.cuda.max_memory_allocated``; the deepest depth whose peak leaves
``--free`` of the card's memory free is the answer (chip_smoke.py's
TRAIN_DEPTH). With ``--lrs``, then 3 steps on one batch at each rate
(warmup 1) at ``--lr-depth`` layers: the losses, to pick a rate at which
they fall (chip_smoke.py's TRAIN_LR).

    PYTHONPATH=src python scripts/torch_train_depth_probe.py --arch deepseek_7b --depths 7 8 9
    PYTHONPATH=src python scripts/torch_train_depth_probe.py --depths --lrs 1e-5 1e-4 --lr-depth 8

Each depth runs in a child of its own, so that an allocation the card
refuses ends that child only (it reports the refusal).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MICROBATCHES = {"deepseek_7b": 8, "mamba2_130m": 1}  # the reference's cells.py


def child(arch: str, depth: int, batch: int, seq: int, lr: float | None = None) -> dict:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.lm_pipeline import batch_at_step
    from repro_torch.launch.serve import set_matmul_precision
    from repro_torch.training import init_train_state, make_train_step

    set_matmul_precision()
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    out = dict(arch=arch, depth=depth, total=torch.cuda.get_device_properties(0).total_memory)
    try:
        params, state = init_train_state(0, cfg, "cuda")
        torch.cuda.synchronize()
        out["state_bytes"] = torch.cuda.memory_allocated()
        out["params"] = sum(p.numel() for p in params.parameters())
        b = {k: torch.from_numpy(v).cuda()
             for k, v in batch_at_step(cfg, 0, batch=batch, seq_len=seq).items()}
        kw = {} if lr is None else dict(base_lr=lr, warmup=1)
        step = make_train_step(cfg, microbatches=MICROBATCHES.get(arch, 1), **kw)
        secs, losses = [], []
        for _ in range(2 if lr is None else 3):
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
        out.update(peak=torch.cuda.max_memory_allocated(), secs=secs, losses=losses)
    except torch.cuda.OutOfMemoryError as err:
        out.update(oom=str(err).splitlines()[0], peak=torch.cuda.max_memory_allocated())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek_7b")
    ap.add_argument("--depths", type=int, nargs="*", default=[7, 8, 9])
    ap.add_argument("--lrs", type=float, nargs="*", default=[])
    ap.add_argument("--lr-depth", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--free", type=float, default=0.10)
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-lr", type=float, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print("RESULT" + json.dumps(child(args.arch, args.child, args.batch, args.seq,
                                          args.child_lr)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"[depth] card {card}; {args.arch} at {args.batch}x{args.seq}, keeping "
          f"{args.free:.0%} of the card free")
    best = None

    def run(depth, lr=None):
        argv = [sys.executable, __file__, "--arch", args.arch, "--child", str(depth), "--batch",
                str(args.batch), "--seq", str(args.seq)]
        proc = subprocess.run(argv + ([] if lr is None else ["--child-lr", str(lr)]),
                              capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
        if proc.returncode or not lines:
            print(f"[depth] {depth} layers: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            return None
        return json.loads(lines[0][len("RESULT"):])

    for lr in args.lrs:
        r = run(args.lr_depth, lr)
        if r is not None:
            print(f"[lr] {args.lr_depth} layers, lr {lr} (warmup 1), 3 steps on one batch: "
                  + (f"refused ({r['oom']})" if "oom" in r else
                     f"losses {r['losses']}, falls: {r['losses'][-1] < r['losses'][0]}"))
    for depth in args.depths:
        r = run(depth)
        if r is None:
            continue
        fits = "oom" not in r and r["peak"] <= (1 - args.free) * r["total"]
        if fits and (best is None or depth > best):
            best = depth
        print(f"[depth] {depth} layers: " + (f"refused ({r['oom']})" if "oom" in r else
              f"{r['params']:,} parameters, state {r['state_bytes'] / 1e9:.3f} GB, peak "
              f"{r['peak'] / 1e9:.3f} GB of {r['total'] / 1e9:.3f} GB "
              f"({r['peak'] / r['total'] * 100:.1f}%), steps {[round(s, 3) for s in r['secs']]} "
              f"s, losses {[round(x, 4) for x in r['losses']]}") + f"; fits: {fits}")
    if args.depths:
        print(f"[depth] deepest depth that fits: {best}")
    return 0 if best is not None or not args.depths else 1


if __name__ == "__main__":
    sys.exit(main())
