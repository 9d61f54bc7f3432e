"""Data-parallel training with top-k gradient compression + error feedback
on the PyTorch port: 4 ranks over gloo, each with its shard of the data,
all-reduce the SPARSE gradients (one ``all_reduce`` a step), so the wire
bytes drop by ~1/ratio on a bandwidth-limited fabric
(``examples/compressed_dp.py``'s run; on the card the 4 ranks share it).

    PYTHONPATH=src python examples/torch_compressed_dp.py
    PYTHONPATH=src python examples/torch_compressed_dp.py --device cpu

The ranks are child processes of this script (a ``file://`` rendezvous in
a temporary directory); rank 0 prints.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.compression import compress_decompress, init_compression  # noqa: E402
from repro_torch.compression.topk import wire_bytes_saved  # noqa: E402
from repro_torch.core.engine import resolve_device  # noqa: E402

WORLD = 4
RANK_TIMEOUT_S = 300


def rank_main(rank: int, work: str, device: str, steps: int) -> None:
    import torch.distributed as tdist

    torch.set_num_threads(1)
    dev = torch.device(device)
    tdist.init_process_group("gloo", init_method="file://" + os.path.join(work, "init"),
                             world_size=WORLD, rank=rank)
    rng = np.random.default_rng(0)
    d_in, d_out, n = 64, 8, 512
    W_true = rng.standard_normal((d_in, d_out)).astype(np.float32)
    X = rng.standard_normal((n, d_in)).astype(np.float32)
    Y = X @ W_true
    rows = slice(rank * n // WORLD, (rank + 1) * n // WORLD)  # this rank's shard
    x, y = torch.from_numpy(X[rows]).to(dev), torch.from_numpy(Y[rows]).to(dev)

    w = torch.zeros((d_in, d_out), device=dev)
    state = init_compression({"w": w})
    out = {"rel_err": {}}
    t0 = time.perf_counter()
    for t in range(steps):
        g = {"w": x.T @ (x @ w - y) / x.shape[0]}
        sparse, state = compress_decompress(g, state, ratio=0.05, min_k=4)
        g_avg = sparse["w"]  # the all-reduce happens on the SPARSE tensor
        tdist.all_reduce(g_avg)
        w = w - 0.3 * (g_avg / WORLD)
        if t % 150 == 149:
            err = float(torch.linalg.norm(w.cpu() - torch.from_numpy(W_true))
                        / np.linalg.norm(W_true))
            out["rel_err"][t + 1] = err
            if rank == 0:
                print(f"[compressed_dp] step {t + 1}: rel_err={err:.4f}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    dense, comp = wire_bytes_saved({"w": w}, 0.05)
    out.update(dense_bytes=dense, compressed_bytes=comp, w=w.cpu().numpy().tolist())
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    tdist.barrier()
    tdist.destroy_process_group()


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.rank is not None:
        rank_main(args.rank, args.work, args.device, args.steps)
        return 0, {}
    dev = resolve_device(args.device)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"),
               OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank",
                                   str(r), "--work", work, "--device", str(dev), "--steps",
                                   str(args.steps)], env=env) for r in range(WORLD)]
        deadline = time.time() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"compressed_dp: the ranks exited {codes}")
        outs = [json.loads(Path(work, f"rank{r}.json").read_text()) for r in range(WORLD)]
    out = outs[0]
    out["ranks_agree"] = all(o["w"] == out["w"] for o in outs)
    dense, comp = out["dense_bytes"], out["compressed_bytes"]
    print(f"[compressed_dp] wire bytes/step: dense={dense} compressed~={comp} "
          f"({dense / comp:.0f}x reduction), ranks={WORLD} on {dev}, every rank's w equal: "
          f"{out['ranks_agree']}; {out['seconds']:.2f} s")
    return 0, out


if __name__ == "__main__":
    sys.exit(main()[0])
