"""The paper's headline experiment (abstract) on the PyTorch port: the
COMPLETE regularization path on a problem with millions of variables
(``examples/lasso_fullpath_4m.py``'s run, on the card).

E2006-log1p-like proxy at full feature count (p = 4,272,227). Two builds:

* dense: reduced sample count (m), built on the device
  (``data.synthetic.make_wide_problem``); the per-iteration cost of
  stochastic FW is O(kappa * m), so the scaling story is faithful.
* ``--backend sparse``: the block-ELL build at the dataset's true column
  density (``data.proxies.make_sparse_wide_problem``, built on the
  device): storage is O(nnz), so the paper-size problem takes ~100s of MB
  instead of ~18 GB, and the per-iteration cost drops to O(kappa * nnz_max).

    PYTHONPATH=src python examples/torch_lasso_fullpath_4m.py               # p=500k
    PYTHONPATH=src python examples/torch_lasso_fullpath_4m.py --paper-size  # p=4.27M (~14 GB)
    PYTHONPATH=src python examples/torch_lasso_fullpath_4m.py --paper-size --backend sparse

It prints the path's seconds, iterations and dots, and beside them the
card's name and power limit (``nvidia-smi``). ``--device cpu`` runs the
kernels' plain versions (small sizes only).
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import FWConfig, engine  # noqa: E402
from repro_torch.core import path as path_lib  # noqa: E402
from repro_torch.core.sampling import kappa_fraction  # noqa: E402
from repro_torch.data.proxies import make_sparse_wide_problem  # noqa: E402
from repro_torch.data.synthetic import make_wide_problem  # noqa: E402

P_PAPER = 4_272_227
N_RELEVANT = 300  # the generator's true support, as the reference example's


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" on
    the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper-size", action="store_true", help="p=4,272,227")
    ap.add_argument("--p", type=int, default=500_000)
    ap.add_argument("--m", type=int, default=800)
    ap.add_argument("--points", type=int, default=100)
    ap.add_argument("--frac", type=float, default=0.01, help="|S| as fraction of p")
    ap.add_argument("--driver", choices=("sequential", "batched"), default="batched",
                    help="fw_path (one delta at a time) or fw_path_batched lanes")
    ap.add_argument("--backend", choices=("torch", "kernels", "sparse"), default="torch",
                    help="iteration engine; 'kernels' the port's dense kernels, 'sparse' the "
                         "block-ELL subsystem (no dense build)")
    ap.add_argument("--density", type=float, default=0.002,
                    help="column density for --backend sparse (E2006-log1p: 0.002)")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = engine.resolve_device(args.device)
    p = P_PAPER if args.paper_size else args.p

    t0 = time.perf_counter()
    if args.backend == "sparse":
        print(f"== generating SPARSE wide problem p={p:,} m={args.m} "
              f"density={args.density:g} (dense would be "
              f"{p * args.m * 4 / 1e9:.1f} GB)")
        Xt, y, coef = make_sparse_wide_problem(args.m, p, args.density, N_RELEVANT, seed=0,
                                               device=dev, block_size=256)
        print(f"   built in {time.perf_counter() - t0:.1f}s "
              f"({Xt.nbytes / 1e9:.2f} GB block-ELL, nnz_max={Xt.nnz_max})")
    else:
        print(f"== generating wide problem p={p:,} m={args.m} "
              f"({p * args.m * 4 / 1e9:.1f} GB design matrix)")
        Xt, y, coef = make_wide_problem(p, args.m, N_RELEVANT, seed=0, device=dev)
        print(f"   built in {time.perf_counter() - t0:.1f}s")

    kappa = kappa_fraction(p, args.frac)
    # delta_max: the generator's true coefficients give an oracle l1 budget;
    # 0.5x keeps the path in the sparse regime where FW shines (the paper's
    # use case)
    delta_max = 0.5 * float(coef.abs().sum())
    deltas = path_lib.delta_grid(delta_max, n_points=args.points)
    # the dense kernels take aligned blocks, as the reference's Pallas path
    sampling = "block" if args.backend == "kernels" else "uniform"
    cfg = FWConfig(delta=1.0, kappa=kappa, sampling=sampling,
                   max_iters=5000, tol=1e-3, backend=args.backend)

    print(f"== full path: {args.points} points, kappa={kappa:,} ({args.frac:.0%} of p), "
          f"driver={args.driver}, backend={args.backend}")
    t0 = time.perf_counter()
    if args.driver == "batched":
        res = path_lib.fw_path_batched(Xt, y, deltas, cfg, device=dev)
    else:
        res = path_lib.fw_path(Xt, y, deltas, cfg, device=dev)
    dt = time.perf_counter() - t0
    card = card_line(dev)
    print(f"   PATH DONE in {dt:.1f}s  ({dt / args.points * 1000:.0f} ms/point)")
    print(f"   total iters={res.total_iters} dots={res.total_dots:,} "
          f"mean_active={res.mean_active:.1f}")
    last = res.points[-1]
    print(f"   densest point: active={last.active} obj={last.objective:.4f}")
    print(f"   card: {card}")
    return 0, dict(seconds=dt, points=len(res.points), total_iters=res.total_iters,
                   total_dots=res.total_dots, mean_active=res.mean_active,
                   densest_active=last.active, densest_objective=last.objective, p=p,
                   card=card)


if __name__ == "__main__":
    sys.exit(main()[0])
