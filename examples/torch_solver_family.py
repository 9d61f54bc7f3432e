"""Solver family on one engine, on the PyTorch port: lasso / logistic /
elastic-net, dense and sparse, through the shared backend-dispatched FW
loop (``examples/solver_family.py``'s run, on the card).

The paper (§6) presents logistic regression and the elastic-net as
"easily obtained" extensions of Algorithm 2: the same randomized
linear-minimization oracle, the same O(m) state recursions, another
gradient-vs-state and line search. Each solver here is the same engine
under another problem oracle, so the block-ELL backend and the batched
multi-delta path driver (with converged-lane pruning) serve all three.

    PYTHONPATH=src python examples/torch_solver_family.py               # on the card
    PYTHONPATH=src python examples/torch_solver_family.py --device cpu  # the plain versions
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (LOGISTIC, ENOracle, FWConfig, TorchSampler, en_solve,  # noqa: E402
                              engine, fw_solve, logistic_solve)
from repro_torch.core import path as path_lib  # noqa: E402
from repro_torch.data import make_sparse_proxy  # noqa: E402
from repro_torch.sparse import ops as sops  # noqa: E402


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--scale", type=float, default=0.02, help="the proxy's share of its size")
    ap.add_argument("--points", type=int, default=8)
    ap.add_argument("--max-iters", type=int, default=10_000)
    args = ap.parse_args(argv)
    dev = engine.resolve_device(args.device)
    out = {}

    print("== data: sparse-native e2006-tfidf proxy (block-ELL, no dense X)")
    ds = make_sparse_proxy("e2006-tfidf", scale=args.scale, seed=0)
    mat = ds.mat.to(dev)
    y = torch.as_tensor(np.asarray(ds.y), device=dev)
    p, m = mat.shape
    print(f"   p={p} features, m={m} samples, nnz_max={mat.nnz_max}, "
          f"storage={mat.nbytes / 1e6:.1f} MB (dense would be {4 * p * m / 1e6:.1f} MB)")
    Xt_dense = mat.to_dense()  # feasible at example scale, for comparison only
    y_cls = torch.sign(y) + (y == 0)  # {-1,+1} labels for the logistic oracle
    delta = 0.5 * float(np.abs(np.asarray(ds.coef)).sum())

    # --- one engine, three oracles, two backends each ---------------------
    base = dict(delta=delta, kappa=max(64, p // 100), sampling="uniform",
                max_iters=args.max_iters, tol=1e-4)
    runs = [
        ("lasso", lambda A, cfg: fw_solve(A, y, cfg, TorchSampler(0, dev), device=dev)),
        ("logistic", lambda A, cfg: logistic_solve(A, y_cls, cfg, TorchSampler(0, dev),
                                                   device=dev)),
        ("elastic-net l2=1", lambda A, cfg: en_solve(A, y, cfg, 1.0, TorchSampler(0, dev),
                                                     device=dev)),
    ]
    for name, solve in runs:
        for backend, A in (("torch", Xt_dense), ("sparse", mat)):
            cfg = FWConfig(backend=backend, **base)
            # one step first, in place of the reference's compile call: the
            # kernels load (or build) at their first launch
            solve(A, dataclasses.replace(cfg, max_iters=1))
            t0 = time.perf_counter()
            res = solve(A, cfg)
            float(res.objective)  # waits for the card
            dt = time.perf_counter() - t0
            out[f"{name}/{backend}"] = dict(objective=float(res.objective),
                                            active=int(res.active),
                                            iterations=int(res.iterations), ms=dt * 1e3)
            print(f"   {name:16s} {backend:6s}: obj={float(res.objective):12.4f} "
                  f"active={int(res.active):4d} iters={int(res.iterations):5d} "
                  f"{dt * 1e3:7.1f} ms")

    # --- family regularization paths on the batched pruned driver ---------
    print("== batched multi-delta paths (converged lanes pruned early)")
    deltas = path_lib.delta_grid(delta, n_points=args.points)
    cfg = FWConfig(delta=1.0, kappa=max(64, p // 100), sampling="uniform",
                   max_iters=args.max_iters, tol=1e-4, backend="sparse")
    for name, oracle, yy in (
        ("lasso", None, y),
        ("logistic", LOGISTIC, y_cls),
        ("elastic-net", ENOracle(l2=1.0), y),
    ):
        res = path_lib.fw_path_batched(mat, yy, deltas, cfg, lane_width=4, oracle=oracle,
                                       device=dev)
        objs = [pt.objective for pt in res.points]
        out[f"path/{name}"] = dict(points=len(res.points), seconds=res.total_seconds,
                                   saved=res.saved_iters, first=objs[0], last=objs[-1])
        print(f"   {name:12s}: {len(res.points)} grid points in "
              f"{res.total_seconds:.2f}s, saved {res.saved_iters} lane-iters, "
              f"obj {objs[0]:.3g} -> {objs[-1]:.3g}")

    # --- the sparse colstats kernel (K6, the setup pass) ------------------
    zty_k, zn2_k = sops.sparse_colstats(mat, y, use_kernel=True)
    zty_r, zn2_r = sops.sparse_colstats(mat, y, use_kernel=False)
    diffs = (float(torch.max(torch.abs(zty_k - zty_r))), float(torch.max(torch.abs(zn2_k - zn2_r))))
    out["colstats_diff"] = diffs
    print("== fused sparse colstats kernel max |diff| vs the plain sweep:", *diffs)
    return 0, out


if __name__ == "__main__":
    sys.exit(main()[0])
