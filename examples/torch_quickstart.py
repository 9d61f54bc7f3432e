"""Quickstart on the PyTorch port: stochastic Frank-Wolfe Lasso vs
coordinate descent (``examples/quickstart.py``'s run, on the card).

Solves one constrained Lasso problem and a small regularization path on
synthetic data (paper §5.1 setup), printing objective / sparsity / dot
products for each solver, and the penalized FISTA solve at CD's lambda
beside CD.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # the plain versions
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    CDConfig, FISTAConfig, FWConfig, TorchSampler, baselines, engine, fw_solve)
from repro_torch.core import path as path_lib  # noqa: E402
from repro_torch.core.sampling import kappa_percentile  # noqa: E402
from repro_torch.data.synthetic import paper_synthetic  # noqa: E402


def run(device, p: int = 10_000, n_informative: int = 100, points: int = 10,
        max_iters: int = 50_000, sampler_fn=None, v0=None, log=print) -> dict:
    """The quickstart's solves on ``device`` (each FW solve at most
    ``max_iters`` steps). ``sampler_fn(sampling)`` gives each single FW
    solve's sampler ('full', 'uniform'; by default a ``TorchSampler(0)``),
    ``v0`` FISTA's power-iteration start (by default its seed's). Returns
    the numbers it printed."""
    dev = engine.resolve_device(device)
    if sampler_fn is None:
        sampler_fn = lambda sampling: TorchSampler(0, dev)  # noqa: E731
    log(f"== data: synthetic, m=200, p={p}, {n_informative} informative (paper §5.1)")
    ds = paper_synthetic(p, n_informative, seed=0)
    Xt = torch.as_tensor(np.ascontiguousarray(ds.X.T), device=dev)
    y = torch.as_tensor(np.asarray(ds.y), device=dev)
    out = {}

    # --- single problem at a mid-path delta -------------------------------
    lam_grid = path_lib.lambda_grid(Xt, y, n_points=10)
    lam = float(lam_grid[3])
    cd = baselines.cd_solve(Xt, y, CDConfig(lam=lam, max_sweeps=300, tol=1e-6), device=dev)
    delta = float(torch.sum(torch.abs(cd.alpha)))
    out.update(cd_objective=float(cd.objective), cd_active=int(cd.active), delta=delta)
    log(f"   CD at lam={lam:.1f}: obj={float(cd.objective):.4f} "
        f"active={int(cd.active)} -> equivalent delta={delta:.2f}")
    fista = baselines.fista_solve(Xt, y, FISTAConfig(lam=lam, max_iters=300, tol=1e-3), v0,
                                  device=dev)
    out.update(fista_objective=float(fista.objective), fista_active=int(fista.active),
               fista_iters=int(fista.iterations))
    log(f"   FISTA at lam={lam:.1f}: obj={float(fista.objective):.4f} "
        f"active={int(fista.active)} iters={int(fista.iterations)}")

    kappa = kappa_percentile(0.02, 0.98)  # the paper's 194
    log(f"   kappa (top-2%, 98% confidence): {kappa}")
    for sampling, label in (("full", "deterministic FW"), ("uniform", f"stochastic FW k={kappa}")):
        cfg = FWConfig(delta=delta, kappa=kappa, sampling=sampling, max_iters=max_iters, tol=1e-4)
        t0 = time.perf_counter()
        res = fw_solve(Xt, y, cfg, sampler_fn(sampling), device=dev)
        float(res.objective)  # waits for the card
        dt = time.perf_counter() - t0
        out[f"fw_{sampling}"] = dict(objective=float(res.objective), active=int(res.active),
                                     iterations=int(res.iterations), n_dots=int(res.n_dots),
                                     seconds=dt)
        log(f"   {label:28s} obj={float(res.objective):.4f} active={int(res.active):4d} "
            f"iters={int(res.iterations):5d} dots={int(res.n_dots):9d} time={dt:.2f}s")

    # --- short path with warm starts ---------------------------------------
    log(f"== regularization path ({points} points, paper protocol)")
    deltas = path_lib.delta_grid(delta, n_points=points)
    t0 = time.perf_counter()
    path_cfg = FWConfig(delta=1.0, kappa=kappa, max_iters=max_iters, tol=1e-3)
    fw_path = path_lib.fw_path(Xt, y, deltas, path_cfg, device=dev)
    fw_s = time.perf_counter() - t0
    log(f"   FW path: {fw_s:.2f}s  mean_active={fw_path.mean_active:.1f} "
        f"dots={fw_path.total_dots}")
    t0 = time.perf_counter()
    cd_path = path_lib.cd_path(Xt, y, path_lib.lambda_grid(Xt, y, n_points=points),
                               CDConfig(lam=0.0, max_sweeps=200, tol=1e-3), device=dev)
    cd_s = time.perf_counter() - t0
    log(f"   CD path: {cd_s:.2f}s  mean_active={cd_path.mean_active:.1f} "
        f"dots={cd_path.total_dots}")
    advantage = cd_path.total_dots / max(fw_path.total_dots, 1)
    log(f"   dot-product advantage FW vs CD: {advantage:.1f}x")
    out.update(fw_path_dots=fw_path.total_dots, fw_path_seconds=fw_s,
               cd_path_dots=cd_path.total_dots, cd_path_seconds=cd_s, advantage=advantage)
    return out


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--p", type=int, default=10_000)
    ap.add_argument("--informative", type=int, default=100)
    ap.add_argument("--points", type=int, default=10)
    ap.add_argument("--max-iters", type=int, default=50_000)
    args = ap.parse_args(argv)
    return 0, run(args.device, args.p, args.informative, args.points, args.max_iters)


if __name__ == "__main__":
    sys.exit(main()[0])
