"""Programmatic profiler capture around one FW solve on the PyTorch port
(``scripts/profile_capture.py``'s run, on the card).

Wraps a representative solve in a ``torch.profiler`` capture (a Chrome
trace of the host's ops and the card's kernels) AND the repo's own
``obs.trace.Tracer`` (Chrome ``trace_event`` JSON), so a regression comes
with a profile whose device timeline can be read beside the solver's host
span names: both bracket the same solve, and the Tracer's spans
(``profile/solve``, ``profile/solve/warmup``) give the wall-clock window
to look at in the profiler's trace.

The capture is best effort: when the profiler cannot start or stop (no
CUPTI in the environment), the script still writes the span table, the
Chrome trace and the timing summary, says so, and exits 0.

Usage:
  python scripts/torch_profile_capture.py --out reports/profile
  python scripts/torch_profile_capture.py --backend sparse --fuse-steps 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO_ROOT, os.path.join(_REPO_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import engine  # noqa: E402
from repro_torch.core.fw_lasso import LASSO  # noqa: E402
from repro_torch.core.solver_config import FWConfig  # noqa: E402
from repro_torch.core.vertex import TorchSampler  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.sparse.matrix import SparseBlockMatrix  # noqa: E402


def build_problem(p: int, m: int, backend: str, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(p, m)).astype(np.float32)
    coef = np.zeros(p, np.float32)
    nz = rng.choice(p, size=max(1, p // 100), replace=False)
    coef[nz] = rng.normal(size=nz.size).astype(np.float32)
    y = X.T @ coef + 0.1 * rng.normal(size=m).astype(np.float32)
    Xt = torch.as_tensor(X, device=device)
    if backend == "sparse":
        X[np.abs(X) < 1.0] = 0.0  # ~32% density: keep the gather busy
        Xt = SparseBlockMatrix.from_dense(torch.from_numpy(X), block_size=128).to(device)
    return Xt, torch.as_tensor(y, device=device)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="reports/profile",
                    help="artifact dir (profiler trace, chrome_trace.json, the summary)")
    ap.add_argument("--backend", default="torch", choices=("torch", "kernels", "sparse"))
    ap.add_argument("--step-rule", default="classic")
    ap.add_argument("--fuse-steps", type=int, default=1)
    ap.add_argument("--p", type=int, default=20_000)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--kappa", type=int, default=256)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = engine.resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    Xt, y = build_problem(args.p, args.m, args.backend, dev, seed=0)
    cfg = FWConfig(delta=10.0, kappa=args.kappa, max_iters=args.iters, tol=0.0,
                   patience=10**9, backend=args.backend, step_rule=args.step_rule,
                   fuse_steps=args.fuse_steps)

    tracer = obs_trace.Tracer()
    with obs_trace.use_tracer(tracer):
        with tracer.span("profile/solve/warmup", cat="profile"):
            engine.solve(LASSO, Xt, y, cfg, TorchSampler(0, dev), device=dev)
            _sync(dev)

        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof, profiler_err = None, None
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except Exception as exc:  # noqa: BLE001 - environment-dependent
            prof, profiler_err = None, str(exc)
        t0 = time.perf_counter()
        with tracer.span("profile/solve", cat="profile", backend=args.backend,
                         rule=args.step_rule, fuse_steps=args.fuse_steps, p=args.p, m=args.m):
            res = engine.solve(LASSO, Xt, y, cfg, TorchSampler(0, dev), device=dev)
            _sync(dev)
        elapsed = time.perf_counter() - t0
        profiler_path = None
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                profiler_path = os.path.join(args.out, "torch_profiler_trace.json")
                prof.export_chrome_trace(profiler_path)
            except Exception as exc:  # noqa: BLE001
                profiler_path, profiler_err = None, str(exc)

    chrome_path = os.path.join(args.out, "chrome_trace.json")
    tracer.save(chrome_path)
    iters = int(res.iterations)
    summary = {
        "profiler_trace": profiler_path,
        "profiler_error": profiler_err,
        "chrome_trace": chrome_path,
        "span_table": tracer.span_table(),
        "config": {"backend": args.backend, "step_rule": args.step_rule,
                   "fuse_steps": args.fuse_steps, "p": args.p, "m": args.m,
                   "kappa": args.kappa, "iters": args.iters, "device": str(dev)},
        "solve_seconds": elapsed,
        "us_per_iter": elapsed * 1e6 / max(1, iters),
        "iterations": iters,
    }
    with open(os.path.join(args.out, "profile_summary.json"), "wt") as fh:
        json.dump(summary, fh, indent=2)
    status = "captured" if profiler_path else f"SKIPPED ({profiler_err})"
    print(f"profile_capture: torch.profiler {status}")
    print(f"profile_capture: chrome trace + summary in {args.out} "
          f"({elapsed:.3f}s solve, {summary['us_per_iter']:.1f} us/iter)")
    return 0, {k: summary[k] for k in ("solve_seconds", "us_per_iter", "iterations")}


if __name__ == "__main__":
    sys.exit(main()[0])
