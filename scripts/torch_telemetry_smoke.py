"""Telemetry smoke on the PyTorch port (``scripts/telemetry_smoke.py``'s
five gates, on the card).

Five gates, in order:

  1. Artifact gate: run ``scripts/torch_solver_report.py`` with a
     distributed run included (a (1, 4) mesh of 4 gloo ranks in a child
     process); it fails non-zero if the trace does not validate against
     the Perfetto trace_event schema subset.
  2. Schema re-check: load the written ``solver_trace.json`` and
     ``solver_report.json`` back from disk and validate them
     independently with the port's ``validate_chrome_trace``.
  3. Overhead gate: time the hot loop (the default config, as the
     reference's: here the 'kernels' backend, whose step tail writes the
     record inside its launch; p=2048, m=256, kappa=128, a fixed 400
     iterations) with telemetry off vs on (the default ring): the median
     ratio of 100 pairs of runs side by side (the reference takes the best
     wall of each side, which a shared host's drift upsets on a host-bound
     loop; a pair's ratio spreads over tens of percent there, so fewer
     pairs leave the median a few percent from the overhead), and fail if
     telemetry-on exceeds the budget: $REPRO_TELEMETRY_OVERHEAD_PCT
     (default 10).
  4. Exposition gate: run an instrumented solve with a metrics registry
     installed, scrape the live ``/metrics`` HTTP endpoint, and fail
     unless the OpenMetrics text passes the port's
     ``validate_openmetrics`` and holds the solve-latency histogram and
     its quantiles (the written ``metrics.txt`` ships as an artifact).
  5. Metrics-bridge overhead gate: the same hot loop, registry installed
     vs not (telemetry off on both sides: this isolates the host shim),
     budget $REPRO_METRICS_OVERHEAD_PCT (default the telemetry budget).

Usage: PYTHONPATH=src python scripts/torch_telemetry_smoke.py --out-dir reports [--device cpu]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO_ROOT, os.path.join(_REPO_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

OVERHEAD_PCT = float(os.environ.get("REPRO_TELEMETRY_OVERHEAD_PCT", "10"))
METRICS_OVERHEAD_PCT = float(os.environ.get("REPRO_METRICS_OVERHEAD_PCT", str(OVERHEAD_PCT)))


def _sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _hotloop(device, backend=None):
    """The gate's problem: (Xt, y, base config kwargs) on ``device``, on
    ``backend`` (None: the config's default)."""
    import numpy as np
    import torch

    from repro_torch.data import make_regression, standardize

    ds = standardize(make_regression(m=256, p=2048, n_informative=20, noise=0.5, seed=0))
    Xt = torch.as_tensor(np.asarray(ds.X.T, np.float32).copy(), device=device)
    y = torch.as_tensor(np.asarray(ds.y, np.float32), device=device)
    base = dict(delta=100.0, kappa=128, sampling="uniform", max_iters=400, tol=0.0,
                patience=10**9)
    if backend is not None:
        base["backend"] = backend
    return Xt, y, base


WARMUP = 3  # untimed pairs first: the kernels' build, the host's warm-up
PAIRS = 100  # timed pairs a gate: the median's spread ~1.5% on the card's host


def _paired_overhead(run_off, run_on, repeats: int):
    """The overhead of ``run_on`` over ``run_off`` in %: the median over
    ``repeats`` pairs of adjacent runs of the ratio on / off, the order in a
    pair alternating (off, on; on, off; ...), after WARMUP untimed pairs,
    the garbage collector off while a run is timed (as ``timeit`` times).
    The hot loop is host-bound and a shared host's speed drifts by tens of
    percent over a gate; two runs side by side see the same speed, so their
    ratio cancels it where the best wall of each side would not. Returns
    ``(overhead %, median off s, median on s)``."""
    ratios, offs, ons = _paired_runs(run_off, run_on, repeats)
    med = statistics.median
    return (med(ratios) - 1.0) * 100.0, med(offs), med(ons)


def _paired_runs(run_off, run_on, repeats: int):
    """``_paired_overhead``'s timed pairs: the lists ``(ratios on / off,
    off s, on s)``, one entry a pair."""
    def timed(run):
        gc.collect()
        gc.disable()
        try:
            _sync()
            t0 = time.perf_counter()
            run()
            _sync()
            return time.perf_counter() - t0
        finally:
            gc.enable()

    ratios, offs, ons = [], [], []
    for r in range(WARMUP + repeats):
        if r % 2:
            t_on, t_off = timed(run_on), timed(run_off)
        else:
            t_off, t_on = timed(run_off), timed(run_on)
        if r >= WARMUP:
            ratios.append(t_on / t_off)
            offs.append(t_off)
            ons.append(t_on)
    return ratios, offs, ons


def overhead_gate(device, repeats: int = PAIRS, backend=None) -> float:
    """Telemetry-on vs -off hot loop wall clock; returns the overhead in %."""
    from repro_torch.core import LASSO, FWConfig, TorchSampler, engine
    from repro_torch.obs import TelemetrySpec

    Xt, y, base = _hotloop(device, backend)

    def solve(cfg):
        return lambda: engine.solve(LASSO, Xt, y, cfg, TorchSampler(0, device), device=device)

    pct, t_off, t_on = _paired_overhead(
        solve(FWConfig(**base)), solve(FWConfig(**base, telemetry=TelemetrySpec(capacity=256))),
        repeats)
    print(f"# the hot loop: {1e3 * t_off:.3f} ms off, {1e3 * t_on:.3f} ms on (medians of "
          f"{repeats} pairs)")
    return pct


def exposition_gate(out_dir: str, device) -> int:
    """Scrape a live ``/metrics`` during instrumented solves; 0 on pass.

    Installs a registry, runs a plain solve plus a short batched sparse
    path (so the lane counters populate), scrapes the HTTP endpoint,
    validates the OpenMetrics text, and requires the families the
    dashboards key on. The scraped text goes to ``<out_dir>/metrics.txt``
    and the JSON snapshot beside it."""
    import math

    import numpy as np
    import torch

    from repro_torch.core import LASSO, FWConfig, TorchSampler, engine
    from repro_torch.core import path as fw_path_mod
    from repro_torch.data import make_regression, standardize
    from repro_torch.obs import (MetricsRegistry, MetricsServer, scrape, snapshot_json,
                                 use_registry, validate_openmetrics)
    from repro_torch.sparse.matrix import SparseBlockMatrix

    ds = standardize(make_regression(m=128, p=512, n_informative=10, noise=0.5, seed=1))
    Xs = np.asarray(ds.X.T, np.float32).copy()
    Xt = torch.as_tensor(Xs, device=device)
    y = torch.as_tensor(np.asarray(ds.y, np.float32), device=device)
    Xs[np.abs(Xs) < 1.0] = 0.0
    Xt_sparse = SparseBlockMatrix.from_dense(torch.from_numpy(Xs), block_size=128).to(device)
    cfg = FWConfig(delta=50.0, kappa=64, max_iters=120, tol=0.0, patience=10**9)

    reg = MetricsRegistry()
    with use_registry(reg):
        engine.solve(LASSO, Xt, y, cfg, TorchSampler(0, device), device=device)
        fw_path_mod.fw_path_batched(
            Xt_sparse, y, [2.0, 5.0, 10.0, 25.0],
            FWConfig(delta=1.0, kappa=64, max_iters=200, tol=1e-4, backend="sparse"),
            lane_width=4, device=device)
        with MetricsServer(registry=reg, port=0) as srv:
            text = scrape(srv.url)

    problems = validate_openmetrics(text)
    if problems:
        print("FAIL: /metrics exposition invalid:", *problems, sep="\n  ")
        return 1
    snap = snapshot_json(reg)
    fams = set(snap)
    want = {"fw_solves", "fw_iterations", "fw_solve_latency_seconds", "fw_lanes_admitted",
            "fw_lane_freezes"}
    if not want <= fams:
        print(f"FAIL: /metrics missing families: {sorted(want - fams)}")
        return 1
    lat = reg.get("fw_solve_latency_seconds")
    quants = [lat.quantile(q, **dict(key)) for key, _snap in lat.series() for q in (0.5, 0.99)]
    if not quants or any(math.isnan(v) for v in quants):
        print("FAIL: solve-latency p50/p99 quantiles empty or NaN")
        return 1
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.txt"), "w") as fh:
        fh.write(text)
    with open(os.path.join(out_dir, "metrics.json"), "w") as fh:
        json.dump(snap, fh, indent=1, sort_keys=True)
    print(f"# /metrics scrape valid: {len(fams)} families, p50/p99 solve latency populated")
    return 0


def bridge_overhead_gate(device, repeats: int = PAIRS, backend=None) -> float:
    """Registry-installed vs bare hot loop wall clock; returns the overhead
    in %. Telemetry stays off on both sides, so this isolates the metrics
    shim (one clock pair, a sync and a few dict updates a solve)."""
    from repro_torch.core import LASSO, FWConfig, TorchSampler, engine
    from repro_torch.obs import MetricsRegistry, use_registry

    Xt, y, base = _hotloop(device, backend)
    cfg = FWConfig(**base)

    def solve(registry):
        def run():
            if registry is None:
                engine.solve(LASSO, Xt, y, cfg, TorchSampler(0, device), device=device)
            else:
                with use_registry(registry):
                    engine.solve(LASSO, Xt, y, cfg, TorchSampler(0, device), device=device)
        return run

    pct, t_off, t_on = _paired_overhead(solve(None), solve(MetricsRegistry()), repeats)
    print(f"# the hot loop: {1e3 * t_off:.3f} ms bare, {1e3 * t_on:.3f} ms with the registry "
          f"(medians of {repeats} pairs)")
    return pct


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="reports")
    ap.add_argument("--skip-distributed", action="store_true",
                    help="drop the 4-rank child process run")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--repeats", type=int, default=PAIRS,
                    help="timed pairs of runs of each overhead gate (the median ratio counts)")
    ap.add_argument("--hotloop-backend", default=None, choices=("torch", "kernels"),
                    help="the overhead gates' backend (default: the config's, 'kernels')")
    args = ap.parse_args(argv)

    import scripts.torch_solver_report as solver_report
    from repro_torch.core import engine
    from repro_torch.obs import validate_chrome_trace

    dev = engine.resolve_device(args.device)
    numbers = {}
    # 1. traced solves -> report + trace artifacts (validated inside)
    report_args = ["--out-dir", args.out_dir, "--backends", "torch,sparse", "--iters", "150",
                   "--p", "512", "--m", "128", "--device", args.device]
    if not args.skip_distributed:
        report_args.append("--distributed")
    rc, numbers["report"] = solver_report.main(report_args)
    if rc != 0:
        print("FAIL: solver_report did not produce a valid trace")
        return rc, numbers

    # 2. the on-disk artifacts must load and validate standalone
    with open(os.path.join(args.out_dir, "solver_trace.json")) as fh:
        errors = validate_chrome_trace(fh.read())
    if errors:
        print("FAIL: written trace invalid:", *errors, sep="\n  ")
        return 1, numbers
    with open(os.path.join(args.out_dir, "solver_report.json")) as fh:
        report = json.load(fh)
    backends = {run.get("backend") for run in report.get("runs", [])}
    want = {"torch", "sparse"} | (set() if args.skip_distributed else {"distributed"})
    if not want <= backends:
        print(f"FAIL: report missing backends: {sorted(want - backends)}")
        return 1, numbers
    print(f"# trace + report artifacts valid ({sorted(backends)})")

    # 3. the hot loop's overhead budget
    pct = overhead_gate(dev, args.repeats, args.hotloop_backend)
    numbers["telemetry_overhead_pct"] = pct
    print(f"# telemetry-on hotloop overhead: {pct:+.1f}% (budget {OVERHEAD_PCT:.0f}%)")
    if pct > OVERHEAD_PCT:
        print("FAIL: telemetry overhead exceeds budget")
        return 1, numbers

    # 4. OpenMetrics exposition over a live /metrics scrape
    rc = exposition_gate(args.out_dir, dev)
    if rc != 0:
        return rc, numbers

    # 5. the metrics bridge's overhead budget (registry on vs off)
    pct = bridge_overhead_gate(dev, args.repeats, args.hotloop_backend)
    numbers["metrics_overhead_pct"] = pct
    print(f"# metrics-bridge hotloop overhead: {pct:+.1f}% (budget {METRICS_OVERHEAD_PCT:.0f}%)")
    if pct > METRICS_OVERHEAD_PCT:
        print("FAIL: metrics-bridge overhead exceeds budget")
        return 1, numbers
    print("# telemetry smoke PASS")
    return 0, numbers


if __name__ == "__main__":
    sys.exit(main()[0])
