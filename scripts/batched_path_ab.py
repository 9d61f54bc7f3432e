#!/usr/bin/env python3
"""Time the batched path and the batched step of one oracle on one CUDA card,
for the ``repro_torch`` package found under ``--src``.

At the paper's sizes, as ``chip_smoke.py`` builds them (dense: p =
4,272,227, m = 800, f32; sparse: the E2006-log1p proxy at its published
size, blocks of 256), kappa = 1% of p, uniform sampling, unfused:

- the 100-point ``fw_path_batched`` in lanes of 13 over ``chip_smoke.py``'s
  grid (seed 0): wall seconds, lane-iterations, batched steps, and a
  sha256 digest of every point's integer facts and objective (two
  versions that step alike print the same digest);
- the batched step at 13 lanes (the path's 13 largest deltas, from zero,
  tol 0): host-clock ms a step from the difference of a 250- and a 50-step
  solve, and device-busy ms a step and the idle share from
  ``torch.profiler`` over a 60- and a 10-step solve;
- with ``--repeats N``, the path N times in turn (each wall printed), and
  with ``--path-only`` no batched step after it;
- with ``--profile``, instead, the path once more under ``torch.profiler``
  recording the device alone (CUPTI): its device-busy seconds against its
  wall, and each kernel's launches and mean device time over the path.

To compare two versions on one card, run it once per checkout in one
command, in turns (A, B, B, A), each in its own process:

    python3 scripts/batched_path_ab.py --src src --tag change --oracle en --layout dense
    python3 scripts/batched_path_ab.py --src /path/to/parent/src --tag parent --oracle en --layout dense

Prints the card's name and power limit, a line a measurement and one JSON
line. Needs a card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--oracle", choices=("en", "lasso"), default="en")
    ap.add_argument("--layout", choices=("dense", "sparse"), default="dense")
    ap.add_argument("--repeats", type=int, default=1, help="times the path runs")
    ap.add_argument("--path-only", action="store_true", help="time no batched step")
    ap.add_argument("--profile", action="store_true",
                    help="profile the path's kernels instead of timing the batched step")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("batched_path_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import LASSO, ENOracle, LaneSampler, delta_grid, engine
    from repro_torch.core import fw_path_batched
    from repro_torch.data import PROXY_SPECS, make_sparse_wide_problem, make_wide_problem
    from repro_torch.kernels import _build

    card = cs.card_line()
    print(card)
    _build.build()
    dev = torch.device("cuda")
    if args.layout == "dense":
        design, y, coef = make_wide_problem(cs.P_PAPER, cs.M_PAPER, cs.N_REL, seed=0, device=dev)
        cfg = cs.main_config(design.shape[0], "kernels")
    else:
        spec = PROXY_SPECS["e2006-log1p"]
        design, y, coef = make_sparse_wide_problem(spec.m, spec.p, spec.col_density,
                                                   spec.n_relevant, seed=0, device=dev,
                                                   block_size=cs.SPARSE_BLOCK)
        cfg = cs.sparse_config(design.shape[0], fuse_steps=1)
    oracle = ENOracle(l2=cs.EN_L2) if args.oracle == "en" else LASSO
    deltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=cs.N_POINTS)
    L = cs.LANE_WIDTH
    out = {"tag": args.tag, "oracle": args.oracle, "layout": args.layout, "card": card}
    label = f"[{args.tag}] {args.oracle} {args.layout}"

    walls = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = [0]

        def counted(*a):
            return engine.solve_batched_prepared(*a, on_step=lambda s, act: steps.__setitem__(
                0, steps[0] + 1))

        res = fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=L, oracle=oracle,
                              device=dev, solve_batched_fn=counted)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        h = hashlib.sha256()
        for pt in res.points:
            h.update(repr((pt.iterations, pt.n_dots, pt.active, pt.objective)).encode())
        print(f"{label} path: {wall:.3f} s wall ({res.total_seconds:.3f} s as the path reports "
              f"it), {res.total_iters} lane-iterations, {steps[0]} batched steps, "
              f"{1e3 * wall / steps[0]:.4f} ms a batched step, digest {h.hexdigest()[:16]}")
    out.update(path_s=walls[0], path_walls_s=walls, path_reported_s=res.total_seconds,
               lane_iterations=res.total_iters, batched_steps=steps[0], digest=h.hexdigest())
    if args.path_only:
        print(json.dumps(out))
        return 0

    if args.profile:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=L, oracle=oracle,
                            device=dev)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        busy_s = sum(e.self_device_time_total for e in rows) / 1e6
        kernels = {e.key[:60]: dict(count=e.count, mean_us=e.self_device_time_total / e.count)
                   for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]}
        out.update(profiled_path_s=pwall, profiled_busy_s=busy_s, kernels=kernels)
        print(f"{label} path under the profiler: {pwall:.3f} s wall, device busy {busy_s:.3f} s "
              f"(idle {100 * (1 - busy_s / pwall):.1f}%)")
        for k, v in kernels.items():
            print(f"{label}   {k}: {v['count']} launches, {v['mean_us']:.3f} us each")
        print(json.dumps(out))
        return 0

    top = torch.tensor(list(deltas[-L:]), device=dev)
    stats = engine.precompute_colstats(design, y, cfg)

    def run(n_steps, seed):
        bcfg = dataclasses.replace(cfg, max_iters=n_steps, tol=0.0, patience=10**9)
        engine.solve_batched_prepared(oracle, design, y, bcfg, LaneSampler(seed, L, dev), None,
                                      top)

    run(20, 1)  # warm-up
    walls = {}
    for n in (250, 50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n, 3)
        torch.cuda.synchronize()
        walls[n] = time.perf_counter() - t0
    step_wall = (walls[250] - walls[50]) * 1e3 / 200
    busy = {}
    for n in (60, 10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(n, 5)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        busy[n] = sum(e.self_device_time_total for e in rows) / 1e3
    step_busy = (busy[60] - busy[10]) / 50
    out.update(step_wall_ms=step_wall, step_busy_ms=step_busy,
               idle=1 - step_busy / step_wall if step_busy > 0 else None)
    del stats
    print(f"{label} batched step ({L} lanes): wall {step_wall:.4f} ms, device busy "
          f"{step_busy:.4f} ms, idle {100 * (1 - step_busy / step_wall):.1f}%")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
