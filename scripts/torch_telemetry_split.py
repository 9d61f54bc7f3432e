"""Split the telemetry ring's cost on the hot loop of
``scripts/torch_telemetry_smoke.py`` (p=2048, m=256, kappa=128, 400 steps)
into host work, waits on the card and the card's own kernel time.

For the ring off and on (``TelemetrySpec(capacity=256)``):

  1. ``rounds`` rounds of ``pairs`` pairs of solves side by side, each
     round's median ratio (the smoke's overhead gate) and the quartiles of
     all the rounds' ratios;
  2. each solve's wall split into the host's waits on the stall read (the
     one sync a step, ``engine._host_stall``) and the rest, the host's own
     work;
  3. one solve under ``torch.profiler``: the card's kernel time and launch
     count (``--no-profiler`` skips it);
  4. one solve under ``cProfile``: the host functions whose own time or
     call count differs most between the two.

Usage: PYTHONPATH=src python scripts/torch_telemetry_split.py [--device cpu] [--pairs 30]
  [--rounds 3] [--pairs-only] [--src <checkout>/src --tag <name>]
"""
from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import statistics
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO_ROOT, os.path.join(_REPO_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
if "--src" in sys.argv:  # another checkout's port, for A/B runs in turns
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--src") + 1]))


def _device_time_ms(prof) -> tuple:
    """(kernel ms, kernel launches) of a profiler capture's device events."""
    total_us, n = 0.0, 0
    for ev in prof.events():
        dev_type = str(getattr(ev, "device_type", ""))
        if "CUDA" not in dev_type:
            continue
        total_us += getattr(ev, "device_time", None) or getattr(ev, "cuda_time", 0.0)
        n += 1
    return total_us / 1e3, n


def _profile_rows(pr: cProfile.Profile) -> dict:
    """{function: (calls, own seconds)} of a cProfile capture."""
    out = {}
    for (file, line, name), (cc, nc, tt, ct, callers) in pstats.Stats(pr).stats.items():
        key = f"{os.path.basename(file)}:{line}({name})"
        out[key] = (nc, tt)
    return out


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--pairs", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--pairs-only", action="store_true", help="stop after the rounds of pairs")
    ap.add_argument("--no-profiler", action="store_true")
    ap.add_argument("--src", default=None, help="the port's source tree to time")
    ap.add_argument("--tag", default="", help="a name for this run's lines")
    args = ap.parse_args(argv)

    import torch

    import scripts.torch_telemetry_smoke as smoke
    from repro_torch.core import LASSO, FWConfig, TorchSampler, engine
    from repro_torch.obs import TelemetrySpec

    dev = engine.resolve_device(args.device)
    Xt, y, base = smoke._hotloop(dev)
    cfgs = {"off": FWConfig(**base), "on": FWConfig(**base, telemetry=TelemetrySpec(capacity=256))}

    def solve(name):
        return engine.solve(LASSO, Xt, y, cfgs[name], TorchSampler(0, dev), device=dev)

    numbers = {"rounds": []}
    ratios = []
    tag = f"[split{' ' + args.tag if args.tag else ''}]"
    med = statistics.median
    for _ in range(args.rounds):
        seen, offs, ons = smoke._paired_runs(lambda: solve("off"), lambda: solve("on"),
                                             args.pairs)
        pct, t_off, t_on = 100.0 * (med(seen) - 1.0), med(offs), med(ons)
        ratios.extend(seen)
        numbers["rounds"].append(pct)
        print(f"{tag} paired: off {1e3 * t_off:.3f} ms, on {1e3 * t_on:.3f} ms, {pct:+.2f}% "
              f"(median of {args.pairs} pairs)")
    q = statistics.quantiles([100.0 * (r - 1.0) for r in ratios], n=4)
    numbers["quartiles_pct"] = q
    print(f"{tag} the {len(ratios)} pairs' overheads: quartiles {q[0]:+.2f}% {q[1]:+.2f}% "
          f"{q[2]:+.2f}%, min {100 * (min(ratios) - 1):+.2f}%, max {100 * (max(ratios) - 1):+.2f}%")
    if args.pairs_only:
        return 0, numbers

    # the waits on the stall read against the host's own work
    waits = [0.0]
    host_stall = engine._host_stall

    def timed_stall(state):
        t0 = time.perf_counter()
        try:
            return host_stall(state)
        finally:
            waits[0] += time.perf_counter() - t0

    engine._host_stall = timed_stall
    try:
        split = {"off": [], "on": []}
        for r in range(2 * args.pairs):
            for name in (("off", "on") if r % 2 == 0 else ("on", "off")):
                smoke._sync()
                waits[0] = 0.0
                t0 = time.perf_counter()
                solve(name)
                smoke._sync()
                wall = time.perf_counter() - t0
                split[name].append((wall - waits[0], waits[0]))
    finally:
        engine._host_stall = host_stall
    for name in ("off", "on"):
        host = statistics.median(h for h, _ in split[name])
        wait = statistics.median(w for _, w in split[name])
        numbers[f"host_{name}_ms"], numbers[f"wait_{name}_ms"] = 1e3 * host, 1e3 * wait
        print(f"{tag} {name}: host {1e3 * host:.3f} ms, waits {1e3 * wait:.3f} ms "
              f"(medians of {2 * args.pairs} solves)")

    if not args.no_profiler and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        for name in ("off", "on"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                solve(name)
                smoke._sync()
            ms, n = _device_time_ms(prof)
            numbers[f"device_{name}_ms"], numbers[f"launches_{name}"] = ms, n
            print(f"{tag} {name}: device kernels {ms:.3f} ms, {n} launches (one solve)")

    rows = {}
    for name in ("off", "on"):
        solve(name)
        pr = cProfile.Profile()
        pr.enable()
        solve(name)
        pr.disable()
        rows[name] = _profile_rows(pr)
    keys = set(rows["off"]) | set(rows["on"])
    diff = sorted(keys, key=lambda k: -(rows["on"].get(k, (0, 0.0))[1]
                                        - rows["off"].get(k, (0, 0.0))[1]))
    print(f"{tag} cProfile, own time on - off (ms), calls off -> on:")
    for k in diff[:25]:
        n0, t0 = rows["off"].get(k, (0, 0.0))
        n1, t1 = rows["on"].get(k, (0, 0.0))
        print(f"{tag}   {1e3 * (t1 - t0):+8.3f}  {n0:6d} -> {n1:6d}  {k}")
    tot = {name: sum(t for _, t in rows[name].values()) for name in rows}
    print(f"{tag} cProfile totals: off {1e3 * tot['off']:.3f} ms, on {1e3 * tot['on']:.3f} ms")
    return 0, numbers


if __name__ == "__main__":
    sys.exit(main()[0])
