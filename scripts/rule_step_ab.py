#!/usr/bin/env python3
"""Time the step rules' steps of the PyTorch port on one CUDA card, for the
``repro_torch`` package found under ``--src``: the lasso's step under each
rule ('classic', 'away', 'pairwise', 'partan', 'lazy') on the 'kernels'
backend at the paper's dense size (p = 4,272,227, m = 800, kappa = 1% of p,
uniform sampling, delta 50), by ``chip_smoke._rule_step_ms``: the host-clock
ms a step over a fixed run of 200 steps, the device busy ms and launches a
step by ``torch.profiler``, and for 'lazy' the median ms of its hit steps
and of its miss steps. The timing helpers are ``chip_smoke.py``'s.

To compare two versions on one card, run it once per checkout in one
command, in turns (A, B, B, A), each in its own process:

    python3 scripts/rule_step_ab.py --src src --tag change
    python3 scripts/rule_step_ab.py --src /path/to/other/checkout/src --tag parent

Prints the card's name and power limit, then one JSON line: the tag and,
per rule, its wall, busy and launches a step (and the lazy split). Needs a
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RULES = ("classic", "away", "pairwise", "partan", "lazy")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("rule_step_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import LASSO, engine
    from repro_torch.data import make_wide_problem
    from repro_torch.kernels import _build

    card = cs.card_line()
    _build.build()
    dev = torch.device("cuda")
    Xt, y, _ = make_wide_problem(cs.P_PAPER, cs.M_PAPER, cs.N_REL, seed=0, device=dev)
    base = cs.main_config(cs.P_PAPER, "kernels")
    stats = engine.precompute_colstats(Xt, y, base)
    delta = torch.tensor(50.0, device=dev)
    out = {"tag": args.tag, "src": str(Path(engine.__file__).resolve().parents[2])}
    for rule in RULES:
        cfg = dataclasses.replace(base, step_rule=rule)
        wall, busy, _, n_launch, split = cs._rule_step_ms(torch, LASSO, Xt, y, stats, cfg, delta)
        out[rule] = dict(wall_ms=wall, busy_ms=busy, launches=n_launch)
        line = f"[{args.tag}] {rule} step: wall {wall:.4f} ms, busy {busy} ms, {n_launch} launches"
        if split is not None:
            out[rule].update(hit_ms=split[0], hits=split[1], miss_ms=split[2], misses=split[3])
            line += (f"; a hit {split[0]:.4f} ms (median of {split[1]}), a miss "
                     f"{split[2]:.4f} ms (median of {split[3]})")
        print(line)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
