#!/usr/bin/env python3
"""Time deepseek-7b's greedy decode step at its full config in bf16 on one
CUDA card, for the ``repro_torch`` package found under ``--src``: the shape
of ``chip_smoke.py``'s ``phase_serve`` (batch SERVE_BATCH, a prompt of
SERVE_PROMPT tokens, weights from seed 0), one prefill, DECODE_WARM
untimed steps, then DECODE_TIMED steps, each timed on the host clock with
the card synchronized after it. The decode step is host-bound (most of it
is Python and launches), so a version's per-call host work shows here.

To compare two versions on one card, run it once per checkout in one
command, in turns (A, B, B, A), each in its own process:

    python3 scripts/serve_decode_ab.py --src src --tag change
    python3 scripts/serve_decode_ab.py --src /path/to/other/checkout/src --tag parent

Prints the card's name and power limit, then one JSON line: the tag, the
median, 10th percentile, min and max step ms and the prefill seconds.
Needs a card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECODE_WARM = 3
DECODE_TIMED = 200


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("serve_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import set_matmul_precision, synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.training import make_serve_step

    card = cs.card_line()
    set_matmul_precision()
    dev = torch.device("cuda")
    cfg = get_config("deepseek_7b")
    model = M.init_params(0, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = synthetic_batch(cfg, cs.SERVE_BATCH, cs.SERVE_PROMPT, gen)
    max_seq = cs.SERVE_PROMPT + DECODE_WARM + DECODE_TIMED + 8
    serve = make_serve_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(model, batch, cfg, max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    steps = []
    for i in range(DECODE_WARM + DECODE_TIMED):
        t0 = time.perf_counter()
        tok, _, cache = serve(model, tok, cache)
        torch.cuda.synchronize()
        if i >= DECODE_WARM:
            steps.append((time.perf_counter() - t0) * 1e3)
    steps.sort()
    print(f"card: {card}")
    print(json.dumps({"tag": args.tag, "src": str(Path(M.__file__).resolve().parents[2]),
                      "batch": cs.SERVE_BATCH, "prompt": cs.SERVE_PROMPT,
                      "step_ms_median": steps[len(steps) // 2],
                      "step_ms_p10": steps[len(steps) // 10], "step_ms_min": steps[0],
                      "step_ms_max": steps[-1], "steps": len(steps), "prefill_s": prefill_s}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
