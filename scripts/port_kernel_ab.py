#!/usr/bin/env python3
"""Time two kernels of the PyTorch port on one CUDA card, for the
``repro_torch`` package found under ``--src``: K2's ``vertex_argmax`` at
kappa = 1% of p (uniform sampling) and at n = p (the 'full' sampling of a
paper-size dense point, blocks of 128), and K6's ``sparse_colstats`` over
the E2006-log1p proxy at its published size with the L2 flushed, beside
cuSPARSE's CSR SpMV on a copy. The timing helpers are ``chip_smoke.py``'s.

To compare two versions on one card, run it once per checkout in one
command, in turns (A, B, B, A), each in its own process:

    python3 scripts/port_kernel_ab.py --src src --tag change
    python3 scripts/port_kernel_ab.py --src /path/to/other/checkout/src --tag parent

Prints the card's name and power limit, then one JSON line: the tag and,
per kernel, its ms, plain ms, library ms, bound ms and bound's kind. Needs
a card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("port_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.data import PROXY_SPECS, make_sparse_wide_problem
    from repro_torch.kernels import _build
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_colstats as sc

    card = cs.card_line()
    _build.build(("fw_grad", "sparse_colstats"))
    dev = torch.device("cuda")
    out = {"tag": args.tag, "src": str(Path(fw.__file__).resolve().parents[2])}

    def record(name, t, note):
        bound_ms, bound_by = cs._bound(t["nbytes"], t["flops"])
        out[name] = dict(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t.get("library_ms"),
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"[{args.tag}] {name}: {t['ms']:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
              f"plain {t['plain_ms']:.6f} ms, library {t.get('library_ms')}{note}")

    p = cs.P_PAPER
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    kappa = kappa_fraction(p, 0.01)
    idx = TorchSampler(11, dev).uniform(kappa, p)
    scores = torch.randn(kappa, generator=g, device=dev)
    record("vertex_argmax_kappa", cs.vertex_argmax_times(torch, fw, scores, idx, 1, p),
           f" [n = kappa = {kappa}, width 1]")
    bs = 128
    blk = torch.arange(-(-p // bs), device=dev)
    scores = torch.randn(blk.numel() * bs, generator=g, device=dev)
    record("vertex_argmax_full", cs.vertex_argmax_times(torch, fw, scores, blk, bs, p, reps=200),
           f" [n = {scores.numel()}, {blk.numel()} blocks of {bs}, p_valid = {p}]")
    del scores

    spec = PROXY_SPECS["e2006-log1p"]
    mat, y, _ = make_sparse_wide_problem(spec.m, spec.p, spec.col_density, spec.n_relevant,
                                         seed=0, device=dev, block_size=cs.SPARSE_BLOCK)
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    t = cs.sparse_colstats_times(torch, sc, mat, y, flush)
    record("sparse_colstats", t, t["note"])
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
