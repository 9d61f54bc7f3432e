"""Replay the reference's stream through the port's sparse PARTAN (ROADMAP.md
S1): the acceptance design, its block-ELL arrays and the reference engine's
legacy-mode index stream from ``scripts/s1_reference_stream.py``'s
``.npz``, solved by ``engine.solve(LASSO, ...)`` with ``step_rule='partan'``
on the 'sparse' backend on each device given (the card launches the
kernels; the CPU runs their plain versions). Prints each run's iterations,
objective and certified gap beside the reference bar (gap <= 1e-4 *
objective) and the reference's own run; imports nothing of JAX:

    PYTHONPATH=src python scripts/s1_partan_replay.py --stream build/s1_stream.npz \
        --devices cpu cuda
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import LASSO, FWConfig, engine

GAP_REL_TOL = 1e-4  # the reference's certify bar


def replay(data, device):
    p, m, block, nnz_max = (int(v) for v in data["shape"])
    mat = convert.sparse_from_reference(data["values"], data["rows"], p, m, block, nnz_max,
                                        device)
    y = torch.from_numpy(data["y"]).to(device)
    delta = float(data["delta"])
    cfg = FWConfig(delta=delta, kappa=data["draws"].shape[1], sampling="uniform",
                   max_iters=data["draws"].shape[0], tol=1e-4, patience=20,
                   step_rule="partan", backend="sparse")
    res = engine.solve(LASSO, mat, y, cfg, convert.stream_from_reference(data["draws"], device),
                       device=device)
    gap = float(LASSO.gap(mat, y, res.alpha, torch.tensor(delta, device=device)))
    return res, gap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", required=True, help="scripts/s1_reference_stream.py's .npz")
    ap.add_argument("--devices", nargs="+", default=["cuda"])
    args = ap.parse_args(argv)
    data = np.load(args.stream)
    print(f"reference: {int(data['ref_iterations'])} iterations, objective "
          f"{float(data['ref_objective'])!r}, certified gap {float(data['ref_gap'])!r}")
    if "cuda" in args.devices:
        out = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no CUDA device"
        print(f"card: {out}")
    alphas = {}
    for dev in args.devices:
        res, gap = replay(data, dev)
        obj = float(res.objective)
        bar = GAP_REL_TOL * obj
        alphas[dev] = res.alpha.cpu()
        print(f"port on {dev}: {res.iterations} iterations, converged {bool(res.converged)}, "
              f"objective {obj!r}, certified gap {gap!r}, bar {bar!r}: "
              f"{'met' if gap <= bar else 'MISSED'}")
    if len(alphas) == 2:
        a, b = alphas.values()
        print(f"the two devices' alphas: max |difference| {float((a - b).abs().max())!r}, "
              f"supports {int(torch.count_nonzero(a))} and {int(torch.count_nonzero(b))}")


if __name__ == "__main__":
    main()
