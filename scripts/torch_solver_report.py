"""Solver run-report CLI on the PyTorch port (``scripts/solver_report.py``'s
run, on the card).

Runs a small traced lasso solve per requested backend with the telemetry
ring on, then renders the artifacts:

    <out-dir>/solver_report.md      human-facing markdown report
    <out-dir>/solver_report.json    the same data, machine-readable
    <out-dir>/solver_trace.json     Chrome/Perfetto trace_event JSON

Usage (from the repo root):

    PYTHONPATH=src python scripts/torch_solver_report.py --out-dir reports
    PYTHONPATH=src python scripts/torch_solver_report.py --backends torch,sparse \\
        --distributed --iters 300 --device cpu

``--distributed`` adds a run on a (1, 4) mesh of 4 gloo ranks, spawned in
a child process with a time limit (this process keeps its own state; on
the card the 4 ranks share it), with the analytic per-iteration
communication fraction.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO_ROOT, os.path.join(_REPO_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

DIST_TIMEOUT_S = int(os.environ.get("REPRO_SUBPROC_TIMEOUT", "900"))


def build_problem(m: int, p: int, seed: int = 0):
    import numpy as np

    from repro_torch.data import make_regression, standardize

    ds = standardize(make_regression(m=m, p=p, n_informative=20, noise=0.5, seed=seed))
    Xs = np.asarray(ds.X.T, np.float32).copy()
    y = np.asarray(ds.y, np.float32)
    return Xs, y


def _sparsify(Xs):
    Xsp = Xs.copy()
    Xsp[abs(Xsp) < 0.04] = 0.0
    return Xsp


def _cfg(args, backend: str):
    from repro_torch.core import FWConfig
    from repro_torch.obs import TelemetrySpec

    return FWConfig(
        delta=args.delta,
        kappa=args.kappa,
        sampling="uniform",
        max_iters=args.iters,
        tol=0.0,
        patience=10**9,
        backend=backend,
        step_rule=args.rule,
        telemetry=TelemetrySpec(capacity=args.iters),
    )


def _sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def run_backend(backend: str, Xs, y, args) -> dict:
    """One traced, telemetry-on solve; returns a report ``runs`` entry."""
    import torch

    from repro_torch.core import LASSO, TorchSampler, engine
    from repro_torch.obs import ring_to_records, trace as obs_trace
    from repro_torch.sparse.matrix import SparseBlockMatrix

    dev = engine.resolve_device(args.device)
    if backend == "sparse":
        A = SparseBlockMatrix.from_dense(torch.from_numpy(_sparsify(Xs)), block_size=32).to(dev)
    else:
        A = torch.as_tensor(Xs, device=dev)
    yt = torch.as_tensor(y, device=dev)
    cfg = _cfg(args, backend)
    tracer = obs_trace.get_tracer()
    with tracer.span(f"report/compile_{backend}", cat="report"):  # the kernels' first build
        engine.solve(LASSO, A, yt, cfg, TorchSampler(args.seed, dev), device=dev)
        _sync()
    t0 = time.perf_counter()
    with tracer.span(f"report/solve_{backend}", cat="report"):
        res = engine.solve(LASSO, A, yt, cfg, TorchSampler(args.seed, dev), device=dev)
        _sync()
    dt = time.perf_counter() - t0
    records = ring_to_records(res.telemetry)
    return {
        "name": f"lasso_{backend}",
        "backend": backend,
        "iterations": int(res.iterations),
        "n_dots": int(res.n_dots),
        "objective": float(res.objective),
        "seconds": dt,
        "ring": {k: v.tolist() for k, v in records.items()},
    }


# -- distributed child ------------------------------------------------------

_DIST_CHILD_FLAG = "--_dist-child"


def _dist_rank(rank: int, args, workdir: str) -> None:
    """One of the child's 4 gloo ranks: the (1, 4) mesh, one traced
    distributed solve, rank 0's run entry written as JSON."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch import distributed as dist
    from repro_torch.core import LASSO, TorchSampler
    from repro_torch.obs import ring_to_records
    from repro_torch.sparse.matrix import SparseBlockMatrix

    torch.set_num_threads(1)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "init"),
                             world_size=4, rank=rank)
    Xs, y = build_problem(args.m, args.p, args.seed)
    mat = SparseBlockMatrix.from_dense(torch.from_numpy(_sparsify(Xs)), block_size=32)
    mesh = dist.fw_mesh(1, 4)
    op = dist.shard_sparse(mat, np.asarray(y), mesh, device=dev)
    cfg = _cfg(args, "torch")  # the driver swaps in backend='distributed'
    dist.solve(LASSO, op, cfg, TorchSampler(args.seed, dev))
    _sync()
    t0 = time.perf_counter()
    res = dist.solve(LASSO, op, cfg, TorchSampler(args.seed, dev))
    _sync()
    dt = time.perf_counter() - t0
    # the analytic per-iteration communication: the |S| scores' all_reduce
    # over both axes, the (m_local,) column's over "model", and the O(1)
    # scalars of the oracle's recursions
    comm = 4 * (args.kappa + op.m_local + 8)
    local = 8 * args.kappa * op.nnz_max + 4 * 4 * op.m_local
    if rank == 0:
        entry = {
            "name": "lasso_distributed_1x4",
            "backend": "distributed",
            "iterations": int(res.iterations),
            "n_dots": int(res.n_dots),
            "objective": float(res.objective),
            "seconds": dt,
            "comm_fraction": comm / (comm + local),
            "ring": {k: v.tolist() for k, v in ring_to_records(res.telemetry).items()},
        }
        with open(os.path.join(workdir, "entry.json"), "w") as fh:
            json.dump(entry, fh)
    tdist.barrier()
    tdist.destroy_process_group()


def _dist_child(args) -> None:
    """Child body: 4 gloo ranks spawned, rank 0's entry printed as JSON on
    stdout (a REPORTRESULT line)."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as workdir:
        mp.spawn(_dist_rank, args=(args, workdir), nprocs=4, join=True)
        with open(os.path.join(workdir, "entry.json")) as fh:
            print("REPORTRESULT" + fh.read(), flush=True)


def run_distributed(args):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    cmd = [sys.executable, os.path.abspath(__file__), _DIST_CHILD_FLAG,
           "--m", str(args.m), "--p", str(args.p), "--iters", str(args.iters),
           "--kappa", str(args.kappa), "--delta", str(args.delta),
           "--rule", args.rule, "--seed", str(args.seed), "--device", args.device]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DIST_TIMEOUT_S, env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPORTRESULT")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"distributed child failed (rc={proc.returncode}): "
                           f"{proc.stderr[-800:]}")
    return json.loads(lines[0][len("REPORTRESULT"):])


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="reports")
    ap.add_argument("--backends", default="torch,kernels,sparse",
                    help="comma-separated: torch,kernels,sparse")
    ap.add_argument("--distributed", action="store_true",
                    help="add a (1,4)-mesh run of 4 gloo ranks (a child process)")
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--p", type=int, default=512)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--kappa", type=int, default=48)
    ap.add_argument("--delta", type=float, default=100.0)
    ap.add_argument("--rule", default="classic")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument(_DIST_CHILD_FLAG, action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if getattr(args, "_dist_child"):
        _dist_child(args)
        return 0, {}

    from repro_torch.core import engine
    from repro_torch.obs import build_report, default_meta, trace as obs_trace, write_report

    engine.resolve_device(args.device)
    tracer = obs_trace.Tracer("solver-report")
    runs = []
    with obs_trace.use_tracer(tracer):
        Xs, y = build_problem(args.m, args.p, args.seed)
        for backend in [b for b in args.backends.split(",") if b]:
            print(f"# running {backend} ...", flush=True)
            runs.append(run_backend(backend, Xs, y, args))
        if args.distributed:
            print("# running distributed (1,4) mesh ...", flush=True)
            runs.append(run_distributed(args))

    meta = default_meta(m=args.m, p=args.p, iters=args.iters, kappa=args.kappa, rule=args.rule)
    report = build_report(meta=meta, runs=runs, tracer=tracer)
    paths = write_report(args.out_dir, report)
    trace_path = tracer.save(os.path.join(args.out_dir, "solver_trace.json"))
    numbers = {run["name"]: {k: run[k] for k in ("iterations", "n_dots", "objective", "seconds")}
               for run in runs}
    errors = obs_trace.validate_chrome_trace(tracer.to_chrome())
    if errors:
        print("trace validation FAILED:", *errors, sep="\n  ")
        return 1, numbers
    print(f"# wrote {paths['markdown']}")
    print(f"# wrote {paths['json']}")
    print(f"# wrote {trace_path} (Perfetto-loadable)")
    return 0, numbers


if __name__ == "__main__":
    sys.exit(main()[0])
