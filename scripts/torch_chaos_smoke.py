"""Chaos smoke on the PyTorch port: inject the recovery matrix's faults and
verify the healing (``scripts/chaos_smoke.py``'s matrix, on the card).

Runs small solver problems under every fault family with
``REPRO_FAULT_SEED`` pinned, checks each one healed (or resumed)
correctly, and writes the metrics-registry snapshot (injected-fault
counts, guard trips and recoveries, shard retry counters, path
checkpoint events) as a JSON artifact.

Scenarios (small problems, one process), the reference's five:
  * co-state NaN  -> the rung-1 rebuild heals; objective matches the clean run;
  * beta NaN      -> the rung-2 chunk retry heals bit for bit (on the card,
                     whose fused chunk the per-step retry rounds apart from,
                     the same iterations and the objective to rounding);
  * shard byte corruption -> the manifest's sha256 and a retry heal the read;
  * mid-path kill -> checkpoint/resume replays bit for bit;
  * no-fault resilient run == plain engine run bit for bit;
and the port's recorded difference at rung 3 (rung 2 made to fail by a
patch for the scenario): on the CPU the ladder falls back to the plain
route, as the reference's does; on the card it ends at rung 2 and raises
``UnrecoverableFaultError`` (``tests/test_torch_gpu.py::
test_rung_3_raises_on_the_card``), which this scenario expects there.

Exit 0 when every scenario healed (or raised where it must); 1 otherwise.

Usage:
  PYTHONPATH=src python scripts/torch_chaos_smoke.py [--out reports/chaos_metrics.json]
  PYTHONPATH=src python scripts/torch_chaos_smoke.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO_ROOT, os.path.join(_REPO_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import engine, fw_lasso, path as path_lib  # noqa: E402
from repro_torch.core.solver_config import FWConfig  # noqa: E402
from repro_torch.core.vertex import TorchSampler  # noqa: E402
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.resilience import faults, guards  # noqa: E402
from repro_torch.sparse import io as sio  # noqa: E402


def _problem(seed=0, p=60, m=40):
    rng = np.random.default_rng(seed)
    Xd = (rng.normal(size=(m, p)) * (rng.random(size=(m, p)) < 0.4)).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    return Xd, y


def _poisoned_retry(oracle, Xt, y, stats, state, cfg, delta, n_turns, sampler, turns=None):
    """Rung 2's chunk retry with its beta come back NaN: the ladder's next
    rung must take over."""
    out = guards._advance(oracle, Xt, y, stats, state, cfg, delta, n_turns, sampler, True, turns)
    return out._replace(beta=torch.full_like(out.beta, float("nan")))


def _rung_3(Xt, y, seed: int, dev) -> bool:
    """Rung 2 made to fail on the kernels' backend: the CPU falls back to
    the plain route and finishes finite; the card raises."""
    cfg = FWConfig(max_iters=200, delta=2.0, tol=0.0, patience=10**9, fuse_steps=8,
                   backend="kernels")
    plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=1)], seed=seed)
    saved = guards._retry_chunk
    guards._retry_chunk = _poisoned_retry
    try:
        with faults.inject(plan):
            res = guards.solve_resilient(fw_lasso.LASSO, Xt, y, cfg, TorchSampler(0, dev),
                                         device=dev)
    except guards.UnrecoverableFaultError:
        return dev.type == "cuda"
    finally:
        guards._retry_chunk = saved
    return dev.type == "cpu" and bool(torch.isfinite(res.alpha).all())


def run_scenarios(seed: int, device) -> dict:
    """Returns {scenario: bool} under the ambient metrics registry."""
    dev = engine.resolve_device(device)
    results = {}
    Xd, y = _problem(6)
    Xt = torch.as_tensor(np.ascontiguousarray(Xd.T), device=dev)
    yt = torch.as_tensor(y, device=dev)
    cfg = FWConfig(max_iters=200, delta=2.0, tol=0.0, patience=10**9, fuse_steps=8)
    ref = engine.solve(fw_lasso.LASSO, Xt, yt, cfg, TorchSampler(0, dev), device=dev)

    # no-fault parity
    res = guards.solve_resilient(fw_lasso.LASSO, Xt, yt, cfg, TorchSampler(0, dev), device=dev)
    results["no_fault_parity"] = bool(torch.equal(ref.alpha, res.alpha))

    # co_nan -> rung-1 rebuild
    plan = faults.FaultPlan([faults.FaultSpec(kind="co_nan", at=1)], seed=seed)
    with faults.inject(plan):
        res = guards.solve_resilient(fw_lasso.LASSO, Xt, yt, cfg, TorchSampler(0, dev),
                                     device=dev)
    results["co_nan_healed"] = bool(
        plan.fired("co_nan") and np.isfinite(float(res.objective))
        and abs(float(res.objective) - float(ref.objective)) <= 1e-4 * abs(float(ref.objective)))

    # beta_nan -> rung-2 retry, bit for bit where the chunk runs as unfused
    # steps anyway (the CPU); on the card the retry's per-step route rounds
    # apart from the fused kernel's chunk, so the same iterations and the
    # objective to rounding (tests/test_torch_gpu.py::
    # test_guarded_solve_is_the_unguarded_one_on_the_card holds the same)
    plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=1)], seed=seed)
    with faults.inject(plan):
        res = guards.solve_resilient(fw_lasso.LASSO, Xt, yt, cfg, TorchSampler(0, dev),
                                     device=dev)
    same = (torch.equal(ref.alpha, res.alpha) if dev.type == "cpu" else
            res.iterations == ref.iterations
            and abs(float(res.objective) - float(ref.objective))
            <= 1e-5 * abs(float(ref.objective)))
    results["beta_nan_bitident"] = bool(plan.fired("beta_nan") and same)

    # shard corruption -> checksum + retry heal
    with tempfile.TemporaryDirectory() as d:
        r, c = np.nonzero(Xd)
        coo = sio.COOData(r.astype(np.int64), c.astype(np.int64), Xd[r, c].astype(np.float32),
                          y, Xd.shape)
        sio.write_shards(d, coo, rows_per_shard=16)
        mf = sio.read_manifest(d)
        clean = sio.load_shards(d)
        plan = faults.FaultPlan([faults.FaultSpec(kind="shard_corrupt", site=mf["shards"][0])],
                                seed=seed)
        with faults.inject(plan):
            healed = sio.load_shards(d)
        results["shard_corrupt_healed"] = bool(plan.fired("shard_corrupt")
                                               and np.array_equal(clean.vals, healed.vals))

    # mid-path kill -> checkpoint/resume bit for bit
    deltas = np.geomspace(0.5, 3.0, 6)
    pcfg = FWConfig(max_iters=100, delta=1.0, tol=0.0, patience=10**9, fuse_steps=4)
    clean_path = path_lib.fw_path(Xt, yt, deltas, pcfg, seed=5, device=dev)
    with tempfile.TemporaryDirectory() as ck:
        plan = faults.FaultPlan([faults.FaultSpec(kind="kill", at=3)], seed=seed)
        killed = False
        try:
            with faults.inject(plan):
                path_lib.fw_path(Xt, yt, deltas, pcfg, seed=5, device=dev, checkpoint_dir=ck)
        except faults.InjectedKill:
            killed = True
        resumed = path_lib.fw_path(Xt, yt, deltas, pcfg, seed=5, device=dev, checkpoint_dir=ck,
                                   resume_from=ck)
    results["kill_resume_bitident"] = bool(
        killed and len(resumed.points) == len(clean_path.points)
        and all(np.array_equal(a.alpha_nnz_val, b.alpha_nnz_val)
                and np.array_equal(a.alpha_nnz_idx, b.alpha_nnz_idx) and a.n_dots == b.n_dots
                for a, b in zip(clean_path.points, resumed.points)))

    # rung 3: the CPU falls back, the card raises (the port's recorded difference)
    results["rung_3_cpu_fallback_card_raise"] = _rung_3(Xt, yt, seed, dev)
    return results


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="reports/chaos_metrics.json",
                    help="metrics snapshot artifact path")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    seed = int(os.environ.get(faults.ENV_SEED, "0"))
    reg = obs_metrics.MetricsRegistry()
    with obs_metrics.use_registry(reg):
        results = run_scenarios(seed, args.device)
    payload = {"fault_seed": seed, "scenarios": results, "all_healed": all(results.values()),
               "metrics": obs_export.snapshot_json(reg)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wt") as fh:
        json.dump(payload, fh, indent=2)
    for name, ok in sorted(results.items()):
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
    print(f"chaos smoke: {'all healed' if payload['all_healed'] else 'FAILURES'}"
          f" (seed={seed}) -> {args.out}")
    return (0 if payload["all_healed"] else 1), results


if __name__ == "__main__":
    sys.exit(main()[0])
