"""The port's distributed backend (``repro_torch.distributed``) against the
reference's (``repro.distributed``) on the CPU: the mirror of
``tests/test_distributed.py`` (17 cases) and of
``tests/test_resilience.py::TestDistributedRecovery`` (5 cases), and unit
tests of the plain versions of the backend's kernels.

The reference runs once, in a subprocess on 4 virtual CPU devices (as its
own test does, so this process keeps one device); it writes its results,
the problems and its index streams (drawn in the same subprocess from the
same key chain its engine splits: ``key, sub = split(key)`` then the draw)
to a work directory. The port then runs once on 4 gloo ranks
(``torch.multiprocessing.spawn`` with a ``file://`` init, one CPU thread a
rank), each rank replaying those streams through ``StreamSampler``; each
rank writes its results, which the tests read. Both runs sit in
module-scoped fixtures, each with its own time limit.

Tolerances, and why:
  * on a ``(1, 4)`` mesh (one data slice) the port's mesh run is its
    single-device run bit for bit: alpha, iterations, n_dots (each score
    and each column add exact zeros from the ranks that do not own the
    feature); against the reference's mesh run the integer facts are
    exact and the objective within rtol 1e-5;
  * on ``(2, 2)`` (the samples split, so every sum over them is taken in
    another order) the reference test's own tolerances: objectives within
    rtol 1e-4 of the single-device run and of the reference's mesh run;
  * the ring's step facts are exact and its objective column within 2 ulp
    (the reference's bar for its own mesh ring);
  * the guarded solve with no fault, a killed and resumed path and a
    re-dispatched solve: bit for bit the plain mesh run;
  * the collective counters: the reference counts each site once per
    compiled program (at trace time), the port once per site per dispatch,
    so they agree on a program's first dispatch and the port's go on
    counting on the next ones (``test_collective_counters_count_sites_per_dispatch``).
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
_FLOAT32_ULP2 = 2

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, tempfile, warnings
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core import FWConfig, LASSO, LOGISTIC, ENOracle, engine
    from repro import distributed as dist
    from repro.data import make_regression, standardize
    from repro.obs import TelemetrySpec, ring_to_records
    from repro.obs import metrics as obs_metrics, trace as obs_trace
    from repro.sparse import io as sio
    from repro.sparse.matrix import SparseBlockMatrix

    work = sys.argv[1]
    out = {}
    ds = standardize(make_regression(m=96, p=300, n_informative=10, noise=0.5, seed=3))
    y = np.asarray(ds.y)
    yj = jnp.asarray(y)
    Xd = np.asarray(ds.X.T, np.float32).copy()
    Xs = Xd.copy()
    Xs[np.abs(Xs) < 0.05] = 0.0
    mat = SparseBlockMatrix.from_dense(Xs, block_size=32)
    key = jax.random.PRNGKey(0)
    cfg = FWConfig(delta=120.0, sampling="uniform", kappa=60, max_iters=400, tol=0.0,
                   patience=10**9)
    as_sparse = lambda c: FWConfig(**{**c.__dict__, "backend": "sparse"})

    def stream(n, draw):
        # the engine's chain: key, sub = split(key); draw(sub)
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, draw(sub)
        return np.asarray(jax.lax.scan(body, key, None, length=n)[1])

    rng = np.random.default_rng(0)
    Xl = rng.standard_normal((120, 80)).astype(np.float32)
    Xl[np.abs(Xl) < 0.7] = 0.0
    w0 = np.zeros(80, np.float32); w0[:5] = rng.standard_normal(5) * 2
    yl = np.sign(Xl @ w0 + 0.1 * rng.standard_normal(120)).astype(np.float32)
    yl[yl == 0] = 1.0
    np.savez(os.path.join(work, "ref.npz"), Xd=Xd, Xs=Xs, y=y, Xl=Xl, yl=yl,
             s_uni=stream(1500, lambda k: jax.random.randint(k, (60,), 0, 300)),
             s_log=stream(800, lambda k: jax.random.randint(k, (40,), 0, 80)),
             s_blk=stream(800, lambda k: jax.random.choice(k, 10, (2,), replace=False)))

    mesh14 = dist.fw_mesh(n_data=1, n_model=4)
    op14 = dist.shard_sparse(mat, y, mesh14)
    r_d = dist.solve(LASSO, op14, cfg, key)
    out["sp14"] = [float(r_d.objective), int(r_d.iterations), int(r_d.n_dots)]
    opd = dist.shard_dense(Xd, y, mesh14)
    out["dn14"] = float(dist.solve(LASSO, opd, cfg, key).objective)

    mesh22 = dist.fw_mesh(n_data=2, n_model=2)
    op22 = dist.shard_sparse(mat, y, mesh22)
    opd22 = dist.shard_dense(Xd, y, mesh22)
    fam = {}
    fam["lasso"] = float(dist.solve(LASSO, op22, cfg, key).objective)
    fam["lasso_dense"] = float(dist.solve(LASSO, opd22, cfg, key).objective)
    en = ENOracle(l2=1.0)
    cfg_en = FWConfig(delta=30.0, sampling="uniform", kappa=60, max_iters=1500, tol=1e-5)
    fam["elasticnet"] = float(dist.solve(en, op22, cfg_en, key).objective)
    fam["elasticnet_dense"] = float(dist.solve(en, opd22, cfg_en, key).objective)
    mat_l = SparseBlockMatrix.from_dense(Xl.T.copy(), block_size=16)
    cfg_lg = FWConfig(delta=20.0, sampling="uniform", kappa=40, max_iters=800, tol=1e-6)
    fam["logistic"] = float(dist.solve(LOGISTIC, dist.shard_sparse(mat_l, yl, mesh22), cfg_lg,
                                       key).objective)
    fam["logistic_dense"] = float(dist.solve(LOGISTIC, dist.shard_dense(Xl.T.copy(), yl, mesh22),
                                             cfg_lg, key).objective)
    out["family"] = fam

    cfg_blk = FWConfig(delta=120.0, sampling="block", kappa=64, max_iters=800, tol=1e-5)
    out["block"] = float(dist.solve(LASSO, op22, cfg_blk, key).objective)

    hr_d, hist_d = dist.solve_with_history(LASSO, op14, cfg, key, 50)
    out["history"] = np.asarray(hist_d).tolist()

    cfg_t = FWConfig(**{**cfg.__dict__, "max_iters": 60,
                        "telemetry": TelemetrySpec(capacity=60)})
    rec = ring_to_records(dist.solve(LASSO, op14, cfg_t, key).telemetry)
    out["ring"] = {f: np.asarray(rec[f]).tolist()
                   for f in ("k", "i_star", "event", "n_dots", "record_index", "objective")}

    out["gap"] = float(dist.certified_gap(LASSO, op14, r_d.alpha, 120.0, cfg))

    feat, samp = np.nonzero(Xs)
    coo = sio.COOData(samp, feat, Xs[feat, samp], y, (96, 300))
    with tempfile.TemporaryDirectory() as td:
        sio.write_shards(td, coo, rows_per_shard=17)
        out["rowplan"] = sio.shards_for_rows(sio.read_manifest(td), 48, 96)

    rules = {}
    for rule in ("away", "pairwise"):
        rr = dist.solve(LASSO, op14, FWConfig(**{**cfg.__dict__, "step_rule": rule}), key)
        rules[rule] = [float(rr.objective), int(jnp.sum(rr.alpha != 0))]
    out["rules"] = rules

    # the metrics of one solve, then of the same program again
    reg, tr = obs_metrics.MetricsRegistry(), obs_trace.Tracer()
    cfg_m = FWConfig(**{**cfg.__dict__, "max_iters": 30})
    with obs_metrics.use_registry(reg), obs_trace.use_tracer(tr):
        dist.solve(LASSO, op14, cfg_m, key)
        first = dict(tr.counter_table())
        dist.solve(LASSO, op14, cfg_m, key)
    out["metrics"] = {"families": sorted({m.name for m in reg.collect()}),
                      "first": first, "second": dict(tr.counter_table())}
    print("RESULT" + json.dumps(out))
""")

PORT_SCRIPT = textwrap.dedent("""
    import dataclasses, hashlib, json, os, sys, tempfile, time, warnings
    import numpy as np
    import torch
    import torch.distributed as tdist
    import torch.multiprocessing as mp

    def digest(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()

    def run(rank, work):
        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method="file://" + os.path.join(work, "init"),
                                 world_size=4, rank=rank)
        from repro_torch import distributed as D
        from repro_torch.core import (FWConfig, LASSO, LOGISTIC, ENOracle, StreamSampler,
                                      TorchSampler, engine)
        from repro_torch.distributed import driver as ddriver
        from repro_torch.obs import TelemetrySpec, ring_to_records
        from repro_torch.obs import metrics as obs_metrics, trace as obs_trace
        from repro_torch.resilience import faults, guards
        from repro_torch.sparse import io as sio
        from repro_torch.sparse.matrix import SparseBlockMatrix

        z = np.load(os.path.join(work, "ref.npz"))
        Xd, Xs, y, Xl, yl = z["Xd"], z["Xs"], z["y"], z["Xl"], z["yl"]
        S = {k: torch.from_numpy(z[k].astype(np.int64)) for k in ("s_uni", "s_log", "s_blk")}
        ss = lambda k: StreamSampler(S[k])
        cpu = "cpu"
        yt = torch.from_numpy(y)
        mat = SparseBlockMatrix.from_dense(Xs, block_size=32)
        Xdt = torch.from_numpy(Xd)
        cfg = FWConfig(delta=120.0, sampling="uniform", kappa=60, max_iters=400, tol=0.0,
                       patience=10**9)
        rep = dataclasses.replace
        sp = lambda c: rep(c, backend="sparse")
        out = {"rank": rank, "times": {}}
        t0 = time.time()

        def tick(name):
            out["times"][name] = time.time() - t0

        # ---- (1, 4): bit for bit the single-device run ----
        mesh14 = D.fw_mesh(n_data=1, n_model=4)
        op14 = D.shard_sparse(mat, y, mesh14, device=cpu)
        r_d = D.solve(LASSO, op14, cfg, ss("s_uni"))
        r_s = engine.solve(LASSO, mat, yt, sp(cfg), ss("s_uni"), device=cpu)
        out["sp14"] = {"bitident": bool(torch.equal(r_d.alpha, r_s.alpha)),
                       "counts": [r_d.iterations, r_s.iterations, r_d.n_dots, r_s.n_dots],
                       "obj": [float(r_d.objective), float(r_s.objective)],
                       "digest": digest(r_d.alpha)}
        opd = D.shard_dense(Xd, y, mesh14, device=cpu)
        rd_d = D.solve(LASSO, opd, cfg, ss("s_uni"))
        rd_s = engine.solve(LASSO, Xdt, yt, cfg, ss("s_uni"), device=cpu)
        out["dn14"] = {"bitident": bool(torch.equal(rd_d.alpha, rd_s.alpha)),
                       "counts": [rd_d.iterations, rd_s.iterations, rd_d.n_dots, rd_s.n_dots],
                       "obj": [float(rd_d.objective), float(rd_s.objective)]}
        tick("14")

        # ---- (2, 2): the three oracles on both layouts ----
        mesh22 = D.fw_mesh(n_data=2, n_model=2)
        op22 = D.shard_sparse(mat, y, mesh22, device=cpu)
        opd22 = D.shard_dense(Xd, y, mesh22, device=cpu)
        en = ENOracle(l2=1.0)
        cfg_en = FWConfig(delta=30.0, sampling="uniform", kappa=60, max_iters=1500, tol=1e-5)
        mat_l = SparseBlockMatrix.from_dense(Xl.T.copy(), block_size=16)
        Xlt = torch.from_numpy(Xl.T.copy())
        cfg_lg = FWConfig(delta=20.0, sampling="uniform", kappa=40, max_iters=800, tol=1e-6)
        fam = {}
        cases = {
            "lasso": (LASSO, op22, mat, yt, cfg, "s_uni", True),
            "elasticnet": (en, op22, mat, yt, cfg_en, "s_uni", True),
            "logistic": (LOGISTIC, D.shard_sparse(mat_l, yl, mesh22, device=cpu), mat_l,
                         torch.from_numpy(yl), cfg_lg, "s_log", True),
            "lasso_dense": (LASSO, opd22, Xdt, yt, cfg, "s_uni", False),
            "elasticnet_dense": (en, opd22, Xdt, yt, cfg_en, "s_uni", False),
            "logistic_dense": (LOGISTIC, D.shard_dense(Xl.T.copy(), yl, mesh22, device=cpu),
                               Xlt, torch.from_numpy(yl), cfg_lg, "s_log", False),
        }
        for name, (orc, op, X1, y1, c, s, is_sp) in cases.items():
            rd = D.solve(orc, op, c, ss(s))
            rs = engine.solve(orc, X1, y1, sp(c) if is_sp else c, ss(s), device=cpu)
            fam[name] = [float(rd.objective), float(rs.objective),
                         float(torch.sum(torch.abs(rd.alpha))), c.delta, digest(rd.alpha)]
        out["family"] = fam
        tick("22")

        # vertex.apply_column_update on a rank's slice: the column broadcast,
        # then eq. 10 on the slice as on the whole
        from repro_torch.core import vertex
        d0, m_loc = mesh22.coords[0], op22.m_local
        args = (torch.tensor(17), torch.tensor(0.25), torch.tensor(-3.0))
        with D.backend.on_mesh(op22.mesh):  # the ops outside a driver bind the mesh
            got = vertex.apply_column_update(op22.tile, 0.5 * op22.y, op22.y, *args,
                                             ddriver.dist_config(cfg, op22))
        want = vertex.apply_column_update(mat, 0.5 * yt, yt, *args, sp(cfg))
        out["apply_col"] = bool(torch.equal(got, want[d0 * m_loc:(d0 + 1) * m_loc]))

        cfg_blk = FWConfig(delta=120.0, sampling="block", kappa=64, max_iters=800, tol=1e-5)
        b_d = D.solve(LASSO, op22, cfg_blk, ss("s_blk"))
        b_s = engine.solve(LASSO, mat, yt, sp(cfg_blk), ss("s_blk"), device=cpu)
        out["block"] = [float(b_d.objective), float(b_s.objective)]

        # ---- the path drivers ----
        deltas = np.geomspace(12.0, 120.0, 6)
        cfg_p = FWConfig(delta=1.0, sampling="uniform", kappa=60, max_iters=5000, tol=1e-4)
        seq = D.fw_path(op14, deltas, cfg_p)
        bat = D.fw_path_batched(op14, deltas, cfg_p, lane_width=3)
        out["path_objs"] = [[p.objective for p in seq.points], [p.objective for p in bat.points]]
        out["path_gaps"] = [p.gap for p in seq.points]
        out["path_gap_scale"] = [abs(p.objective) for p in seq.points]
        out["path_saved"] = int(bat.saved_iters)
        tick("path")

        hr_d, hist_d = D.solve_with_history(LASSO, op14, cfg, ss("s_uni"), 50)
        hr_s, hist_s = engine.solve_with_history(LASSO, mat, yt, sp(cfg), ss("s_uni"), 50,
                                                 device=cpu)
        out["history"] = [hist_d.tolist(), hist_s.tolist()]

        cfg_t = rep(cfg, max_iters=60, telemetry=TelemetrySpec(capacity=60))
        t_d = D.solve(LASSO, op14, cfg_t, ss("s_uni"))
        t_off = D.solve(LASSO, op14, rep(cfg, max_iters=60), ss("s_uni"))
        t_s = engine.solve(LASSO, mat, yt, sp(cfg_t), ss("s_uni"), device=cpu)
        rec_d, rec_s = ring_to_records(t_d.telemetry), ring_to_records(t_s.telemetry)
        facts = ("k", "i_star", "event", "n_dots", "record_index")
        out["tel"] = {
            "off_bitident": bool(torch.equal(t_d.alpha, t_off.alpha)),
            "ring_bitident": {f: bool(np.array_equal(rec_d[f], rec_s[f])) for f in facts},
            "ring": {f: np.asarray(rec_d[f]).tolist() for f in facts + ("objective",)},
            "obj_curve": [np.asarray(rec_d["objective"]).tolist(),
                          np.asarray(rec_s["objective"]).tolist()],
            "hist_equals_ring": bool(torch.equal(hist_d, hr_d.telemetry.objective[:50])),
        }

        g_d = float(D.certified_gap(LASSO, op14, r_d.alpha, 120.0, cfg))
        g_s = float(LASSO.gap(mat, yt, r_s.alpha, 120.0))
        out["gap"] = [g_d, g_s, float(r_s.objective)]
        tick("hist")

        # ---- the coo-npz-v1 manifest onto the mesh ----
        shard_dir = os.path.join(work, "shards")
        if rank == 0:
            feat, samp = np.nonzero(Xs)
            sio.write_shards(shard_dir, sio.COOData(samp, feat, Xs[feat, samp], y, (96, 300)),
                             rows_per_shard=17)
        tdist.barrier()
        out["rowplan"] = sio.shards_for_rows(sio.read_manifest(shard_dir), 48, 96)
        op_ld = D.load_sharded_matrix(shard_dir, mesh22, block_size=32, device=cpu)
        out["loader_cell_bitident"] = bool(torch.equal(op_ld.values, op22.values)
                                           and torch.equal(op_ld.rows, op22.rows)
                                           and torch.equal(op_ld.y, op22.y))
        r_ld = D.solve(LASSO, op_ld, cfg_blk, ss("s_blk"))
        out["loader_obj"] = [float(r_ld.objective), float(b_d.objective)]

        # ---- the step rules ----
        rules = {}
        for rule in ("away", "pairwise"):
            c = rep(cfg, step_rule=rule)
            rr_d = D.solve(LASSO, op14, c, ss("s_uni"))
            rr_s = engine.solve(LASSO, mat, yt, sp(c), ss("s_uni"), device=cpu)
            rr_22 = D.solve(LASSO, op22, c, ss("s_uni"))
            rules[rule] = {
                "objs": [float(rr_d.objective), float(rr_s.objective), float(rr_22.objective)],
                "bitident": bool(torch.equal(rr_d.alpha, rr_s.alpha)),
                "l1": [float(torch.sum(torch.abs(rr_d.alpha))),
                       float(torch.sum(torch.abs(rr_22.alpha)))],
                "active": [int(torch.sum(rr_d.alpha != 0)), int(torch.sum(rr_s.alpha != 0))],
                "digest22": digest(rr_22.alpha),
            }
        out["rules"] = rules
        tick("rules")

        cfg_f = rep(cfg, fuse_steps=4)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rf = D.solve(LASSO, op14, cfg_f, ss("s_uni"))
            D.solve(LASSO, op14, cfg_f, ss("s_uni"))
        out["fuse"] = {"n_warn": sum("fuse_steps" in str(w.message) for w in caught),
                       "effective": int(rf.effective_fuse_steps)}

        reg, tr = obs_metrics.MetricsRegistry(), obs_trace.Tracer()
        cfg_m = rep(cfg, max_iters=30)
        with obs_metrics.use_registry(reg), obs_trace.use_tracer(tr):
            D.solve(LASSO, op14, cfg_m, ss("s_uni"))
            first = dict(tr.counter_table())
            D.solve(LASSO, op14, cfg_m, ss("s_uni"))
        out["metrics"] = {"families": sorted({m.name for m in reg.collect()}),
                          "first": first, "second": dict(tr.counter_table())}

        # ---- recovery (tests/test_resilience.py's TestDistributedRecovery) ----
        rng = np.random.default_rng(2)
        p, m = 64, 32
        Xr = (rng.normal(size=(m, p)) * (rng.random(size=(m, p)) < 0.5)).astype(np.float32)
        yr = rng.normal(size=m).astype(np.float32)
        rdir = os.path.join(work, "rshards")
        if rank == 0:
            r_, c_ = np.nonzero(Xr)
            sio.write_shards(rdir, sio.COOData(r_.astype(np.int64), c_.astype(np.int64),
                                               Xr[r_, c_].astype(np.float32), yr, (m, p)),
                             rows_per_shard=8)
        tdist.barrier()
        mf = sio.read_manifest(rdir)
        rcfg = FWConfig(max_iters=120, delta=2.0, tol=0.0, patience=10**9)
        reg = obs_metrics.MetricsRegistry()
        plan = faults.FaultPlan([faults.FaultSpec(kind="shard_corrupt", site=mf["shards"][0])],
                                seed=3)
        with obs_metrics.use_registry(reg), faults.inject(plan):
            op = D.load_sharded_matrix(rdir, mesh22, block_size=16, device=cpu)
        clean_op = D.load_sharded_matrix(rdir, mesh22, block_size=16, device=cpu)
        retries = reg.get("fw_shard_retries")
        out["shard_heal"] = {
            "fired": len(plan.fired("shard_corrupt")),
            "bitident": bool(torch.equal(op.values, clean_op.values)),
            "retries": 0.0 if retries is None else retries.value(shard=mf["shards"][0]),
        }
        ref = D.solve(LASSO, op, rcfg, TorchSampler(0, cpu))
        res = guards.solve_resilient_sharded(LASSO, op, rcfg, TorchSampler(0, cpu))
        out["parity"] = {"bitident": bool(torch.equal(ref.alpha, res.alpha)),
                         "counts": [ref.iterations, res.iterations, ref.n_dots, res.n_dots]}
        reg2 = obs_metrics.MetricsRegistry()
        plan = faults.FaultPlan([faults.FaultSpec(kind="co_nan", at=1)], seed=7)
        with obs_metrics.use_registry(reg2), faults.inject(plan):
            resf = guards.solve_resilient_sharded(LASSO, op, rcfg, TorchSampler(0, cpu))
        out["conan"] = {"fired": len(plan.fired("co_nan")),
                        "obj": [float(resf.objective), float(ref.objective)],
                        "recoveries": reg2.get("fw_guard_recoveries").value(
                            backend="distributed", rung="rebuild_co")}
        tick("guard")
        pdeltas = np.geomspace(0.5, 3.0, 5)
        pcfg = FWConfig(max_iters=80, delta=1.0, tol=0.0, patience=10**9)
        clean = D.fw_path(op, pdeltas, pcfg, seed=5)
        ck = os.path.join(work, f"ck{rank}")  # one checkpoint directory a rank
        plan = faults.FaultPlan([faults.FaultSpec(kind="kill", at=2)], seed=0)
        killed = False
        try:
            with faults.inject(plan):
                D.fw_path(op, pdeltas, pcfg, seed=5, checkpoint_dir=ck)
        except faults.InjectedKill:
            killed = True
        resumed = D.fw_path(op, pdeltas, pcfg, seed=5, checkpoint_dir=ck, resume_from=ck)
        ok = killed and len(resumed.points) == len(clean.points)
        for a, b in zip(clean.points, resumed.points):
            ok = ok and bool(np.array_equal(a.alpha_nnz_val, b.alpha_nnz_val)
                             and np.array_equal(a.alpha_nnz_idx, b.alpha_nnz_idx)
                             and a.n_dots == b.n_dots and a.iterations == b.iterations)
        out["resume"] = {"bitident": ok,
                         "totals": bool(clean.total_dots == resumed.total_dots
                                        and clean.total_iters == resumed.total_iters)}
        reg3 = obs_metrics.MetricsRegistry()
        plan = faults.FaultPlan([faults.FaultSpec(kind="delay", seconds=4.0)], seed=0)
        with obs_metrics.use_registry(reg3), faults.inject(plan):
            with ddriver.dispatch_policy(timeout_s=1.0, retries=1):
                r2 = D.solve(LASSO, op, rcfg, TorchSampler(0, cpu))
        out["delay"] = {"bitident": bool(torch.equal(ref.alpha, r2.alpha)),
                        "redispatches": reg3.get("fw_dist_redispatches").value(entry="solve"),
                        "fired": len(plan.fired("delay"))}
        tick("recovery")
        with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        tdist.barrier()
        tdist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=4, join=True)
""")


def _limit(default: int) -> int:
    return max(default, int(os.environ.get("REPRO_SUBPROC_TIMEOUT", "0")))


def _env():
    # a stripped environment: the CPU pinned, src on the path
    return {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1", "HOME": os.environ.get("HOME", "/tmp"),
            "TMPDIR": os.environ.get("TMPDIR", "/tmp")}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


@pytest.fixture(scope="module")
def ref_result(work):
    script = work / "ref_script.py"
    script.write_text(REF_SCRIPT)
    proc = subprocess.run([sys.executable, str(script), str(work)], capture_output=True,
                          text=True, timeout=_limit(600), env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def ranks(ref_result, work):
    """The port's results, one dict a rank (rank 0 first)."""
    script = work / "port_script.py"
    script.write_text(PORT_SCRIPT)
    proc = subprocess.run([sys.executable, str(script), str(work)], capture_output=True,
                          text=True, timeout=_limit(600), env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.fixture(scope="module")
def port(ranks):
    return ranks[0]


def _ulp_close(a, b, n=_FLOAT32_ULP2):
    return abs(a - b) <= n * np.spacing(np.float32(max(abs(a), abs(b))))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-9)


class TestBitIdentity:
    def test_sparse_lasso_uniform_trajectory_bit_identical(self, port, ref_result):
        r = port["sp14"]
        assert r["bitident"]
        it_d, it_s, nd_d, nd_s = r["counts"]
        assert (it_d, nd_d) == (it_s, nd_s)
        assert [it_d, nd_d] == ref_result["sp14"][1:]

    def test_sparse_lasso_objective_one_ulp(self, port, ref_result):
        o_d, o_s = port["sp14"]["obj"]
        assert _ulp_close(o_d, o_s), (o_d, o_s)
        assert _rel(o_d, ref_result["sp14"][0]) < 1e-5

    def test_dense_lasso_bit_identical(self, port, ref_result):
        r = port["dn14"]
        assert r["bitident"]
        assert r["counts"][0] == r["counts"][1] and r["counts"][2] == r["counts"][3]
        assert _rel(r["obj"][0], ref_result["dn14"]) < 1e-5

    def test_every_rank_holds_the_same_result(self, ranks):
        """Replicated results: every rank reached the same stops and alpha."""
        for r in ranks[1:]:
            assert r["sp14"]["digest"] == ranks[0]["sp14"]["digest"]
            for name, row in r["family"].items():
                assert row[4] == ranks[0]["family"][name][4], name
            for rule in ("away", "pairwise"):
                assert r["rules"][rule]["digest22"] == ranks[0]["rules"][rule]["digest22"]
            assert r["path_objs"] == ranks[0]["path_objs"]


class TestSolverFamilyOnMesh:
    @pytest.mark.parametrize("oracle", [
        "lasso", "logistic", "elasticnet",
        "lasso_dense", "logistic_dense", "elasticnet_dense",
    ])
    def test_oracle_matches_single_device(self, port, ref_result, oracle):
        obj_d, obj_s, l1, delta, _ = port["family"][oracle]
        assert _rel(obj_d, obj_s) < 1e-4, (oracle, obj_d, obj_s)
        assert _rel(obj_d, ref_result["family"][oracle]) < 1e-4
        assert l1 <= delta * (1 + 1e-4)

    def test_apply_column_update_on_the_mesh(self, ranks):
        """Each rank's slice of eq. 10 with the broadcast column is the
        single-device update's slice, bit for bit."""
        assert all(r["apply_col"] for r in ranks)

    def test_block_sampling_parity(self, port, ref_result):
        obj_d, obj_s = port["block"]
        assert _rel(obj_d, obj_s) < 1e-4
        assert _rel(obj_d, ref_result["block"]) < 1e-4


class TestShardedPathDrivers:
    def test_batched_equals_sequential_with_pruning(self, port):
        seq, bat = port["path_objs"]
        assert len(seq) == len(bat) == 6
        for s, b in zip(seq, bat):
            assert abs(b - s) / abs(s) < 1e-3
        assert port["path_saved"] >= 0

    def test_certified_gaps_reported_and_small(self, port):
        gaps, scales = port["path_gaps"], port["path_gap_scale"]
        assert len(gaps) == 6
        for g, s in zip(gaps, scales):
            assert np.isfinite(g)
            assert abs(g) < 1e-4 * s, (g, s)

    def test_history_driver_matches_single_device(self, port, ref_result):
        h_d, h_s = port["history"]
        assert len(h_d) == 50
        np.testing.assert_allclose(h_d, h_s, rtol=1e-6)
        np.testing.assert_allclose(h_d, ref_result["history"], rtol=1e-5)

    def test_standalone_gap_matches_single_device(self, port, ref_result):
        g_d, g_s, scale = port["gap"]
        assert abs(g_d - g_s) <= 1e-6 * scale
        assert abs(g_d - ref_result["gap"]) <= 1e-5 * scale


class TestShardIO:
    def test_row_plan_reads_only_overlapping_shards(self, port, ref_result):
        assert port["rowplan"] == ref_result["rowplan"] == [
            "shard_00002.npz", "shard_00003.npz", "shard_00004.npz", "shard_00005.npz",
        ]

    def test_manifest_loader_matches_in_memory_placement(self, ranks):
        for r in ranks:
            assert r["loader_cell_bitident"]
            o_ld, o_mem = r["loader_obj"]
            assert o_ld == o_mem


class TestStepRulesOnMesh:
    @pytest.mark.parametrize("rule", ["away", "pairwise"])
    def test_rule_matches_single_device(self, port, ref_result, rule):
        r = port["rules"][rule]
        obj_d, obj_s, obj_22 = r["objs"]
        # one data slice: the column-given direction tail is the
        # single-device one bit for bit
        assert r["bitident"], r
        assert _rel(obj_d, obj_s) < 1e-4
        assert _rel(obj_d, ref_result["rules"][rule][0]) < 1e-4
        assert r["l1"][0] <= 120.0 * (1 + 1e-4)
        # the same atoms live on the mesh and on one device (the reference's
        # own bar; its away steps drift from the port's, ROADMAP R5)
        assert r["active"][0] == r["active"][1], r
        # the samples split: the tail's dots complete between its two launches
        assert _rel(obj_22, obj_s) < 1e-4
        assert r["l1"][1] <= 120.0 * (1 + 1e-4)


class TestTelemetryOnMesh:
    def test_telemetry_off_trajectory_unchanged(self, port):
        assert port["tel"]["off_bitident"]

    def test_ring_step_facts_match_single_device(self, port, ref_result):
        bitident = port["tel"]["ring_bitident"]
        assert all(bitident.values()), bitident
        for f in ("k", "i_star", "event", "n_dots", "record_index"):
            assert port["tel"]["ring"][f] == ref_result["ring"][f], f

    def test_ring_objective_curve_ulp_close(self, port, ref_result):
        d, s = port["tel"]["obj_curve"]
        assert len(d) == len(s) == 60
        for a, b in zip(d, s):
            assert _ulp_close(a, b), (a, b)
        np.testing.assert_allclose(d, ref_result["ring"]["objective"], rtol=1e-5)

    def test_history_driver_is_the_ring(self, port):
        assert port["tel"]["hist_equals_ring"]


class TestForcedFuseSteps:
    def test_warns_once_and_surfaces_effective_value(self, port):
        assert port["fuse"]["n_warn"] == 1
        assert port["fuse"]["effective"] == 1


class TestDistMetrics:
    def test_metric_families_match_the_reference(self, port, ref_result):
        # fw_monitor_stragglers reads the host clock (ROADMAP T1); neither run has one
        assert port["metrics"]["families"] == ref_result["metrics"]["families"]

    def test_collective_counters_count_sites_per_dispatch(self, port, ref_result):
        """The reference counts a collective site once per compiled program
        (at trace time); the port, which compiles nothing, once per site per
        dispatch. On a program's first dispatch they agree; the second
        dispatch of the same program adds nothing in the reference and one
        a site in the port."""
        sites = lambda t: {k: v for k, v in t.items() if k.startswith("dist/collectives/")}
        first_p, first_r = sites(port["metrics"]["first"]), sites(ref_result["metrics"]["first"])
        assert first_p == first_r and first_p
        second_p = sites(port["metrics"]["second"])
        assert sites(ref_result["metrics"]["second"]) == first_r
        assert second_p == {k: 2 * v for k, v in first_p.items()}


class TestDistributedRecovery:
    def test_shard_corruption_heals_through_mesh_loader(self, ranks):
        # rank 0 (data slice 0) reads the corrupted first shard; slice 1 never opens it
        r = ranks[0]["shard_heal"]
        assert r["fired"] >= 1 and r["bitident"] and r["retries"] >= 1.0
        assert all(x["shard_heal"]["bitident"] for x in ranks)

    def test_no_fault_resilient_parity(self, port):
        assert port["parity"]["bitident"]
        it_r, it_g, nd_r, nd_g = port["parity"]["counts"]
        assert (it_r, nd_r) == (it_g, nd_g)

    def test_co_nan_heals_on_mesh(self, port):
        r = port["conan"]
        assert r["fired"] >= 1
        healed, clean = r["obj"]
        assert healed == pytest.approx(clean, rel=1e-4)
        assert r["recoveries"] >= 1.0

    def test_path_kill_resume_bit_identical(self, ranks):
        for r in ranks:
            assert r["resume"]["bitident"]
            assert r["resume"]["totals"]

    def test_delay_triggers_redispatch(self, ranks):
        for r in ranks:
            assert r["delay"]["fired"] >= 1
            assert r["delay"]["redispatches"] >= 1.0
            assert r["delay"]["bitident"]


# --------------------------------------------------------------------------
# The plain versions of the backend's kernels (in this process, no mesh)
# --------------------------------------------------------------------------

from repro_torch.core import FWConfig  # noqa: E402
from repro_torch.kernels import fw_grad, sparse_grad  # noqa: E402
from repro_torch.kernels import step_tail as st  # noqa: E402
from repro_torch.sparse.matrix import SparseBlockMatrix  # noqa: E402

P, M, N_MODEL = 53, 40, 4


def _dense(dtype=torch.float32, seed=0):
    g = np.random.default_rng(seed)
    X = g.standard_normal((P, M)).astype(np.float32)
    X[np.abs(X) < 0.6] = 0.0
    X[:, 0] = np.where(np.arange(P) % 3 == 0, X[:, 0], 0.0)  # row 0 of some columns
    return torch.from_numpy(X).to(dtype), torch.from_numpy(g.standard_normal(M).astype(
        np.float32)).to(dtype)


def _tiles(Xt, n=N_MODEL):
    """The dense tiles of n ranks along the features, zero-padded."""
    p_loc = -(-Xt.shape[0] // n)
    pad = torch.zeros((n * p_loc - Xt.shape[0], Xt.shape[1]), dtype=Xt.dtype)
    full = torch.cat([Xt, pad])
    return [(full[i * p_loc:(i + 1) * p_loc].contiguous(), i * p_loc) for i in range(n)]


def _sparse_tiles(mat, n=N_MODEL):
    nb_loc = -(-mat.nblocks // n)
    padded = mat.pad_geometry(nblocks=n * nb_loc)
    return [((padded.values[i * nb_loc:(i + 1) * nb_loc].contiguous(),
              padded.rows[i * nb_loc:(i + 1) * nb_loc].contiguous()), i * nb_loc * mat.block_size)
            for i in range(n)]


def _ids(p_loc):
    """Ids over the ranks' edges (off, off + p_loc - 1), repeats, a padded
    id past P and an all-foreign draw's ids (rank 0 owns none of the last
    four)."""
    return torch.tensor([0, p_loc - 1, p_loc, 2 * p_loc - 1, 7, 7, P - 1, p_loc + 3,
                         2 * p_loc + 1, 3 * p_loc, P - 2, 3 * p_loc + 2], dtype=torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 4])
def test_owned_dense_scores_sum_to_the_scores(dtype, width):
    Xt, r = _dense(dtype)
    tiles = _tiles(Xt)
    p_loc = tiles[0][0].shape[0]
    blk = _ids(p_loc) if width == 1 else torch.tensor([0, 3, 6, 13], dtype=torch.int64)
    want = fw_grad.sampled_scores_plain(Xt, r, blk, width)
    parts = [fw_grad.sampled_scores_owned(t, r, blk, width, off) for t, off in tiles]
    got = parts[0].clone()
    for part in parts[1:]:
        got += part
    idx = fw_grad.block_indices(blk, width)
    real = idx < P
    assert torch.equal(got[real], want[real])
    assert torch.all(got[~real] == 0)
    # an unowned position is +0.0 exactly; an all-foreign draw is all +0.0
    for (t, off), part in zip(tiles, parts):
        foreign = (idx < off) | (idx >= off + p_loc)
        assert torch.all(part[foreign] == 0) and not torch.signbit(part[foreign]).any()
    foreign = torch.tensor([p_loc, p_loc + 1], dtype=torch.int64)
    none = fw_grad.sampled_scores_owned(tiles[0][0], r, foreign, 1, 0)
    assert torch.equal(none, torch.zeros(2)) and not torch.signbit(none).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 8])
def test_owned_sparse_scores_sum_to_the_scores(dtype, width):
    Xt, r = _dense(torch.float32)
    mat = SparseBlockMatrix.from_dense(Xt.numpy(), block_size=8).astype(dtype)
    tiles = _sparse_tiles(mat)
    p_loc = tiles[0][0][0].shape[0] * 8
    blk = _ids(p_loc) if width == 1 else torch.tensor([0, 2, 5, 6], dtype=torch.int64)
    want = sparse_grad.sparse_sampled_scores_plain(mat.values, mat.rows, r.to(dtype), blk, width)
    got = sum(sparse_grad.sparse_sampled_scores_owned(v, rw, r.to(dtype), blk, width, off)
              for (v, rw), off in tiles)
    assert torch.equal(got, want)


def test_owned_lane_scores_are_each_lanes_one_lane_scores():
    Xt, _ = _dense()
    g = np.random.default_rng(1)
    r = torch.from_numpy(g.standard_normal((3, M)).astype(np.float32))
    blk = torch.stack([_ids(14)[:8], _ids(14)[4:], _ids(14)[2:10]])
    lanes = torch.tensor([0, 2], dtype=torch.int32)
    mat = SparseBlockMatrix.from_dense(Xt.numpy(), block_size=8)
    for (t, off), ((v, rw), soff) in zip(_tiles(Xt), _sparse_tiles(mat)):
        dense = fw_grad.sampled_scores_lanes_owned(t, r, blk, 1, lanes, off)
        sparse = sparse_grad.sparse_sampled_scores_lanes_owned(v, rw, r, blk, 1, lanes, soff)
        for lane in (0, 2):
            assert torch.equal(dense[lane], fw_grad.sampled_scores_owned(t, r[lane], blk[lane],
                                                                           1, off))
            assert torch.equal(sparse[lane], sparse_grad.sparse_sampled_scores_owned(
                v, rw, r[lane], blk[lane], 1, soff))
        assert torch.all(dense[1] == 0) and torch.all(sparse[1] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_owned_columns_sum_to_the_columns(dtype, layout):
    Xt, _ = _dense(dtype)
    ids = torch.tensor([0, 13, 14, 27, P - 1, -1, 5, 5], dtype=torch.int64)
    if layout == "dense":
        tiles = _tiles(Xt)
        want = st.dense_columns(Xt, ids.clamp_min(0), M)
    else:
        mat = SparseBlockMatrix.from_dense(Xt.float().numpy(), block_size=8).astype(dtype)
        tiles = _sparse_tiles(mat)
        want = st.dense_columns((mat.values, mat.rows), ids.clamp_min(0), M)
    want[ids < 0] = 0
    parts = [st.owned_column_lanes(t, ids, off, M) for t, off in tiles]
    got = parts[0].clone()
    for part in parts[1:]:
        got += part
    assert torch.equal(got, want)
    assert torch.equal(st.owned_column(tiles[1][0], ids[2], tiles[1][1], M), parts[1][2])


def _tail_state(dtype, p=P, seed=3):
    g = np.random.default_rng(seed)
    beta = torch.from_numpy((g.standard_normal(p) * (g.random(p) < 0.3)).astype(np.float32))
    y = torch.from_numpy(g.standard_normal(M).astype(np.float32))
    resid = y - 0.3 * torch.from_numpy(g.standard_normal(M).astype(np.float32))
    zty = torch.from_numpy(g.standard_normal(p).astype(np.float32))
    zn2 = torch.from_numpy(np.abs(g.standard_normal(p)).astype(np.float32) + 0.5)
    f = lambda t: t.to(dtype)  # noqa: E731
    return dict(beta=f(beta), scale=f(torch.tensor(0.7)), maxabs=f(torch.tensor(0.9)),
                stall=torch.tensor(2, dtype=torch.int32), resid=f(resid),
                s_quad=f(torch.tensor(3.0)), f_lin=f(torch.tensor(1.2)), y=f(y), zty=f(zty),
                znorm2=f(zn2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("i_star", [0, 9, P - 1])
def test_column_given_tail_is_the_single_device_tail(dtype, layout, i_star):
    """The GIVEN tail's plain version against the one-device tail on the
    same state: every output bit for bit (the sparse layout's out + (+-0)
    off the column keeps its bits), the EN's too."""
    Xt, _ = _dense(dtype)
    cfg = FWConfig(delta=5.0)
    if layout == "dense":
        mat = Xt
    else:
        sm = SparseBlockMatrix.from_dense(Xt.float().numpy(), block_size=8).astype(dtype)
        mat = (sm.values, sm.rows)
    i = torch.tensor(i_star)
    col = st.GivenCol(st.dense_columns(mat, i.view(1), M)[0], layout == "sparse")
    for en in (None, st.ENTail(torch.tensor(-0.8), torch.tensor(0.4).to(dtype), 0.7)):
        a, b = _tail_state(dtype), _tail_state(dtype)
        args = lambda s, m: (m, s["beta"], s["scale"], s["maxabs"], s["stall"], s["resid"],  # noqa
                             s["s_quad"], s["f_lin"], s["y"], s["zty"], s["znorm2"], i,
                             torch.tensor(-0.8), torch.tensor(5.0), cfg)
        want = st.step_tail_plain(*args(a, mat), en)
        got = (st.step_tail_given(*args(b, col)) if en is None
               else st.step_tail_en_given(*args(b, col), en))
        for w, x in zip(want, got):
            assert torch.equal(w, x)


def test_given_lane_tail_is_each_lanes_tail():
    Xt, _ = _dense()
    cfg = FWConfig(delta=5.0)
    s = _tail_state(torch.float32)
    L = 3
    stack = lambda t: torch.stack([t.clone() for _ in range(L)])  # noqa: E731
    i_star = torch.tensor([4, -1, 17])
    z = st.dense_columns(Xt, i_star.clamp_min(0), M)
    z[1] = 0
    lanes = torch.tensor([0, 2], dtype=torch.int32)
    got = st.step_tail_lanes_given(
        st.GivenCol(z, False), stack(s["beta"]), stack(s["scale"]), stack(s["maxabs"]),
        stack(s["maxabs"]), stack(s["stall"]), stack(s["resid"]), stack(s["s_quad"]),
        stack(s["f_lin"]), s["y"], s["zty"], s["znorm2"], i_star, torch.full((L,), -0.8),
        torch.full((L,), 5.0), lanes, cfg)
    for lane in (0, 2):
        one = _tail_state(torch.float32)
        want = st.step_tail_plain(Xt, one["beta"], one["scale"], one["maxabs"], one["stall"],
                                  one["resid"], one["s_quad"], one["f_lin"], one["y"],
                                  one["zty"], one["znorm2"], i_star[lane], torch.tensor(-0.8),
                                  torch.tensor(5.0), cfg)
        assert torch.equal(got[0][lane], want[0])
        for g_, w in zip(got[1:], want[1:]):
            assert torch.equal(g_[lane], w)
    assert torch.equal(got[5][1], s["resid"])  # the frozen lane keeps its residual


def _dir_state(layout, dtype=torch.float32):
    Xt, _ = _dense(dtype)
    s = _tail_state(dtype)
    s["beta"][[3, 9, 20]] = torch.tensor([0.5, -0.25, 0.125]).to(dtype)
    if layout == "dense":
        mat = Xt
    else:
        sm = SparseBlockMatrix.from_dense(Xt.float().numpy(), block_size=8).astype(dtype)
        mat = (sm.values, sm.rows)
    buf = torch.tensor([3, 9, -1, 20, 44], dtype=torch.int64)
    raw_b = torch.tensor([0.3, -0.7, 0.0, 0.2, 0.1])
    return mat, s, buf, raw_b


def _dir_args(mat, s, buf, raw_b, refresh, pairwise, cfg):
    return (mat, s["beta"], s["scale"], s["maxabs"], s["stall"], s["resid"], s["s_quad"],
            s["f_lin"], s["y"], buf, raw_b, torch.tensor(30), torch.tensor(0.9),
            torch.tensor(5.0), refresh, pairwise, cfg)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("pairwise", [False, True])
@pytest.mark.parametrize("refresh", [False, True])
def test_column_given_direction_tail_is_the_single_device_tail(layout, pairwise, refresh):
    """One sample slice: the GIVEN direction tail (its columns read from the
    ``(n_buf + 2, m)`` stack) is the single-device tail bit for bit, and so
    is its split form with a ``complete`` that adds nothing."""
    cfg = FWConfig(delta=5.0)
    mat, s0, buf, raw_b = _dir_state(layout)
    want = st.dir_tail_plain(*_dir_args(mat, dict(s0, beta=s0["beta"].clone()), buf, raw_b,
                                        refresh, pairwise, cfg))
    zcols = st.dense_columns(mat, st.dir_column_ids(torch.tensor(30), buf, P), M)
    for complete in (None, lambda t: t):
        got = st.dir_tail_given(*_dir_args(zcols, dict(s0, beta=s0["beta"].clone()), buf, raw_b,
                                           refresh, pairwise, cfg), complete=complete)
        for w, x in zip(want, got):
            assert (w is None and x is None) or torch.equal(w, x)


def test_split_direction_tail_completes_its_dots_across_slices():
    """Two sample slices, each a thread with its half of the residual, y and
    the columns, their dots summed by a two-party ``complete`` (the
    all_reduce): both slices hold the same scalars and beta, and together
    the single-device tail's to f32 rounding; the refresh's S and F too."""
    cfg = FWConfig(delta=5.0)
    mat, s0, buf, raw_b = _dir_state("dense")
    zcols = st.dense_columns(mat, st.dir_column_ids(torch.tensor(30), buf, P), M)
    want = st.dir_tail_plain(*_dir_args(mat, dict(s0, beta=s0["beta"].clone()), buf, raw_b,
                                        True, False, cfg))
    barrier = threading.Barrier(2)
    slots = [None, None]
    outs = [None, None]

    def slice_run(h):
        lo, hi = h * (M // 2), (h + 1) * (M // 2)

        def complete(t):
            slots[h] = t.clone()
            barrier.wait()
            total = slots[0] + slots[1]
            barrier.wait()
            return total

        s = dict(s0, beta=s0["beta"].clone(), resid=s0["resid"][lo:hi].clone(),
                 y=s0["y"][lo:hi].clone())
        outs[h] = st.dir_tail_given(*_dir_args(zcols[:, lo:hi].contiguous(), s, buf, raw_b,
                                               True, False, cfg), complete=complete)

    threads = [threading.Thread(target=slice_run, args=(h,)) for h in (0, 1)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    a, b = outs
    for name in ("beta", "scale", "maxabs", "step_inf", "stall", "s_quad", "f_lin", "buf",
                 "i_star", "g"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        torch.testing.assert_close(getattr(a, name), getattr(want, name), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([a.resid, b.resid]), want.resid, rtol=1e-5, atol=1e-6)


def test_plain_tensor_on_the_distributed_backend_raises():
    """As the reference's: 'distributed' runs only through the drivers."""
    from repro_torch.core import LASSO, TorchSampler, engine

    Xt, y = _dense()
    with pytest.raises(ValueError, match="only runs inside repro_torch.distributed"):
        engine.solve(LASSO, Xt, y, FWConfig(delta=1.0, backend="distributed"),
                     TorchSampler(0, "cpu"), device="cpu")
