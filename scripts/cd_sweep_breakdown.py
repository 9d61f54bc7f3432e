#!/usr/bin/env python3
"""Where a CD sweep's time goes, at Pyrim's shape (m = 74, p = 201,376, f32,
cyclic order) on one card: the unscreened kernel H (``cd_sweep_launch``)
and the screened sweep (``cd_score_launch``, then ``cd_walk_launch`` a walk)
as shipped, each beside variants with one piece taken out.

The variants are made at run time from ``src/repro_torch/kernels/csrc/
cd_sweep.cu`` by text substitution (each substitution must match, so a
changed kernel fails loudly), built with the port's nvcc flags into
``build/cd_sweep_breakdown/``, and timed in turns (each variant once a
turn, two turns, three sweeps each, the L2 flushed before each sweep).
Only the shipped kernels compute the sweep; the variants are wrong on
purpose and serve to time the pieces.

H, from zero (its state carried from sweep to sweep):

  shipped      the kernel as the port runs it
  no_aj_read   a_j taken as 0 instead of read from device memory
  no_copies    the ring filled once, no column copies in the chain
  no_wait      the copies issued but never waited for
  rcp_div      S(rho) * rcp(n2) in place of the IEEE division
  chain_only   no copies and no a_j read: the dot, its sums and the update

The screened sweep, at m = 74 and at the paper's dense m = 800 (p =
201,376 both), cold (from zero) and warm (from the cold sweep's result),
each timed with the walks' host reads and re-bases, each library's first
launch untimed:

  walk            the score pass and the walks as the port runs them
  walk_no_drift   B the moves' sum alone: no ||R - R_0|| summed beside a
                  survivor's dot (exact too, a looser screen)
  walk_scan_only  no position survives: the score pass and the scan alone
                  (windows, chunk skips, ballots)
  walk_no_skip    no chunk skipping: every window read and tested

and a re-base's own cost: a score pass (CUDA events) and a walk that has
nothing to do, with its host read (host clock). A survivor's turn is
(walk - walk_scan_only - re-bases x a re-base's cost) / survivors.

Then the drift term on the paths' own data: the 10-point cyclic CD path of
lambda_grid(n_points=100) (each point warm from the one before, table 4's
200 sweeps and tol 1e-3) on Pyrim (``make_proxy('pyrim')``) and on the
paper's dense design (p = 4,272,227, m = 800, ``make_wide_problem(n_rel=300,
seed=0)``), under ``walk`` and ``walk_no_drift`` in turns: sweeps, walks,
survivors and the summed device ms of the sweeps (the L2 flushed before
each), and whether the two paths end on the same bits.

Run from the repository root on a machine with a card and nvcc:

    python3 scripts/cd_sweep_breakdown.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cd_sweep as cds  # noqa: E402

P, M = 201_376, 74
M_DENSE = 800  # the paper's dense width, for the screened sweep's pieces
OUT = ROOT / "build" / "cd_sweep_breakdown"

NO_AJ = ("    const float a = j == last_j ? last_a : alpha[j];",
         "    const float a = 0.f;")
NO_COPIES = ("    if (t + D < p) {\n      const int st",
             "    if (false) {\n      const int st")
NO_WAIT = ("    cp_async_commit();\n    // 4. column t + 1 landed for every thread; the partials "
           "visible\n    cp_async_wait_n(D - 1);",
           "    cp_async_commit();\n")
RCP = ("  a_new = __fdiv_rn(st, fmaxf(n2, 1e-12f));",
       "  a_new = __fmul_rn(st, __frcp_rn(fmaxf(n2, 1e-12f)));")
VARIANTS = {
    "shipped": (),
    "no_aj_read": (NO_AJ,),
    "no_copies": (NO_COPIES,),
    "no_wait": (NO_WAIT,),
    "rcp_div": (RCP,),
    "chain_only": (NO_COPIES, NO_AJ),
}
NO_DRIFT_SUM = ("""      // ||R - R_0||^2 beside the dot (R before this update), for B
      float dr = 0.f;
#pragma unroll
      for (int k = 0; k < CD_RPT; ++k) {
        const float e = __fsub_rn(r[k], r0[k]);
        dr = fmaf(e, e, dr);
      }
      cd_partial(dr, part_dr, sc, chain);
""", "")
NO_DRIFT_MIN = ("""      const float D = cw_drift_up(cd_total(part_dr, sc, nt >> 5), m, one_minus_G);
      B = fminf(B, d != 0.f ? cw_grow(D, d, nzj, rn, m) : D);
""", "")
SCAN_ONLY = ("      const bool sv = pos >= cur && pos < p && (!az[e] || !(B <= hh[e]));",
             "      const bool sv = false;")
NO_SKIP = ("      if (cyclic) {\n        cur = skip_chunks(cur);",
           "      if (false) {\n        cur = skip_chunks(cur);")
WALK_VARIANTS = {
    "walk": (),
    "walk_no_drift": (NO_DRIFT_SUM, NO_DRIFT_MIN),
    "walk_scan_only": (SCAN_ONLY,),
    "walk_no_skip": (NO_SKIP,),
}


def build():
    """Every variant's library, one nvcc each, all started together."""
    src = (_build.CSRC / "cd_sweep.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in {**VARIANTS, **WALK_VARIANTS}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the kernel no longer holds {old!r}")
            text = text.replace(old, new, 1)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn_name, argtypes in (("cd_sweep_launch", cds._ARGTYPES),
                                  ("cd_score_launch", cds._SCORE_ARGTYPES),
                                  ("cd_walk_launch", cds._WALK_ARGTYPES)):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


def problem(m):
    """Pyrim's p at width m: unit rows, 60 of them in y, lam = max|X y| / 1.3."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    X = torch.randn((P, m), generator=g, device="cuda")
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    y = X[:60].sum(0) * 5 + torch.randn(m, generator=g, device="cuda")
    return X, y, (X * X).sum(1), _build.f32(float((X @ y).abs().max()) / 1.3)


def timed(flush, fn):
    """Device ms of fn() (CUDA events, host reads inside included), the L2
    flushed first; and fn's result."""
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def check(err):
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")


def unscreened_breakdown(libs, flush, stream):
    X, y, zn2, lam = problem(M)
    pl = cds.sweep_plan(M)

    def sweep(lib, alpha, resid, md):
        check(lib.cd_sweep_launch(X.data_ptr(), alpha.data_ptr(), resid.data_ptr(),
                                  zn2.data_ptr(), None, md.data_ptr(), P, M, lam, 0,
                                  cds.ROUTES[pl.route], pl.threads, pl.slots, pl.slot_words,
                                  pl.smem_bytes, stream))

    times = {name: [] for name in VARIANTS}
    for _ in range(2):
        for name in VARIANTS:
            alpha, resid = torch.zeros(P, device="cuda"), y.clone()
            md = torch.zeros((), device="cuda")
            sweep(libs[name], alpha, resid, md)
            for _ in range(3):
                times[name].append(timed(flush, lambda: sweep(libs[name], alpha, resid, md))[0])
    print(f"[breakdown] H at m={M} p={P:,} f32 cyclic: route {pl.route} ({pl.threads} threads, "
          f"{pl.slots} stages); ms a sweep from zero, in turns, the L2 flushed")
    base = sum(times["shipped"]) / len(times["shipped"])
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"[breakdown] {name:>10}: {ms:.3f} ms a sweep (min {min(ts):.3f}, max "
              f"{max(ts):.3f}), {1e6 * ms / P:.1f} ns a coordinate, "
              f"{1e6 * (base - ms) / P:+.1f} ns against shipped")


class Sweeper:
    """``cds.cd_sweep``'s loop (score pass, walk, host read, again after a
    re-base) on one variant's library, for one cyclic design."""

    def __init__(self, X, zn2, stream):
        self.X, self.zn2, self.stream = X, zn2, stream
        self.p, self.m = X.shape
        self.wp = cds.walk_plan(self.m)
        self.limit = cds.rebase_threshold(self.p, self.m)
        self.head = torch.empty(self.p, device="cuda")
        self.nz = torch.empty(self.p, device="cuda")
        self.cmin = torch.empty(-(-self.p // cds.CHUNK), device="cuda")
        self.r0n = torch.empty((), dtype=torch.float64, device="cuda")
        self.io = torch.zeros(3, dtype=torch.int64, device="cuda")

    def score(self, lib, alpha, resid, lam):
        check(lib.cd_score_launch(self.X.data_ptr(), resid.data_ptr(), self.zn2.data_ptr(),
                                  alpha.data_ptr(), self.head.data_ptr(), self.nz.data_ptr(),
                                  self.cmin.data_ptr(), self.r0n.data_ptr(), self.p, self.m, lam,
                                  cds.screen_gamma(self.m), 0,
                                  min(cds.SCORE_BLOCKS, -(-self.p // cds.CHUNK)), self.stream))

    def walk(self, lib, alpha, resid, md, lam):
        wp = self.wp
        check(lib.cd_walk_launch(self.X.data_ptr(), alpha.data_ptr(), resid.data_ptr(),
                                 self.zn2.data_ptr(), None, self.head.data_ptr(),
                                 self.nz.data_ptr(), self.cmin.data_ptr(), self.r0n.data_ptr(),
                                 md.data_ptr(), self.io.data_ptr(), self.p, self.m, lam, 0,
                                 cds.ROUTES[wp.route], wp.threads, wp.chain_threads,
                                 wp.smem_bytes, self.limit, self.stream))

    def sweep(self, lib, alpha, resid, md, lam):
        """One sweep: returns walks, survivors."""
        self.io.zero_()
        walks = 0
        while True:
            self.score(lib, alpha, resid, lam)
            self.walk(lib, alpha, resid, md, lam)
            walks += 1
            pos, surv, _ = self.io.tolist()
            if pos >= self.p:
                return walks, surv


def walker_breakdown(libs, flush, stream, m):
    X, y, zn2, lam = problem(m)
    sw = Sweeper(X, zn2, stream)

    def state(kind):
        alpha, resid = torch.zeros(P, device="cuda"), y.clone()
        md = torch.zeros((), device="cuda")
        if kind == "warm":  # from the shipped sweep's result
            sw.sweep(libs["walk"], alpha, resid, md, lam)
            md.zero_()
        return alpha, resid, md

    for name in WALK_VARIANTS:  # each library's first launch, untimed
        sw.sweep(libs[name], *state("cold"), lam)
    times, counts = {}, {}
    for _ in range(2):
        for name in WALK_VARIANTS:
            for kind in ("cold", "warm"):
                for _ in range(3):
                    alpha, resid, md = state(kind)
                    ms, out = timed(flush, lambda: sw.sweep(libs[name], alpha, resid, md, lam))
                    times.setdefault((name, kind), []).append(ms)
                    counts[(name, kind)] = out
    lib = libs["walk"]
    alpha, resid, md = state("cold")
    score_ms = sum(timed(flush, lambda: sw.score(lib, alpha, resid, lam))[0]
                   for _ in range(5)) / 5
    walls = []
    for _ in range(20):  # a walk that has nothing to do, with its host read
        sw.io.fill_(P)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw.walk(lib, alpha, resid, md, lam)
        sw.io.tolist()
        walls.append(1e3 * (time.perf_counter() - t0))
    empty_ms = sorted(walls)[len(walls) // 2]
    print(f"[breakdown] the screened sweep at m={m} p={P:,} f32 cyclic: the walker "
          f"{sw.wp.threads} threads, {sw.wp.chain_threads} in the chain, a re-base after "
          f"{sw.limit} idle survivors; ms a sweep in turns, the L2 flushed")
    print(f"[breakdown] m={m} a re-base: the score pass {score_ms:.4f} ms + an empty walk and "
          f"its host read {empty_ms:.4f} ms (median of 20, host clock)")
    for kind in ("cold", "warm"):
        mean = {n: sum(times[(n, kind)]) / len(times[(n, kind)]) for n in WALK_VARIANTS}
        for name in WALK_VARIANTS:
            ts = times[(name, kind)]
            walks, surv = counts[(name, kind)]
            print(f"[breakdown] m={m} {name:>14} {kind}: {mean[name]:.4f} ms a sweep (min "
                  f"{min(ts):.4f}, max {max(ts):.4f}), {walks} walks, {surv} survivors")
        walks, surv = counts[("walk", kind)]
        chain = mean["walk"] - mean["walk_scan_only"] - (walks - 1) * (score_ms + empty_ms)
        print(f"[breakdown] m={m} {kind}: a survivor's turn {1e3 * chain / max(surv, 1):.2f} us "
              f"({surv} survivors, {walks - 1} re-bases); the drift term saves "
              f"{mean['walk_no_drift'] - mean['walk']:+.4f} ms and "
              f"{counts[('walk_no_drift', kind)][1] - surv:+d} survivors, the chunk skips "
              f"{mean['walk_no_skip'] - mean['walk']:+.4f} ms")


def drift_on_path(libs, flush, stream, label, X, y):
    """The 10-point cyclic CD path under ``walk`` and ``walk_no_drift``, in
    turns: sweeps, walks, survivors, summed device ms; the same bits."""
    from repro_torch.core import lambda_grid

    lams = [_build.f32(float(v)) for v in lambda_grid(X, y, n_points=100)[:10]]
    sw = Sweeper(X, (X * X).sum(1), stream)
    tol = _build.f32(1e-3)
    res = {}
    for turn in range(2):
        for name in ("walk", "walk_no_drift"):
            alpha, resid = torch.zeros(sw.p, device="cuda"), y.clone()
            md = torch.zeros((), device="cuda")
            ms = sweeps = walks = surv = 0
            for lam in lams:
                for _ in range(200):
                    md.zero_()
                    t, (w, s) = timed(flush, lambda: sw.sweep(libs[name], alpha, resid, md, lam))
                    ms, sweeps, walks, surv = ms + t, sweeps + 1, walks + w, surv + s
                    if float(md) <= tol:
                        break
            res.setdefault(name, []).append((ms, sweeps, walks, surv, alpha, resid))
    same = all(torch.equal(a[4], b[4]) and torch.equal(a[5].view(torch.int32),
                                                        b[5].view(torch.int32))
               for a, b in zip(res["walk"], res["walk_no_drift"]))
    for name, runs in res.items():
        _, sweeps, walks, surv, alpha, _ = runs[-1]
        print(f"[drift] {label} (p={sw.p:,} m={sw.m}), 10-point CD path, {name:>13}: "
              f"{' / '.join(f'{r[0]:.4f}' for r in runs)} ms device in turns, {sweeps} sweeps, "
              f"{walks} walks, {surv} survivors ({surv / sweeps:.1f} a sweep), active "
              f"{int(torch.count_nonzero(alpha))}")
    print(f"[drift] {label}: the two paths end on the same bits: {same}")


def main():
    if not torch.cuda.is_available():
        print("cd_sweep_breakdown: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"[breakdown] {card}")
    libs = build()
    flush = torch.empty(64 * 2**20, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    unscreened_breakdown(libs, flush, stream)
    for m in (M, M_DENSE):
        walker_breakdown(libs, flush, stream, m)
    from repro_torch.data import make_proxy, make_wide_problem

    ds = make_proxy("pyrim", scale=1.0, seed=0)
    X = torch.from_numpy(ds.X.T.copy()).cuda()
    drift_on_path(libs, flush, stream, "Pyrim", X, torch.from_numpy(ds.y).cuda())
    del X
    X, y, _ = make_wide_problem(4_272_227, M_DENSE, 300, seed=0, device="cuda")
    drift_on_path(libs, flush, stream, "the dense width", X, y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
