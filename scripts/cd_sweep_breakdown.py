#!/usr/bin/env python3
"""Where a CD sweep's time goes: the ``cd_sweep`` kernel as shipped beside
variants of it with one piece of its per-coordinate chain taken out, timed
at Pyrim's shape (m = 74, p = 201,376, f32, cyclic order) on one card.

The variants are made at run time from ``src/repro_torch/kernels/csrc/
cd_sweep.cu`` by text substitution (each substitution must match, so a
changed kernel fails loudly), built with the port's nvcc flags into
``build/cd_sweep_breakdown/``, and timed in turns (each variant once a
turn, two turns, three sweeps each, the L2 flushed before each sweep).
Only the shipped kernel computes the sweep; the variants are wrong on
purpose and serve to time the pieces:

  shipped      the kernel as the port runs it
  no_aj_read   a_j taken as 0 instead of read from device memory
  no_copies    the ring filled once, no column copies in the chain
  no_wait      the copies issued but never waited for
  rcp_div      S(rho) * rcp(n2) in place of the IEEE division
  chain_only   no copies and no a_j read: the dot, its sums and the update

Run from the repository root on a machine with a card and nvcc:

    python3 scripts/cd_sweep_breakdown.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cd_sweep as cds  # noqa: E402

P, M = 201_376, 74
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


def build():
    src = (_build.CSRC / "cd_sweep.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in VARIANTS.items():
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
    fns = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).cd_sweep_launch
        fn.argtypes, fn.restype = cds._ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        print("cd_sweep_breakdown: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    fns = build()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    X = torch.randn((P, M), generator=g, device="cuda")
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    y = X[:60].sum(0) * 5 + torch.randn(M, generator=g, device="cuda")
    zn2 = (X * X).sum(1)
    lam = _build.f32(float((X @ y).abs().max()) / 1.3)
    pl = cds.sweep_plan(M)
    flush = torch.empty(64 * 2**20, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def sweep(fn, alpha, resid, md):
        err = fn(X.data_ptr(), alpha.data_ptr(), resid.data_ptr(), zn2.data_ptr(), None,
                 md.data_ptr(), P, M, lam, 0, cds.ROUTES[pl.route], pl.threads, pl.slots,
                 pl.slot_words, pl.smem_bytes, stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            alpha, resid = torch.zeros(P, device="cuda"), y.clone()
            md = torch.zeros((), device="cuda")
            sweep(fn, alpha, resid, md)
            for _ in range(3):
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                sweep(fn, alpha, resid, md)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
    print(f"[breakdown] {card}; m={M} p={P:,} f32 cyclic, route {pl.route} ({pl.threads} "
          f"threads, {pl.slots} stages); ms a sweep over {len(times['shipped'])} sweeps in turns")
    base = sum(times["shipped"]) / len(times["shipped"])
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"[breakdown] {name:>10}: {ms:.3f} ms a sweep (min {min(ts):.3f}, max "
              f"{max(ts):.3f}), {1e6 * ms / P:.1f} ns a coordinate, "
              f"{1e6 * (base - ms) / P:+.1f} ns against shipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
