#!/usr/bin/env python3
"""Tune and time the lane argmax's routes on one CUDA card.

Builds variants of ``src/repro_torch/kernels/csrc/fw_grad.cu`` that differ
only in the cluster kernel's quads of scores a thread has in flight
(``CL_QUADS``), its launch bounds' least CTAs a SM and its CTAs a cluster
(``LANE_CLUSTER``), each into ``build/lane_argmax_ab/``, and times with
CUDA events (the launches queued back to back behind a spin kernel,
``chip_smoke._time_queued``), at 13 lanes of the paper's dense size (p =
4,272,227):

- at n = kappa = 1% of p scores a lane (uniform sampling, width 1; four
  sets of per-lane draws in turn): ``vertex_argmax_lanes`` (the lasso)
  and ``vertex_argmax_shifted_lanes`` with the support bitmap and without,
  on the cluster route of every variant, and without the bitmap on the
  ticket route;
- at n = 4 to 2^20 and n = p ('full' sampling, blocks of 128 shared by
  the lanes): the same kernels without the bitmap on the ticket route and
  each variant's cluster route, which decides
  ``fw_grad.LANE_CLUSTER_MAX_N``.

Every variant's outputs are held bit for bit against the plain versions
before it is timed. Beta holds ``--nonzeros`` nonzero coefficients a lane
(an FW iterate after that many steps). Prints the card's name and power
limit, a line a measurement and one JSON line of them all. Needs a card;
imports nothing of JAX:

    python3 scripts/lane_argmax_ab.py --variants 1x2x16,1x2x8,2x2x16
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "lane_argmax_ab"
QUADS_LINE = "constexpr int CL_QUADS = 1;"
CLUSTER_LINE = "constexpr int LANE_CLUSTER = 16;"
# --breakdown: builds of the committed kernel with a piece taken out, for
# timing only (their outputs are not the function's): the frozen lanes'
# pass, the lane id's load (lane y reads row y), the cluster barriers and
# the DSMEM write (rank 0 reduces its own CTA's winner alone), the summary's
# copy into shared memory (read from device memory instead), and the first
# three together
CUTS = {
    "nofrozen": [("  if (blockIdx.y == 0 && rank == C - 1)\n    write_frozen",
                  "  if (false)\n    write_frozen")],
    "nolaneid": [("  const long long ln = lane_ids[blockIdx.y];\n  scores +=",
                  "  const long long ln = blockIdx.y;\n  scores +=")],
    "nosync": [("  cluster_arrive_relaxed();  // phase 1: this CTA runs", ""),
               ("  cluster_wait();  // phase 1 done: every CTA of the cluster runs", ""),
               ("*cluster.map_shared_rank(&slots[rank], 0) = c;", "slots[0] = c;"),
               ("  cluster_arrive();  // phase 2: this CTA's slot written", "  __syncthreads();"),
               ("  cluster_wait();  // phase 2 done: rank 0 sees every slot", ""),
               ("    c = lane < (int)C ? slots[lane] : no_cand();",
                "    c = lane < 1 ? slots[lane] : no_cand();")],
    "nofine": [("            if (need[u][k] && fabsf(s[u][k]) > 0.f) need[u][k] = fine_bit(support, id[u][k]);",
                "            ;")],
    "nostage": [("  const int stage = support != nullptr && summary_bytes",
                 "  const int stage = 0 && support != nullptr && summary_bytes")],
}
CUTS["bare"] = CUTS["nofrozen"] + CUTS["nolaneid"] + CUTS["nosync"]
EXACT_CUTS = ("nofine", "nostage")  # these keep the function: their bits are checked
BOUNDS_LINE = "__global__ void __launch_bounds__(AM_THREADS, 2)\nargmax_lanes_cluster_kernel("


def build_variants(nvcc, nvcc_flags, variants):
    """``{name: library path}``: fw_grad.cu with CL_QUADS = q, launch
    bounds (AM_THREADS, b) and LANE_CLUSTER = c for each "qxbxc", or with a
    piece of ``CUTS`` taken out for each of its names, one nvcc each, all at
    once."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    src = (CSRC / "fw_grad.cu").read_text()
    if any(src.count(line) != 1 for line in (QUADS_LINE, BOUNDS_LINE, CLUSTER_LINE)):
        raise SystemExit("lane_argmax_ab: fw_grad.cu no longer has the lines it varies")
    jobs = {}
    for name in variants:
        if name in CUTS:
            text = src
            for old, new in CUTS[name]:
                if text.count(old) != 1:
                    raise SystemExit(f"lane_argmax_ab: fw_grad.cu has no single {old!r}")
                text = text.replace(old, new)
        else:
            q, b, c = (int(x) for x in name.split("x"))
            text = src.replace(QUADS_LINE, f"constexpr int CL_QUADS = {q};").replace(
                BOUNDS_LINE, BOUNDS_LINE.replace("(AM_THREADS, 2)", f"(AM_THREADS, {b})")).replace(
                CLUSTER_LINE, f"constexpr int LANE_CLUSTER = {c};")
        cu, lib = OUT / f"fw_grad_{name}.cu", OUT / f"libfw_grad_{name}.so"
        cu.write_text(text)
        cmd = [nvcc, "-Xptxas", "-v", *nvcc_flags, "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"lane_argmax_ab: variant {name} failed to build:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        kernels = [ln for ln in log.splitlines() if "Compiling entry" in ln]
        for k, r in zip(kernels, regs):
            if "argmax_lanes_cluster" in k:
                print(f"[ptxas] {name} {k.split()[-3][:60]}: {r}")
        libs[name] = lib
    return libs


@contextlib.contextmanager
def cluster_library(build, fw, lib_path):
    """Route the wrappers' cluster launches to another build of fw_grad.cu."""
    fn = ctypes.CDLL(str(lib_path)).vertex_argmax_lanes_cluster_launch
    fn.argtypes, fn.restype = fw._CLUSTER_ARGTYPES, ctypes.c_int
    orig = build.function

    def pick(name, symbol, argtypes):
        return fn if symbol == "vertex_argmax_lanes_cluster_launch" else orig(name, symbol,
                                                                             argtypes)

    build.function = pick
    try:
        yield
    finally:
        build.function = orig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="1x2x16,1x2x8",
                    help="comma-separated CL_QUADS x least CTAs a SM x CTAs a cluster")
    ap.add_argument("--nonzeros", type=int, default=2000, help="nonzeros of beta a lane")
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the builds of CUTS (no bit checks but theirs)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lane_argmax_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.kernels import _build
    from repro_torch.kernels import fw_grad as fw

    print(cs.card_line())
    _build.build(["fw_grad"])
    variants = args.variants.split(",")
    cuts = list(CUTS) if args.breakdown else []
    libs = build_variants(_build._nvcc(), _build.NVCC_FLAGS, variants + cuts)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    p, L = cs.P_PAPER, cs.LANE_WIDTH
    kappa = kappa_fraction(p, 0.01)
    ids = torch.arange(L, dtype=torch.int32, device=dev)
    n4 = -(-kappa // 4) * 4
    sets = []
    for _ in range(4):
        scores = torch.randn((L, n4), generator=g, device=dev)[:, :kappa]
        sets.append((scores, torch.randint(0, p, (L, kappa), generator=g, device=dev)))
    beta = torch.zeros((L, p), device=dev)
    beta.scatter_(1, torch.randint(0, p, (L, args.nonzeros), generator=g, device=dev),
                  torch.randn((L, args.nonzeros), generator=g, device=dev))
    scale = torch.full((L,), 0.8, device=dev)
    support = fw.pack_support(beta)
    with_map, bare = fw.ScoreShift(beta, scale, 1.0, support), fw.ScoreShift(beta, scale, 1.0)
    n_set = int(torch.count_nonzero(support.view(torch.uint8)))
    print(f"[setup] {L} lanes, p={p:,}, kappa={kappa:,}, beta {args.nonzeros} nonzeros a lane "
          f"({int(torch.count_nonzero(beta)):,} in all), bitmap {support.numel() * 4:,} bytes "
          f"({n_set:,} nonzero bytes)")
    results = {}

    def plain_bits(i, shift):
        scores, blk = sets[i]
        if shift is None:
            return fw.argmax_lanes_plain(scores, blk, 1, p, ids)
        return fw.argmax_shifted_lanes_plain(scores, blk, 1, p, ids, bare)

    want = [(plain_bits(i, None), plain_bits(i, bare)) for i in range(4)]

    def same(a, b):
        return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y)
                   for x, y in zip(a, b))

    def run(label, route, shift, checked=True):
        for i in range(4 if checked else 0):  # the bits: every draw, against the plain version
            scores, blk = sets[i]
            if shift is None:
                got = fw.vertex_argmax_lanes(scores, blk, 1, p, ids, route=route)
            else:
                got = fw.vertex_argmax_shifted_lanes(scores, blk, 1, p, ids, shift, route=route)
            if not same(got, want[i][0 if shift is None else 1]):
                raise SystemExit(f"lane_argmax_ab: {label} differs from the plain version")

        def call(i):
            scores, blk = sets[i % 4]
            if shift is None:
                return fw.vertex_argmax_lanes(scores, blk, 1, p, ids, route=route)
            return fw.vertex_argmax_shifted_lanes(scores, blk, 1, p, ids, shift, route=route)

        ms = min(cs._time_queued(torch, call, 400) for _ in range(3))
        results[label] = ms
        print(f"[ab] {label}: {ms:.6f} ms (best of 3 runs of 400 launches)")

    kinds = (("lanes", None), ("shifted+map", with_map), ("shifted", bare))
    for kind, shift in (kinds[0], kinds[2]):  # the ticket route takes no bitmap
        run(f"{kind} ticket", "ticket", shift)
    for name in variants:
        with cluster_library(_build, fw, libs[name]):
            for kind, shift in kinds:
                run(f"{kind} cluster q{name}", "cluster", shift)
    for name in cuts:
        with cluster_library(_build, fw, libs[name]):
            for kind, shift in kinds[:2]:
                run(f"{kind} cluster {name}", "cluster", shift, checked=name in EXACT_CUTS)
    torch.cuda.synchronize()
    del sets

    # the routes' crossover (width 1, the lasso) and their floor (n = 4 a lane)
    for n in (4, 65_536, 262_144, 1_048_576):
        if n > 4 and args.breakdown:
            break
        n4 = -(-n // 4) * 4
        scores = torch.randn((L, n4), generator=g, device=dev)[:, :n]
        blk = torch.randint(0, p, (L, n), generator=g, device=dev)
        for name in ["ticket"] + variants + (cuts if n == 4 else []):
            label = f"n={n} lanes {name}"
            lib = contextlib.nullcontext() if name == "ticket" else cluster_library(
                _build, fw, libs[name])
            with lib:
                results[label] = ms = cs._time_queued(torch, lambda i, r=name: (
                    fw.vertex_argmax_lanes(scores, blk, 1, p, ids,
                                           route="ticket" if r == "ticket" else "cluster")), 400)
            print(f"[ab] {label}: {ms:.6f} ms")
    results["launch_floor"] = ms = cs.launch_floor_ms(torch, dev)
    print(f"[ab] an empty kernel, back to back: {ms:.6f} ms")

    # n = p: 'full' sampling, blocks of 128 shared by the lanes
    bs = 128
    blk = torch.arange(-(-p // bs), device=dev)
    scores = torch.randn((L, blk.numel() * bs), generator=g, device=dev)
    for kind, shift in (kinds[0], kinds[2]):
        outs = {}
        for name in ["ticket"] + variants:
            def call(i, name=name, shift=shift):
                route = "ticket" if name == "ticket" else "cluster"
                if shift is None:
                    return fw.vertex_argmax_lanes(scores, blk, bs, p, ids, route=route)
                return fw.vertex_argmax_shifted_lanes(scores, blk, bs, p, ids, shift, route=route)

            lib = contextlib.nullcontext() if name == "ticket" else cluster_library(
                _build, fw, libs[name])
            with lib:
                outs[name] = call(0)
                label = f"full {kind} {name}"
                results[label] = ms = cs._time_queued(torch, call, 50)
            print(f"[ab] {label}: {ms:.6f} ms (n = {scores.shape[1]:,} a lane, 50 launches)")
        first = next(iter(outs.values()))
        if not all(same(first, o) for o in outs.values()):
            raise SystemExit(f"lane_argmax_ab: the routes differ at n = p ({kind})")
    print(json.dumps({"lane_argmax_ab": results, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
