#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Two paths run in turn, the dense one and then the sparse one, each
through phases 2-5; any failed check raises and the script exits non-zero:

1. device and build: the card's name and power limit, the kernels built
   from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, TF32 off;
2. each kernel against its plain PyTorch version on the card, at its
   path's shapes and at ragged ones, in f32 and bf16 (the fused chunks K4
   and K7 and the replay in f32, the replay bit for bit through a renorm,
   two launches of a chunk bitwise equal); the unfused step's one-launch
   tail bit for bit on both layouts and dtypes (lam clamped at 0 and 1, no
   progress, a renorm at lam = 1 and with the scale just under the
   threshold, a NaN score, one coordinate twice in a row, a sparse winner
   with a stored row 0 and padding, m = 1; two launches equal); K5's
   scores bitwise equal to the warp-per-feature K5's (``K5_SHA256``); a
   fused solve one past each layout's shared-memory cap (K unfused steps)
   bitwise equal to the unfused one; bf16 designs solved on 'kernels' and
   'sparse', unfused and fused; K7 at its ring's edges (odd and
   even ids, repeats within and across steps, ids past the arrays,
   nnz_max 1, 13, 66 and 300, pieces of 32 slots, no ring at m =
   M_MAX_SPARSE, K = 1, kappa below the grid's warps); the replay with a
   coordinate winning 3 times, renorms at the first and the last record, a
   masked tail and 40 records;
   K2's argmax bit-exact at n on either side of a block's share of scores
   and at n = p, on a tie across blocks, NaN and every index masked; K6 on
   explicit stored zeros, nnz_max 1, 13 and 67, f32 and bf16, many tiles
   a block and y too long to stage, two launches bitwise equal;
   the lane-axis kernels of the batched lanes (K2's scores and argmax,
   the tail, K5) at L = 1, 3 and 13 at each path's shapes, each running
   lane bitwise its one-lane launch, a frozen lane among active ones and
   every lane frozen (winners (-1, 0), outputs equal to inputs), two
   argmax launches equal (the tickets back at 0), the renorm in one lane
   only, bf16 and K5's warp-per-feature route at L = 3;
   the elastic-net's instantiations at each path's shapes: K2's argmax
   with the score shift (n = kappa with f32 and bf16 beta, n = p, a shift
   that turns the winner, raw scores all zero, a padded index whose
   shifted score would win; L = 1, 3, 13, each lane bitwise its one-lane
   launch), bit for bit; the EN tail in f32 and bf16 (a renorm, lam near
   1, the same coordinate twice; 13 lanes), bit for bit; K4 or K7 with
   the alpha ledger against the plain chunk (K = 8 at kappa = 1% of p, and
   a chunk where one coordinate wins in steps 0 and 2, so two ledger slots
   add), two launches bitwise equal;
   the step rules' direction tail (``dir_tail``, ``dir_tail_en``) against
   its plain version on an away step, a pairwise step, a drop step (the
   away coordinate exactly 0), i_f == i_a, an empty buffer, zero-weight
   atoms, a renorm, a refresh step and a full buffer taking a new atom
   (dense and sparse, f32 at the path's shapes and at m = 9,000, bf16;
   vertices, stall, the buffer and the drop's zero exact, the rest to the
   dots' rounding; two launches bitwise equal), and K2/K5 at width 1 on 32
   and 16 caller indices with -1 slots;
   the baselines' CD sweep (``cd_sweep``, dense path only) against its
   plain loop: cyclic and stochastic orders (a row repeated inside the
   ring's window and back to back), m = 74, 186, 800 (the residual in
   registers), 20,000 (in shared memory) and 60,000 (past the on-chip
   cap, in device memory), lam = 0, lam above lam_max (nothing moves: R
   keeps its bits), a warm start thresholded on the way, a zero column,
   f32 and bf16; alpha and R within TOL_CD, the support up to named
   near-ties, two launches bitwise equal;
   then the reference's converging golden on a small problem, replayed
   from the reference's own index stream (embedded below), on the
   'kernels' backend and on 'sparse' (unfused and fused);
3. the paths, each kernel's launch count checked against the run:
   - dense: ``fw_path`` on 'kernels' at the paper's dense size (p =
     4,272,227, m = 800, f32, kappa = 1% of p, uniform sampling), one
     step per dispatch (K2's scores, its argmax and the tail once a step),
     then the same 100-point grid with ``fuse_steps=8`` (K4 and the replay
     once per chunk, K2 and the tail never), then one point with 'full'
     sampling (deterministic FW, 50 steps, K2 over all p coordinates a
     step) against the 'torch' backend;
   - sparse: the E2006-log1p proxy at its published size (m = 16,087,
     p = 4,272,227, column density 0.002, block-ELL, built on the card),
     the 100-point grid on 'sparse' with ``fuse_steps=8`` (K6 per point,
     K7 and the replay per chunk, K5 never), the warm start at its densest
     point twice (equal bits), its first 3 points one step per dispatch
     (K5, the argmax and the tail per step), and one point with 'block'
     sampling (K5 at width 256);
   every unfused path launches the tail once a step and K3 never;
   - batched: the example's default driver (``--driver batched``),
     ``fw_path_batched`` in lanes of 13 over the same 100-point grid on
     each layout, unfused: the lane scores, argmax and tail once a
     batched step, K1 or K6 once a chunk, the fused chunks and the
     one-lane kernels never;
   - the extension oracles (paper §6, the reference's family section): the
     elastic-net (``ENOracle(l2=1.0)``) over the same 100-point grid on
     each layout, fused at K = 8 (K4 or K7 with the ledger, once a chunk),
     its first 3 points one step per dispatch (the shifted argmax and the
     EN tail once a step) and batched in lanes of 13; the logistic oracle
     (labels sign(y) + (y == 0), max_iters 2000, tol 1e-4) over a 10-point
     grid, all 10 points sequential and in lanes of 4 on the sparse layout,
     the first 3 on the dense one; each path's launches, l1 <= delta and
     its densest point's certified gap with the oracle's own gradient;
   - the baselines (dense path): constrained FISTA (500 iterations, tol
     1e-3) at the main path's densest delta, whose FW objective minus
     FISTA's must lie within FW's certified gap; and on Pyrim at its
     published size (m = 74, p = 201,376, built by ``make_proxy``) the
     first 10 points of a 100-point lambda grid under cyclic CD (200
     sweeps, tol 1e-3), the first 3 under stochastic CD, the 10 under
     penalized FISTA (500 iterations) and the FW path at the CD points'
     l1 norms (paper §2.1): one ``cd_sweep`` launch a sweep, finite
     objectives, CD's penalized objective within rtol 1e-3 of FISTA's at
     every point (the points where FISTA hit max_iters named), and one
     warm sweep at full p (point 8's alpha at point 9's lam, where
     coordinates move) through the kernel and the plain loop, held as
     phase 2 holds its cases;
   - the step rules: the first 3 points of each path's grid under each
     of away, pairwise, PARTAN and lazy, the elastic-net under away and,
     sparse, the logistic's first point under away; five launches a step
     for away and pairwise (the draw, the scores, the argmax, the buffer's
     scores, the direction tail), the classic kernels for PARTAN, the
     cache's scores every step and a miss's draw for lazy; each point's
     objective from its recursions beside the one from its alpha, flagged
     past the point's certified gap (ROADMAP.md R5), and a flagged away or
     pairwise path run again up to that point with every direction tail
     replayed through its plain version (``TailShadow``);
4. the first grid points of each path against other routes, from the
   same sampler seeds: the plain ops ('torch'; 'sparse' with
   ``sparse_kernel=False``), fused against unfused, and the sparse
   backend against the dense one on a small proxy. The vertex sequences
   must agree up to the first near-tie (a fused stop may overshoot by at
   most 7 steps) and the objectives to a stated tolerance; and one chunk
   of 4 batched lanes (p = 200,000, m = 800, 400 steps, one lane freezing
   early) on both layouts, unfused and fused, each lane's alpha bits,
   iterations, n_dots and vertex sequence equal to a sequential solve
   replaying the rows it drew; the elastic-net's fused path against its
   unfused points, and each extension oracle's kernels against the plain
   route on its first 2 points, under the same near-tie rule (on the
   oracle's selected scores, from the state rebuilt by a replay); each
   rule's first point on the kernels against the plain route, every
   step's vertex, n_dots, stall and support size up to the first near-tie
   of any of the rules' decisions (``RuleTieProbe``) and its objective
   while those agree, each direction tail of the kernels' route replayed
   through its plain version on the same inputs (``TailShadow``), and
   the reference's acceptance design (``tests/test_step_rules.py:42-61``)
   on 'kernels' and 'sparse', its bars printed as a finding;
5. timing of each kernel, its bound, its plain version and a library
   call, with CUDA events (K2's argmax also at n = p), beside the launch
   floor (an empty kernel, back to back); and the host's
   share of a step, one step per dispatch and fused at K = 8 and K = 32,
   on each path; the lane kernels at L = 13 and the batched step at 13
   lanes and at 1 on each path; the elastic-net's instantiations and the
   elastic-net and logistic steps' wall, device time and idle share on
   each path; ``solve_with_history`` on a small problem, its history bit
   for bit the per-step objectives; the direction tail beside its bound
   and plain version, K2/K5 at width 1 on the buffer, and the rules'
   steps (away and pairwise, PARTAN, lazy on a hit and on a miss, the
   EN's and the logistic's away step): wall, device busy, launches and
   idle share; the CD sweep on Pyrim (L2 flushed) beside its byte bound,
   its chain's floor (p dependent warp sums) and its plain loop (the warm
   sweep above), and a FISTA iteration (the difference of a 250- and a
   50-iteration solve, each run to its length) beside its two ``torch.mv``
   calls.

Observability (the telemetry ring, the tracer, the metrics registry), on
each path: phase 2 holds the TEL instantiations (the ring's record written
inside the step tail's launch, one-lane and lanes, lasso and EN, and inside
the replay's) bit for bit against their plain versions, ring words and
device cursors included (the objective on and off, the wrap from the last
slot to 0, a renorm, a frozen lane, a masked replay tail, bf16); phase 3
runs the dense path's first 3 points unfused with a ring of 256 streaming
to a sink, under a tracer and a registry, against the same points with all
of it off (the trajectory, launches with the TEL tail in the tail's place,
every record at the sink once and in order, each point's last objective
its result's, a valid Chrome trace, the registry's totals), the EN's first
point and 3 EN lanes, a chunk of 13 lasso lanes each lane's ring bitwise
its sequential solve's, and on both layouts the first 3 points fused with
``record_objective=False`` (the TEL replay); phase 5 times the TEL tail and
replay beside their plain instantiations in turns, and the dense unfused
step's wall and device time with the ring on and off, alternated.

Resilience (the guarded solve, checkpoints, shards): phase 2 holds
``health_flags`` bit for bit against its plain version (a clean state and
NaN, +Inf, -Inf at the first, a middle and the last element of beta and
the residual and in each scalar; the dense size, E2006's and a ragged one;
f32 and bf16; twice each); phase 3 runs the dense path's first 3 points
through the guarded solve, fused and unfused: with no fault bit for bit
the unguarded path (one ``health_flags`` launch a check), ``co_nan``
healed at rung 1 and ``beta_nan`` at rung 2 (the counters exact, rung 3
at 0; the unfused retry bit for bit, the rest to rounding against the
unfused path), ``fw_path`` killed at point 1 and resumed, and
``fw_path_batched`` in lanes of 13 killed at chunk 1 and resumed (f32 and
bf16), bit for bit; on the sparse path the E2006-log1p proxy's 137 M
triplets go to coo-npz-v1 shards and back through
``load_shards_as_matrix(device='cuda')`` (the proxy's matrix, a fused
point on it bit for bit, a corrupted read healed by one retry, each
pass's GB/s); phase 5 times ``health_flags`` beside its plain version and
bound, the snapshot, and a guarded fused point against an unguarded one.

About 10 to 13 minutes on an H100, the builds included, as fast as the
host (aim: 600 s, limit 1200 s); the baselines' phases print their
seconds and take about 110, the plain warm sweep 60 of them. ``--kernels-only`` stops
each path after its phase 2 (and prints no JSON lines).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at its 700 W limit
PEAK_F32_FLOPS = 67e12  # H100 SXM data sheet, f32 outside the tensor cores

# main path: examples/lasso_fullpath_4m.py --paper-size, dense, with the
# example's whole 100-point grid; its first 3 points rerun on 'torch'
P_PAPER, M_PAPER, N_REL = 4_272_227, 800, 300
N_POINTS, N_COMPARE = 100, 3
FUSE = 8  # the fused path's K, the value the reference's tests pin
# sparse path: examples/lasso_fullpath_4m.py --paper-size --backend sparse
# at E2006-log1p's published size (src/repro/data/proxies.py:47-52), blocks
# of 256 as the example; the proxy of the sparse-vs-dense check is the same
# dataset at scale 0.01 (m = 160, p = 42,722)
M_E2006, COL_DENSITY, SPARSE_BLOCK = 16_087, 0.002, 256
N_BLOCK_STEPS = 300  # the 'block'-sampling point's fixed length
N_FULL_STEPS = 50  # the dense 'full'-sampling point's, each step reading all of Xt
# sha256 of K5's scores on ``k5_digest_inputs`` (the E2006-log1p proxy, r =
# y) as the warp-per-feature K5 (the kernel before the ring) computed them
# on an H100: the ring kernel must keep their bits at both widths
K5_SHA256 = {1: "6589658b956296f21bc41e62f507ca70e36379b48b1db9dc43ff1a27b8620953",
             SPARSE_BLOCK: "ce694e17cce6ce06de85c55cf3cebb3993270522d082e77447e807e50affa7e1"}

# f32 sums of m products, taken in another order than the plain version's:
# the difference is rounding, a few ulps of the Cauchy-Schwarz scale
# ||x|| * ||v|| per dot product (worst case m * 2^-24 ~ 5e-5 at m = 800,
# typically under 1e-6), so 1e-5 of that scale.
RTOL_SUM = 1e-5
# the two backends' vertex scores differ by that rounding plus what it
# accumulates in the state over a run; two sampled coordinates whose
# |scores| lie within this fraction of ||r|| are a near-tie
RTOL_TIE = 1e-4
# objectives of the two backends while their trajectories agree (rounding
# of the S/F recursions), and after a near-tie sent them apart (two
# different runs of the same stochastic solver, both stopped at tol 1e-3)
RTOL_OBJ_SAME, RTOL_OBJ_APART = 1e-5, 1e-3
# a stall test that two runs matching to rounding may decide apart: its
# margin (num - gap_rtol * gap_scale, or step_inf - tol) within this
# fraction of its scale, about the f32 drift of the S/F/Q recursions over a
# refresh period (64 steps of a few ulps, 2^-24 each)
RTOL_STALL = 1e-5


# The reference's converging golden (tests/test_engine.py:89-97) on the
# small_problem geometry: the index stream of its 25 steps, drawn by
# jax.random in legacy threefry mode from PRNGKey(42) (int16 little-endian,
# 25 x 60, base64), and its vertex sequence. tests/test_torch_engine.py
# checks both against the reference.
GOLDEN_I_STAR = [272, 54, 192, 260, 70, 54, 244, 248, 248, 193, 297, 260, 248,
                 287, 193, 248, 272, 169, 204, 272, 105, 287, 68, 260, 242]
GOLDEN_OBJECTIVE = 751729.4375
GOLDEN_STREAM = (
    "vwC/AGIAGAAbAVoAuQDSAF8AqQA2ABcAaQBFANcAkQDDALcAIADaAPYAGQAQATwA5QAxABgAgAC9"
    "APsAPADeACkBawANACUB3QAFAGYAEwH8ACABHQENAJwAFQAJARgAkwCeAJAA3wBcAJkA0QAcAbIA"
    "agClAFwAWwB4AMcAIgF0ABIBdQCPAMIAxAC9APQAOgC3ABQAuAAcAGkAggD6AAUBwwAMAVgA0QCh"
    "AD4AQwBVACIAiQAZAGcAnQAUAP0ALQAXAPgA8AAnAZcAkAAYAK0AuAC9AHUASwArAIQACgEoAF8A"
    "FwAuAOQANgAAAAoAQgA8APUAfwDaAEwARwAtAFkANwB8AC0ArgAHARgA8QCaAAgAhQDAAIgA/ADx"
    "ALkAFgC8AGoAFgAwAOgAKwC0AHAACgCkAFMAegC0ALwA7gCeAAEBzQDsAFkA6ABFAB0AbQCTAAEB"
    "vAAHAcgAdgBEABUBNQDEABoBywBfAF0AkwAVAXEAKQDuAHQA2AAXAGYArwDwAEMAywBMAAYB9wBC"
    "AL4AIAFCALYAPwCIAA4ABAFTADgAmgBaAGkAWQCHADwANADWAEoA+QAWAR0B9ACuACIA2gC1AOkA"
    "LgBFAJwAAgAsAGAACQAKACsAnABJAG0A0QCmAJkAOwANAG4AWQASAY4AowCLAMsAMwA5AAYAhwB1"
    "AO0A7AAEAegAQwBGAIUA4ACCAGoAmAAFAdsAaQAAAdsAqAANAEMAqgBcAJMAPgC2AE8ADwH+AOQA"
    "HgEcACAAQAAOASoAaAAcAF8AhgD3APQADAH5AAUBswBfAMoA3ACEAEIAIQAqAcAA2QABAA4AXACH"
    "ADQAHAFHABcA3QDiAL0AwQA2AHUAfADTABgAeAAaAS0ABwDMAFkAAgBfADwACwBEACMB6gDQAJgA"
    "jgDUACABQQACAWsAlwARAN8A+wDUAKYAqAAVAaoAvwCfANgAXQDLALQAHQFWALkAFwABAWUAbQCD"
    "ABsADgF1AHcArQASADIAAgFkACMBCADbAG4AWgD/ACoAQQB4AOYA5gC1AI4AOgADASAAEgDeAEsA"
    "iABhABcBWwAfAHAABgCjAN0AhADrAPQAEgFVACMArQDiAHgAJAAOAW0A+ADmAAEB0wB5AAUBBwHx"
    "AAoAdgAAAI8AhwBtAL8AEwG0AJwAxAC1AOAAmQDPAB0BAwC1AKAA9wCxAN0ADwHbAH4ADgDpAEcA"
    "9AB3AIAAegCeAFkA0gAUAfMAiQAQAJgACwB1APMA+gBcAIwARQAyAPEAOACTAI8AnwAqAHoAVwAT"
    "AOUAswBRAOEA4QAoAUIAqQDjAH8AIgBgALEA+wAfAMEAyAA5AH0AFgERACoAZwBYANoADwFOABoB"
    "OQDRAA0BLACaAIIAFwCUALsAuABtAAUAPwD6APgAAABPAKYAaAB8ACUAVADbAOkApgDAAIYAngCv"
    "ACEBLAAgAHcAbQAFAR4BoQAkAVUAKAAaAaQAFAHBAMQADAAxAGsAAgAMAA0B6QCcAAsBpAB1AA0B"
    "0wCrAEIADAGTAMMAzAB/AHUASgAyAD8A7gBkAPEACAApAJIA3QAVAQ8A3AAYACsADADmALEAqQBN"
    "AMAA/QDXACkBeQAxAFAA/QBfABYBHQEGAYQAbwByAH0ArwDyAAYBBwG1ALcAXgAcAQgBnwDkANgA"
    "kwCrADAALQAAAZ4ADwDfAPQAvQBMAC8AegCDAJwAkgAJAbQAngDhAFgAiwBqAGwAEwH8ALkAIAH8"
    "ANsAnABcAIIA8AAXADIAyQCUAEsA3wDzAPkA0gARARwAEQHjACgBDgEJADsADAAQACAAuQACAQAB"
    "VAAEARUB7wBfANsArADzAFcAFAFjAFgAnQATAM0AIADTAPsAqAB3AB4BAQEGAP4A1gAoAN4ARABl"
    "AKMA1gA/AFMAIAE6AAsA2QAhAPEAKwHTAPAA/gAMAT0AKAC/ANkAigDtAOIAjAAfAZMAEwFgAOUA"
    "hgDaACgAFgEVAAsBCwEdAScA2QA0AP8A0wAuACsBSgCrAMoA4wANAQAAqQCBAGAAVgDoAEwA7AAH"
    "ABMBzQAfACUBnwC7APgAPAAcAIEAYwA4AG0AJgEjAGIA/QAZAdYACgByABMBVgClALkAtQAkAWoA"
    "3wD+ALgA2gCNAFkAngClAAwA1gAmASgAuwAfAO0AtAC2AGcAqwAvAH4AfwDwABgAygCXAPsAHgGP"
    "AKUAIQEIAaEAqwArAbIAHwEGAPUAlwCKAE4ABAArATkAowCpAC0ATwBeAHUA6gB5AC8AYQAyAJIA"
    "NACfACgAHgBeAFYA/gBKAGIAgQBYACQBHQD9AMEARwC7ANoAQQCzAN0AcQAIAX0AYQB5AIgA9gCR"
    "AAUBSwBUAJ4AbAB6AHIAPAAdADcAFQHzAB8BGQEIAUIACgDzADIAJgC5AO8ACgCVAGEAKwEHAAEA"
    "4gDjAPIA6wD4ADIAAwEFANMA7wAkAIkA0wAcACYBmAAAAfYAvAAMAE0AzwCSAKMA0AA6AJsAGQAX"
    "AJMA5wAPADQAigBLAK4AJgC/ANoAFgCHAHcAyACbAAAAoQARAP4ASAAJAeQA3wCNANgAywAcARwB"
    "fwCuAAYBYACAAAQASQB2AHUABAE7AGcAGQB7AOEAlACIAMgAzQDXAEoA5wCJAKsABAEQAQgAcwBk"
    "AA8AHgHsAGkABwEFAF8AzgBtAMAAGgAqAbgABwEFABoBUQAYASUAwAA8AC4ACwGZAMYA6QAhAJcA"
    "EgBiANMAOgDGANIA0wALAKwAKgAUAZgAsgBuAKkAbgDWAM8AtgDSABUBbABPABQANAD6ADgAFAGt"
    "ANEAVgAmAe4ASQB1AAwBCADxAH4AugAQAJwApQAHACcB/QCzAN8A+QCOAAEBmwBAAJcA2QAPAZMA"
    "8QCLAKwAYAC3AP8AxQA+AHEA+gChAOwAEQCTABsArwD9AMQAWwB9AFEA1QBOAFAAAgHnADgA3ADc"
    "AAIAFwDMAJEAjgDQAEsAkAC/AB0ADwHxAEwAzAAgAOQAGABSALsAeQCMALYAugAkANgApwDsAMsA"
    "/gBRAPIAIwCWAEwA+wDyAJsANAD9AA8BOABgAC0AVACAAD0AVgDqACsAFgEaAdsA4QAVACABiQBP"
    "ALoArAD0AFMAYQAYAfYAewDaAAwB6gDVAMMAmQAHAAcBZgC5AMMAswBZAGgA0QDEAOEAIABaABAB"
    "nABxADEALgCaAOQAZQCTAHEA+wDrAAcAYADFACkASgBxAM4AMACMABIBigCBAAIAdAAmAEMAFQH5"
    "ABUBOwAvAJYAtwAcAdgADwA9AA4B7QAEAHkAhQCqABcAEgBSAGkAQQAAARUADwEUATEA9QDkAFMA"
    "uwAaAAEBVgADAFIARAC0AAQBKwATAaEAjAAfAYQAJwGWAAAAIQBxALYAoQCYANcADQAjAAIAGAGH"
    "AMwATABKAPkAOwDnAMsA/wAgADgA+gBfADMAHABQAEgASACVAPwADACzAG4AzgDxAKoAvQCwAEQA"
    "xQATAYIAsQDNADwAuQDPAIEAogAbAWAAOACxAHYAHAFsAPcADgBEADEARQCdACwAqwBJANAAxABT"
    "ALwAmAClAF8ADwEnATEAVgCHABsBDwHdANMABwAFAPUAIgCcAE8AZgCgAHcA0QAuAPYAagAsAE4A"
    "TAARAWYA+gBMACkA0ACcAPUASACOAMUAfgBPABMA3wBqALMAKQDWAD0AbgASAM4AcAARAFUAqwCr"
    "APMADwCEAJ4AfwANABYAmwD+AL8ASwASAMwAugAdAQoB/gAkAH0AKQARAAQBTADVACsAEAAWABsA"
    "GQAiACAAXQBgAJsAvABPAKcAEwEUAWAAxACYAAsBbQCzAB0BIQD1ACMA6gDwAJMAygAVAJ0AWQD0"
    "AOkAdAAOAHQAFQGtAKEAPQDyAGsASgBrAL0AzgDmAHQAKAAQABYAcwAbAR0ACgHQADkA6AAHAckA"
    "IgA/AAYAvwB/ANMAtgAEADgA4QDpAAAA/gBeAFgACwF/ALcA"
)


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true", help="phases 1-2 only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout that holds src/repro_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    t_start = time.perf_counter()
    card = phase1_device_and_build(torch)
    dev = torch.device("cuda")
    errs, launches, timing = {}, {}, {}
    for name, path in (("dense", dense_path), ("sparse", sparse_path)):
        t0 = time.perf_counter()
        path(torch, dev, args.kernels_only, errs, launches, timing)
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    if args.kernels_only:
        print(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s")
        return 0

    records = []
    for name, info in KERNELS.items():
        t = timing[name]
        records.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"], "launches": launches[name],
            "max_abs_err": max(errs[name], errs.get(f"{name}_sparse", 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dense_path(torch, dev, kernels_only, errs, launches, timing):
    """Phases 2-5 on the dense paper-size problem; the design is freed after."""
    from repro_torch.data import make_wide_problem

    t0 = time.perf_counter()
    Xt, y, coef = make_wide_problem(P_PAPER, M_PAPER, N_REL, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[problem] p={P_PAPER:,} m={M_PAPER} f32 Xt={Xt.numel() * 4 / 1e9:.2f} GB "
          f"built on the card in {time.perf_counter() - t0:.2f} s")

    errs.update(phase2_kernels(torch, Xt, y))
    errs.update(phase2_fused(torch, Xt, y))
    errs.update(phase2_lane_kernels(torch, Xt, y))
    errs.update(phase2_en_kernels(torch, Xt, y, "dense"))
    errs.update(phase2_rule_kernels(torch, Xt, y, "dense"))
    errs.update(phase2_cd_sweep(torch, dev))
    errs.update(phase2_tel_kernels(torch, Xt, y, "dense"))
    errs.update(phase2_health(torch, [(P_PAPER, M_PAPER), HEALTH_RAGGED], "dense"))
    golden_check(torch, dev)
    bf16_solves(torch, dev, "kernels")
    if not kernels_only:
        main_launches, main_run = phase3_main_path(torch, Xt, y, coef)
        phase3_fista_paper_width(torch, Xt, y, main_run)
        fused_launches, fused_run = phase3_fused_path(torch, Xt, y, main_run)
        phase3_full_point(torch, Xt, y, main_run)
        launches.update(main_launches)
        for name in ("dense_fused_chunk", "fused_replay"):
            launches[name] = fused_launches[name]
        batched_launches, batched_run = phase3_batched_path(torch, Xt, y, coef, "dense")
        for name in ("sampled_scores_lanes", "vertex_argmax_lanes", "step_tail_lanes"):
            launches[name] = batched_launches[name]
        phase4_other_backend(torch, Xt, y, main_run)
        phase4_fused_vs_unfused(torch, Xt, y, main_run, fused_run)
        launches["health_flags"] = phase3_guarded(torch, Xt, y, main_run,
                                                  fused_run)["health_flags"]
        phase3_checkpoints(torch, Xt, y, main_run, fused_run, batched_run)
        timing.update(phase5_resilience_timing(torch, Xt, y, main_run, fused_run))
        phase4_lanes_vs_sequential(torch, dev)
        en_launches, en_runs = phase3_en_paths(torch, Xt, y, coef, "dense")
        launches.update(en_launches)
        log_runs = phase3_logistic_paths(torch, Xt, y, coef, "dense")
        phase4_extensions(torch, Xt, y, en_runs, log_runs, "dense")
        timing.update(phase5_timing(torch, Xt, y))
        timing.update(phase5_lane_timing(torch, Xt, y, "dense"))
        timing.update(phase5_ext_timing(torch, Xt, y, "dense"))
        rule_launches, _ = phase3_rule_paths(torch, Xt, y, coef, "dense")
        for name in ("dir_tail", "dir_tail_en"):
            launches[name] = rule_launches[name]
        phase4_rule_routes(torch, Xt, y, coef, "dense")
        phase4_rule_acceptance(torch, dev)
        timing.update(phase5_rule_timing(torch, Xt, y, "dense"))
        history_check(torch, dev)
        launches.update(phase3_obs(torch, Xt, y, coef, "dense"))
        timing.update(phase5_tel_timing(torch, Xt, y, "dense"))
        timing.update(phase3_baselines(torch, dev, launches, errs))
    del Xt
    torch.cuda.empty_cache()


def sparse_path(torch, dev, kernels_only, errs, launches, timing):
    """Phases 2-5 on the E2006-log1p proxy at its published size."""
    from repro_torch.data import PROXY_SPECS, make_sparse_wide_problem

    spec = PROXY_SPECS["e2006-log1p"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mat, y, coef = make_sparse_wide_problem(spec.m, spec.p, spec.col_density, spec.n_relevant,
                                            seed=0, device=dev, block_size=SPARSE_BLOCK)
    torch.cuda.synchronize()
    nnz = int(torch.count_nonzero(mat.values))
    print(f"[sparse-problem] E2006-log1p proxy m={mat.m:,} p={mat.p:,} col_density="
          f"{spec.col_density} block_size={mat.block_size}: {nnz:,} stored nonzeros, "
          f"nnz_max={mat.nnz_max}, values+rows {mat.nbytes / 1e9:.3f} GB "
          f"({mat.nbytes:,} bytes), built on the card in {time.perf_counter() - t0:.2f} s, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    errs.update(phase2_sparse_kernels(torch, mat, y))
    errs.update(phase2_sparse_lane_kernels(torch, mat, y))
    en_errs = phase2_en_kernels(torch, mat, y, "sparse")
    errs["sparse_fused_chunk_en"] = en_errs.pop("sparse_fused_chunk_en")
    errs.update({f"{k}_sparse": v for k, v in en_errs.items()})
    errs.update(phase2_rule_kernels(torch, mat, y, "sparse"))
    errs.update(phase2_tel_kernels(torch, mat, y, "sparse"))
    errs.update(phase2_health(torch, [(mat.p, mat.m)], "sparse"))
    sparse_golden_check(torch, dev)
    bf16_solves(torch, dev, "sparse")
    if kernels_only:
        return
    fused_launches, fused_run = phase3_sparse_fused_path(torch, mat, y, coef)
    phase3_shards(torch, mat, y, fused_run)
    phase3_warm_start_bits(torch, mat, fused_run)
    unfused_launches, unfused_run = phase3_sparse_unfused_points(torch, mat, y, fused_run)
    block_launches = phase3_sparse_block_point(torch, mat, y, fused_run)
    launches["sparse_colstats"] = fused_launches["sparse_colstats"]
    launches["sparse_fused_chunk"] = fused_launches["sparse_fused_chunk"]
    launches["sparse_sampled_scores"] = unfused_launches["sparse_sampled_scores"]
    print(f"[sparse] K5 launches: {unfused_launches['sparse_sampled_scores']} at width 1 "
          f"(unfused points), {block_launches['sparse_sampled_scores']} at width "
          f"{SPARSE_BLOCK} (the block point)")
    batched_launches, _ = phase3_batched_path(torch, mat, y, coef, "sparse")
    launches["sparse_sampled_scores_lanes"] = batched_launches["sparse_sampled_scores_lanes"]
    for name in ("vertex_argmax_lanes", "step_tail_lanes"):  # both batched paths
        launches[name] += batched_launches[name]
    phase4_sparse_routes(torch, mat, y, fused_run, unfused_run)
    phase4_sparse_vs_dense(torch, dev)
    en_launches, en_runs = phase3_en_paths(torch, mat, y, coef, "sparse")
    for name, n in en_launches.items():  # the shifted argmax, the EN tail: both paths
        launches[name] = launches.get(name, 0) + n
    log_runs = phase3_logistic_paths(torch, mat, y, coef, "sparse")
    phase4_extensions(torch, mat, y, en_runs, log_runs, "sparse")
    timing.update(phase5_sparse_timing(torch, mat, y))
    timing.update(phase5_lane_timing(torch, mat, y, "sparse"))
    timing.update(phase5_ext_timing(torch, mat, y, "sparse"))
    rule_launches, _ = phase3_rule_paths(torch, mat, y, coef, "sparse")
    for name in ("dir_tail", "dir_tail_en"):
        launches[name] += rule_launches[name]
    phase4_rule_routes(torch, mat, y, coef, "sparse")
    timing.update(phase5_rule_timing(torch, mat, y, "sparse"))
    for name, n in phase3_obs(torch, mat, y, coef, "sparse").items():
        launches[name] += n
    phase5_tel_timing(torch, mat, y, "sparse")  # printed beside the dense rows


KERNELS = {
    "colstats": dict(source="src/repro_torch/kernels/csrc/colstats.cu",
                     replaces="src/repro/kernels/colstats/colstats.py:54"),
    "sampled_scores": dict(source="src/repro_torch/kernels/csrc/fw_grad.cu",
                           replaces="src/repro/kernels/fw_grad/fw_grad.py:79"),
    "vertex_argmax": dict(source="src/repro_torch/kernels/csrc/fw_grad.cu",
                          replaces="src/repro/kernels/fw_grad/ops.py:27"),
    "residual_update": dict(source="src/repro_torch/kernels/csrc/residual_update.cu",
                            replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                      replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "dense_fused_chunk": dict(source="src/repro_torch/kernels/csrc/fused_step.cu",
                              replaces="src/repro/kernels/fused_step/fused_step.py:259"),
    "fused_replay": dict(source="src/repro_torch/kernels/csrc/fused_step.cu",
                         replaces="src/repro/core/engine.py:387"),
    "sparse_sampled_scores": dict(source="src/repro_torch/kernels/csrc/sparse_grad.cu",
                                  replaces="src/repro/kernels/sparse_grad/sparse_grad.py:87"),
    "sparse_colstats": dict(
        source="src/repro_torch/kernels/csrc/sparse_colstats.cu",
        replaces="src/repro/kernels/sparse_colstats/sparse_colstats.py:55"),
    "sparse_fused_chunk": dict(source="src/repro_torch/kernels/csrc/fused_step.cu",
                               replaces="src/repro/kernels/fused_step/fused_step.py:259"),
    # the lane axis of K2, the tail and K5: the reference's vmapped pallas_calls
    # under jax.vmap of its step (src/repro/core/engine.py:721-736)
    "sampled_scores_lanes": dict(source="src/repro_torch/kernels/csrc/fw_grad.cu",
                                 replaces="src/repro/kernels/fw_grad/fw_grad.py:79"),
    "vertex_argmax_lanes": dict(source="src/repro_torch/kernels/csrc/fw_grad.cu",
                                replaces="src/repro/kernels/fw_grad/ops.py:27"),
    "step_tail_lanes": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                            replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "sparse_sampled_scores_lanes": dict(
        source="src/repro_torch/kernels/csrc/sparse_grad.cu",
        replaces="src/repro/kernels/sparse_grad/sparse_grad.py:87"),
    # the elastic-net's instantiations: the score shift the reference runs in
    # XLA beside K2's argmax (src/repro/core/vertex.py:243-249), its tail (the
    # residual update's kernel on the path) and K4/K7's alpha ledger
    # (src/repro/kernels/fused_step/fused_step.py:137-139, 158-162, 226-230)
    "vertex_argmax_shifted": dict(source="src/repro_torch/kernels/csrc/fw_grad.cu",
                                  replaces="src/repro/kernels/fw_grad/ops.py:27"),
    "vertex_argmax_shifted_lanes": dict(source="src/repro_torch/kernels/csrc/fw_grad.cu",
                                        replaces="src/repro/kernels/fw_grad/ops.py:27"),
    "step_tail_en": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                         replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_en_lanes": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                               replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "dense_fused_chunk_en": dict(source="src/repro_torch/kernels/csrc/fused_step.cu",
                                 replaces="src/repro/kernels/fused_step/fused_step.py:259"),
    "sparse_fused_chunk_en": dict(source="src/repro_torch/kernels/csrc/fused_step.cu",
                                  replaces="src/repro/kernels/fused_step/fused_step.py:259"),
    # the away and pairwise rules' direction tail: the port's own kernel for
    # what the reference runs as XLA ops after its Pallas scores
    # (src/repro/core/step_rule.py:117-153 and 248-318, the oracles'
    # dir_line_search/dir_update_co at src/repro/core/fw_lasso.py:188-226)
    "dir_tail": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                     replaces="src/repro/core/step_rule.py:117"),
    "dir_tail_en": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                        replaces="src/repro/core/step_rule.py:117"),
    # one sweep of the baselines' coordinate descent: the port's own kernel
    # for the reference's XLA fori_loop of coord_update (no pallas_call)
    "cd_sweep": dict(source="src/repro_torch/kernels/csrc/cd_sweep.cu",
                     replaces="src/repro/core/baselines.py:70"),
    # the telemetry ring's record written inside the tail and the replay
    # (their TEL instantiations), for the reference's per-step ring writes
    # beside the residual update's kernel and in its replay
    # (src/repro/core/engine.py:307-327, 411-417)
    "step_tail_tel": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                          replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_en_tel": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                             replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_lanes_tel": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_en_lanes_tel": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "fused_replay_tel": dict(source="src/repro_torch/kernels/csrc/fused_step.cu",
                             replaces="src/repro/core/engine.py:387"),
    # the guarded solve's health check in one launch: the port's own kernel
    # for the reference's jitted XLA check between chunks
    "health_flags": dict(source="src/repro_torch/kernels/csrc/health.cu",
                         replaces="src/repro/resilience/guards.py:127"),
}


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------


def phase1_device_and_build(torch):
    card = card_line()
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import _build

    nvcc_version = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                                  text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"[build] {nvcc_version}; the cooperative grid sync of fused_step.cu "
          "(cooperative_groups::this_grid().sync()) needs no flag beyond these "
          "(no -rdc) on CUDA >= 11")
    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {len(logs)} sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[build] torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------


def _scaled_err(torch, got, want, scale):
    """max |got - want| / scale over the entries, and max |got - want|."""
    d = (got.float() - want.float()).abs()
    return float((d / scale).max()), float(d.max())


def _top2_margin(torch, mags, idx):
    """Gap between the two largest |scores| of distinct coordinates."""
    uniq, inv = torch.unique(idx, return_inverse=True)
    best = torch.full((uniq.numel(),), -1.0, device=mags.device).scatter_reduce(
        0, inv, mags.float(), reduce="amax")
    if best.numel() < 2:
        return float("inf")
    top = torch.topk(best, 2).values
    return float(top[0] - top[1])


def _check_vertex(torch, fw, label, Xt, r, blk, bs, p):
    """fw_vertex (both kernels) vs the plain version: i_star equal unless
    the plain scores' top-2 are a near-tie within the summation tolerance;
    g_star within it."""
    i_k, g_k = fw.fw_vertex(Xt, r, blk, bs, p_valid=p)
    scores_p = fw.sampled_scores_plain(Xt, r, blk, bs)
    i_p, g_p = fw.argmax_plain(scores_p, blk, bs, p)
    scale = float(torch.linalg.vector_norm(r.float())) * float(
        torch.linalg.vector_norm(Xt.float(), dim=1).max())
    if int(i_k) != int(i_p):
        idx = fw.block_indices(blk.long(), bs)
        valid = idx < p
        margin = _top2_margin(torch, scores_p.abs()[valid], idx[valid])
        check(margin <= RTOL_SUM * scale,
              f"{label}: i_star {int(i_k)} != plain {int(i_p)} and the top-2 margin "
              f"{margin:.3e} is no near-tie")
        print(f"[kernels] {label}: i_star differs at a near-tie (margin {margin:.3e})")
    else:
        check(abs(float(g_k) - float(g_p)) <= RTOL_SUM * scale,
              f"{label}: g_star {float(g_k)} vs plain {float(g_p)}")


def argmax_edge_cases(torch, fw, dev, g):
    """vertex_argmax bit-exact against argmax_plain, one launch a call: at n
    on either side of one block's share of scores, at n = p under 'full'
    sampling (blocks of 128, every block in order), on a tie across two
    blocks of the grid, on NaN scores and with every index masked."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    share = fw.ARGMAX_THREADS * fw.ARGMAX_PER_THREAD
    n_full = -(-P_PAPER // 128) * 128
    for n, bs in ((1, 1), (31, 1), (1025, 1), (share - 1, 1), (share, 1), (share + 1, 1),
                  (n_full, 128)):
        nb = n // bs
        if bs == 1:  # distinct random ids, the 5 largest masked
            blk = torch.randperm(4 * n + 8, generator=g, device=dev)[:nb]
            p_valid = int(blk.max()) - 4
        else:
            blk = torch.arange(nb, device=dev)
            p_valid = P_PAPER
        ok = fw.block_indices(blk, bs) < p_valid
        valid = ok.nonzero().view(-1)
        blocks, chunk = fw.argmax_grid(n, sms)
        a, b = (chunk - 1, chunk) if blocks > 1 else (n // 3, n - 1)
        for kind in ("random", "tie across blocks", "nan", "all masked"):
            s = torch.randn(n, generator=g, device=dev)
            pv, want = p_valid, None
            if kind == "tie across blocks" and a != b and bool(ok[a]) and bool(ok[b]):
                s[a], s[b] = 50.0, -50.0
                want = a
            elif kind == "nan" and valid.numel():
                want = int(valid[valid.numel() // 2])
                s[want] = float("nan")
                s[int(valid[-1])] = float("nan")
            elif kind == "all masked":
                pv, want = 0, 0
            before = fw.vertex_argmax.launches
            i, v = fw.vertex_argmax(s, blk, bs, pv)
            i_p, v_p = fw.argmax_plain(s, blk, bs, pv)
            check(fw.vertex_argmax.launches == before + 1, "vertex_argmax: one launch a call")
            vk, vp = float(v), float(v_p)
            check(int(i) == int(i_p) and (vk == vp or (math.isnan(vk) and math.isnan(vp))),
                  f"vertex_argmax n={n} bs={bs} {kind}: ({int(i)}, {vk}) vs plain "
                  f"({int(i_p)}, {vp})")
            if want is not None:
                check(int(i) == int(fw.block_indices(blk, bs)[want]),
                      f"vertex_argmax n={n} bs={bs} {kind}: the winner is not position {want}")
        print(f"[kernels] vertex_argmax n={n} bs={bs}, {blocks} blocks of {chunk} scores: "
              "random, a tie across blocks, NaN, all masked: bit-exact with the plain version")


def phase2_kernels(torch, Xt_main, y_main):
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import colstats as cs
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import residual_update as ru

    dev = Xt_main.device
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    errs = {}
    print(f"[kernels] tolerance: sums of products within {RTOL_SUM:g} of "
          f"||x||*||v|| (summation order); argmax and eq. 10 exact")

    # ---- K1 colstats -----------------------------------------------------
    def k1(label, Xt, y):
        zty, zn2 = cs.colstats(Xt, y)
        zty_p, zn2_p = cs.colstats_plain(Xt, y)
        norms = zn2_p.sqrt() * float(torch.linalg.vector_norm(y.float()))
        e1, a1 = _scaled_err(torch, zty, zty_p, norms.clamp_min(1e-30))
        e2, a2 = _scaled_err(torch, zn2, zn2_p, zn2_p.clamp_min(1e-30))
        print(f"[kernels] colstats {label}: zty err {e1:.2e} (abs {a1:.2e}), "
              f"znorm2 rel err {e2:.2e} (abs {a2:.2e})")
        check(e1 <= RTOL_SUM and e2 <= RTOL_SUM, f"colstats {label} disagrees")
        return max(a1, a2)

    errs["colstats"] = k1("main p=4272227 m=800 f32", Xt_main, y_main)
    for p, m, dt in ((1000, 803, torch.float32), (1000, 800, torch.bfloat16),
                     (1000, 803, torch.bfloat16), (77, 20000, torch.float32)):
        X = torch.randn((p, m), generator=g, device=dev).to(dt)
        yv = torch.randn(m, generator=g, device=dev).to(dt)
        k1(f"p={p} m={m} {str(dt)[6:]}", X, yv)
    buf = torch.randn(100 * 800 + 1, generator=g, device=dev)
    X_unaligned = buf[1:].view(100, 800)  # rows 4 bytes off a 16-byte boundary
    k1("p=100 m=800 f32 unaligned rows", X_unaligned, torch.randn(800, generator=g, device=dev))

    # ---- K2 sampled_scores + vertex_argmax --------------------------------
    p, m = Xt_main.shape
    kappa = kappa_fraction(p, 0.01)
    idx = TorchSampler(7, dev).uniform(kappa, p)
    s_k = fw.sampled_scores(Xt_main, y_main, idx, 1)
    s_p = fw.sampled_scores_plain(Xt_main, y_main, idx, 1)
    scale = float(torch.linalg.vector_norm(y_main))  # unit-norm rows
    e, a = _scaled_err(torch, s_k, s_p, scale)
    print(f"[kernels] sampled_scores main kappa={kappa} bs=1 f32: err {e:.2e} (abs {a:.2e})")
    check(e <= RTOL_SUM, "sampled_scores main disagrees")
    errs["sampled_scores"] = a
    _check_vertex(torch, fw, "fw_vertex main", Xt_main, y_main, idx, 1, p)
    i_k, g_k = fw.vertex_argmax(s_k, idx, 1, p)
    i_p, g_p = fw.argmax_plain(s_k, idx, 1, p)
    check(int(i_k) == int(i_p) and float(g_k) == float(g_p), "vertex_argmax main disagrees")
    errs["vertex_argmax"] = abs(float(g_k) - float(g_p))

    for m_r, dt, aligned in ((803, torch.float32, True), (800, torch.float32, True),
                             (800, torch.bfloat16, True), (803, torch.bfloat16, True),
                             (800, torch.float32, False)):
        p_r = 1000  # not a multiple of 32 nor of 128: the last block is a masked tail
        if aligned:
            X = torch.randn((p_r, m_r), generator=g, device=dev)
        else:
            X = torch.randn(p_r * m_r + 1, generator=g, device=dev)[1:].view(p_r, m_r)
        X[17] = X[5]
        X[900] = X[5]
        X = X.to(dt)
        r = X[5].clone()  # rows 5, 17, 900 tie exactly for the largest |score|
        lab = f"p={p_r} m={m_r} {str(dt)[6:]}{'' if aligned else ' unaligned rows'}"
        for bs, blk, want in (
            (1, torch.tensor([3, 17, 998, 5, 17, 42, 999, 900], device=dev), 17),
            (1, torch.randint(0, p_r, (300,), generator=g, device=dev), None),
            (128, torch.tensor([7, 0, 3], device=dev), 900),
            (128, torch.tensor([0, 7], device=dev), 5),
        ):
            sk = fw.sampled_scores(X, r, blk, bs)
            sp = fw.sampled_scores_plain(X, r, blk, bs)
            sc = float(torch.linalg.vector_norm(r.float())) * float(
                torch.linalg.vector_norm(X.float(), dim=1).max())
            e, _ = _scaled_err(torch, sk, sp, sc)
            rows = fw.block_indices(blk, bs)
            tail = rows >= p_r
            check(e <= RTOL_SUM, f"sampled_scores {lab} bs={bs} disagrees ({e:.2e})")
            check(bool((sk[tail] == 0).all()), f"sampled_scores {lab}: tail rows not 0")
            ik, gk = fw.vertex_argmax(sk, blk, bs, p_r)
            ip, gp = fw.argmax_plain(sk, blk, bs, p_r)
            check(int(ik) == int(ip) and float(gk) == float(gp),
                  f"vertex_argmax {lab} bs={bs}: {int(ik)} vs plain {int(ip)}")
            if want is not None:
                check(int(ik) == want, f"vertex_argmax {lab} bs={bs}: tie went to "
                      f"{int(ik)}, first in sample order is {want}")
            _check_vertex(torch, fw, f"fw_vertex {lab} bs={bs}", X, r, blk, bs, p_r)
            print(f"[kernels] sampled_scores/vertex_argmax {lab} bs={bs} nb={blk.numel()}: "
                  f"err {e:.2e}, tail rows {int(tail.sum())} score 0, i_star {int(ik)}")

    argmax_edge_cases(torch, fw, dev, g)

    # ---- K3 residual_update -----------------------------------------------
    def k3(label, m_r, dt):
        r = torch.randn(m_r, generator=g, device=dev).to(dt)
        yv = torch.randn(m_r, generator=g, device=dev).to(dt)
        z = torch.randn(m_r, generator=g, device=dev).to(dt)
        lam = torch.rand((), generator=g, device=dev)
        dlt = torch.randn((), generator=g, device=dev) * 50
        out = ru.residual_update(r, yv, z, lam, dlt)
        want = ru.residual_update_plain(r, yv, z, lam, dlt)
        d = float((out.float() - want.float()).abs().max())
        print(f"[kernels] residual_update {label}: max abs err {d:.2e} (exact expected)")
        check(d == 0.0 and out.dtype == dt, f"residual_update {label} disagrees")
        return d

    errs["residual_update"] = k3("main m=800 f32", 800, torch.float32)
    for m_r, dt in ((803, torch.float32), (800, torch.bfloat16), (1_000_001, torch.float32)):
        k3(f"m={m_r} {str(dt)[6:]}", m_r, dt)

    # ---- the unfused step's tail, dense: bit for bit -------------------------
    from repro_torch.kernels import step_tail as st

    print("[kernels] step_tail: every output bit for bit against step_tail_plain (NaN at the "
          "same places)")
    tail_errs = [tail_edge_cases(torch, st, f"dense main p={p} m={m}", Xt_main, p, m,
                                 torch.float32, g, int(idx[0]))]
    for dt in (torch.float32, torch.bfloat16):
        X = torch.randn((1000, 803), generator=g, device=dev).to(dt)
        tail_errs.append(tail_edge_cases(torch, st, "dense p=1000 m=803", X, 1000, 803, dt, g,
                                         17))
        X1 = torch.randn((300, 1), generator=g, device=dev).to(dt)
        tail_errs.append(tail_edge_cases(torch, st, "dense p=300 m=1", X1, 300, 1, dt, g, 42))
    errs["step_tail"] = max(tail_errs)
    phase2_fused_past_cap(torch, dev, g, "dense")
    torch.cuda.synchronize()
    return errs


def phase2_fused_past_cap(torch, dev, g, layout):
    """F2: a fused solve (fuse_steps = 8) at m one past its layout's
    shared-memory cap (M_MAX dense, M_MAX_SPARSE sparse) runs, through K
    unfused steps on the kernels (no chunk launch; a tail launch a step),
    and equals the unfused solve bit for bit (40 steps each, no stop)."""
    from repro_torch import kernels
    from repro_torch.core import FWConfig, fw_solve
    from repro_torch.core.vertex import TorchSampler, use_fused_kernel
    from repro_torch.kernels import fused_step as fs

    n_steps = 40
    if layout == "dense":
        m = fs.M_MAX + 1
        X = torch.randn((4096, m), generator=g, device=dev)
        X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
        backend = "kernels"
    else:
        m = fs.M_MAX_SPARSE + 1
        X, _ = _unit_ell(torch, g, 4000, m, 40)
        backend = "sparse"
    y = torch.randn(m, generator=g, device=dev) * 3.0
    runs = {}
    for fuse in (1, FUSE):
        cfg = FWConfig(delta=20.0, kappa=64, max_iters=n_steps, tol=0.0, patience=10**9,
                       backend=backend, fuse_steps=fuse)
        kernels.reset_launch_counts()
        res = fw_solve(X, y, cfg, TorchSampler(4, dev), device=dev)
        launches = kernels.launch_counts()
        check(res.iterations == n_steps and launches["step_tail"] == n_steps,
              f"{layout} m={m} fuse_steps={fuse}: iterations / step_tail launches")
        check(launches["dense_fused_chunk"] == launches["sparse_fused_chunk"] ==
              launches["fused_replay"] == 0, f"{layout} m={m}: a chunk kernel launched")
        runs[fuse] = res
    check(not use_fused_kernel(cfg, X), f"{layout} m={m}: the fused kernel was chosen")
    a, b = runs[1], runs[FUSE]
    same = _same_bits(torch, a.alpha, b.alpha) and _same_bits(torch, a.objective, b.objective)
    print(f"[kernels] F2 {layout} m={m} (cap + 1): fuse_steps={FUSE} ran {b.iterations} steps as "
          f"K unfused steps (effective_fuse_steps {b.effective_fuse_steps}, {n_steps} tail "
          f"launches, no chunk launch), objective {float(b.objective)!r}, bitwise equal to the "
          f"unfused solve: {same}")
    check(same, f"F2 {layout} m={m}: the fused solve differs from the unfused one")


# --------------------------------------------------------------------------
# the unfused step's tail (kernels/step_tail), phase 2
# --------------------------------------------------------------------------

TAIL_OUT = ("beta", "scale", "maxabs", "step_inf", "stall", "resid", "S", "F")


def _same_bits(torch, a, b):
    """Equal dtype, shape and bits, NaN at the same places (a NaN's payload
    is not compared)."""
    a, b = a.reshape(-1), b.reshape(-1)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    iv = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(na, nb) and torch.equal(a.view(iv)[~na], b.view(iv)[~nb])


def _tail_args(torch, g, p, m, dtype, i_star, *, scale=1.0, s_quad=30.0, f_lin=10.0,
               g_star=-7.5, zty_i=None, zn2_i=None, delta=5.0):
    """A state for the tail: beta (p,), then step_tail's arguments from
    ``scale`` to ``delta`` (the winner ``i_star``, its score ``g_star``;
    ``zty_i``/``zn2_i`` set the winner's column statistics)."""
    dev = g.device
    zty = torch.randn(p, generator=g, device=dev)
    zn2 = torch.rand(p, generator=g, device=dev) + 0.5
    if zty_i is not None:
        zty[i_star] = zty_i
    if zn2_i is not None:
        zn2[i_star] = zn2_i

    def t(v):
        return torch.tensor(v, device=dev)

    beta = torch.randn(p, generator=g, device=dev).to(dtype)
    args = (t(scale).to(dtype), t(2.0).to(dtype), torch.tensor(3, dtype=torch.int32, device=dev),
            torch.randn(m, generator=g, device=dev).to(dtype), t(s_quad).to(dtype),
            t(f_lin).to(dtype), torch.randn(m, generator=g, device=dev).to(dtype),
            zty.to(dtype), zn2.to(dtype), torch.tensor(i_star, device=dev), t(g_star), t(delta))
    return beta, args


def _max_abs_diff(torch, outs_a, outs_b):
    """max |a - b| over every output's entries that are NaN in neither."""
    err = 0.0
    for a, b in zip(outs_a, outs_b):
        a, b = a.reshape(-1).double(), b.reshape(-1).double()
        ok = ~(torch.isnan(a) | torch.isnan(b))
        if bool(ok.any()):
            err = max(err, float((a[ok] - b[ok]).abs().max()))
    return err


def _check_tail(torch, st, label, mat, beta, args, cfg):
    """The tail kernel against ``step_tail_plain`` from the same state:
    every output bit for bit (NaN at the same places), two launches
    bitwise equal, one launch a call. Returns the kernel's outputs and
    their max |kernel - plain| (0 when the bits agree)."""
    before = st.step_tail.launches
    out_k = st.step_tail(mat, beta.clone(), *args, cfg)
    again = st.step_tail(mat, beta.clone(), *args, cfg)
    out_p = st.step_tail_plain(mat, beta.clone(), *args, cfg)
    check(st.step_tail.launches == before + 2, "step_tail: one launch a call")
    check(all(_same_bits(torch, a, b) for a, b in zip(out_k, again)),
          f"step_tail {label}: two launches differ")
    differ = [n for n, a, b in zip(TAIL_OUT, out_k, out_p) if not _same_bits(torch, a, b)]
    check(not differ, f"step_tail {label}: {differ} differ from the plain version")
    print(f"[kernels] step_tail {label}: scale {float(out_k[1])!r}, stall {int(out_k[4])}, "
          f"S {float(out_k[6])!r}: bit-exact with the plain version, two launches equal")
    return out_k, _max_abs_diff(torch, out_k, out_p)


def _tail_lam(torch, args):
    """The line search's lam on ``args`` (fw_lasso.ls_closed_form in f32,
    the tail's op order)."""
    from repro_torch.core.fw_lasso import ls_closed_form

    scale, _, _, _, s_quad, f_lin, _, zty, zn2, i, g, delta = args
    gf = g.float()
    dt = -delta * torch.sign(gf)
    lam, _, _ = ls_closed_form(s_quad.float(), f_lin.float(), gf, gf + zty[i].float(), dt,
                               zn2[i].float(), 1e-12, 1e-6)
    return float(lam)


def tail_edge_cases(torch, st, label, mat, p, m, dtype, g, i_star):
    """step_tail bit for bit against its plain version on one layout and
    dtype: a random state; lam clamped at 1 (S = F = 0, the winner's
    z.y = -g and a small ||z||^2), which renormalizes (scale * 0); lam
    clamped at 0 with no progress (F past S + delta |g|); a scale just
    under the renorm threshold after the step, and just over it; a NaN
    score; and the same coordinate winning two steps in a row (the second
    from the first's outputs). Returns the max |kernel - plain| over the
    cases."""
    from repro_torch.core import FWConfig

    cfg = FWConfig(delta=5.0)
    lab = f"{label} {str(dtype)[6:]}"
    errs = []

    def run(what, mat_, beta, args):
        out, err = _check_tail(torch, st, f"{lab} {what}", mat_, beta, args, cfg)
        errs.append(err)
        return out

    run("random", mat, *_tail_args(torch, g, p, m, dtype, i_star))
    out = run("lam clamped at 1", mat,
              *_tail_args(torch, g, p, m, dtype, i_star, s_quad=0.0, f_lin=0.0, zty_i=7.5,
                          zn2_i=1e-3))
    check(float(out[1]) == 1.0, f"step_tail {lab}: lam = 1 did not renormalize")
    out = run("lam clamped at 0, no progress", mat,
              *_tail_args(torch, g, p, m, dtype, i_star, f_lin=77.5))
    check(int(out[4]) == 4, f"step_tail {lab}: no_progress did not count a stall")
    margin = 0.01 if dtype == torch.float32 else 0.04  # bf16 rounds the scale by up to 0.4%
    for side, f in (("under", 1 - margin), ("over", 1 + margin)):
        beta, args = _tail_args(torch, g, p, m, dtype, i_star)
        scale = cfg.renorm_threshold / (1.0 - _tail_lam(torch, args)) * f
        args = (torch.tensor(scale, device=g.device).to(dtype),) + args[1:]
        out = run(f"the scale {100 * margin:g}% {side} the renorm threshold after the step",
                  mat, beta, args)
        check((float(out[1]) == 1.0) == (side == "under"), f"step_tail {lab}: renorm {side}")
    run("NaN score", mat, *_tail_args(torch, g, p, m, dtype, i_star, g_star=float("nan")))
    beta, args = _tail_args(torch, g, p, m, dtype, i_star)
    out = run("the same coordinate twice, step 1", mat, beta, args)
    b, scale, maxabs, _, stall, resid, s_quad, f_lin = out
    run("the same coordinate twice, step 2", mat, b,
        (scale, maxabs, stall, resid, s_quad, f_lin) + args[6:])
    return max(errs)


def _tail_ell(torch, g, p, m, nnz_max, dtype, winner, winner_rows, block_size=128):
    """Block-ELL (values, rows) of p features: 0 to min(nnz_max, m) stored
    slots a feature at distinct rows, then padding (value 0 at row 0); the
    winner's stored slots are at ``winner_rows`` (row 0 among them)."""
    dev = g.device
    pp = -(-p // block_size) * block_size
    count = torch.randint(0, min(nnz_max, m) + 1, (pp, 1), generator=g, device=dev)
    stored = torch.arange(nnz_max, device=dev)[None, :] < count
    stored[p:] = False
    perm = torch.rand((pp, m), generator=g, device=dev).argsort(dim=1)[:, :nnz_max]
    rows = torch.zeros((pp, nnz_max), dtype=torch.int32, device=dev)
    rows[:, :perm.shape[1]] = perm.int()
    rows *= stored
    vals = torch.randn((pp, nnz_max), generator=g, device=dev) * stored
    k = len(winner_rows)
    vals[winner] = 0.0
    rows[winner] = 0
    vals[winner, :k] = torch.randn(k, generator=g, device=dev)
    rows[winner, :k] = torch.tensor(winner_rows, dtype=torch.int32, device=dev)
    shape = (pp // block_size, block_size, nnz_max)
    return vals.to(dtype).view(shape), rows.view(shape)


def _fused_kw(max_iters, refresh_every=64):
    from repro_torch.core import LASSO

    return dict(oracle=LASSO, eps_den=1e-12, gap_rtol=1e-6, refresh_every=refresh_every,
                max_iters=max_iters)


def _is_sparse(mat):
    from repro_torch.sparse import SparseBlockMatrix

    return isinstance(mat, SparseBlockMatrix)


def _scores(torch, mat, idx, r):
    """The plain scores -z_i . r of features ``idx`` of a dense ``Xt`` or a
    ``SparseBlockMatrix``: the near-tie checks' yardstick."""
    if _is_sparse(mat):
        from repro_torch.kernels.sparse_grad import sparse_sampled_scores_plain

        return sparse_sampled_scores_plain(mat.values, mat.rows, r, idx, 1)
    return -(mat.index_select(0, idx) @ r)


def _check_chunk(torch, fs, label, mat, y, resid, idx, k0, delta, kw, plain_mat=None):
    """A fused chunk (K4 on a dense ``Xt``, K7 on a ``SparseBlockMatrix``) vs
    its plain version from the same chunk start: two launches give the same
    bits; i_star and no_progress equal up to the first step whose plain
    scores' top-2 are a near-tie (RTOL_SUM of ||z|| * ||r||); up to there
    lam and delta_t within RTOL_SUM (lam lies in [0, 1], |delta_t| =
    delta), and when no step differs the residual within RTOL_SUM of ||y||
    and (S, F) within RTOL_SUM of |S| + |F| + ||y||^2. ``plain_mat``
    (sparse): ``mat`` with padding features appended, on which the plain
    version and the column statistics run, so that ids past ``mat``'s
    features (which the kernel scores 0 without a read) have slots there.
    Returns the largest abs error and the kernel's i_star."""
    zero = torch.zeros((), device=y.device)
    scal = (zero, zero, zero)  # a cold start: R = y, S = F = 0
    ref = mat if plain_mat is None else plain_mat
    if _is_sparse(mat):
        from repro_torch.kernels.sparse_colstats import sparse_colstats_plain

        name, head, plain_head = ("sparse_fused_chunk", (mat.values, mat.rows),
                                  (ref.values, ref.rows))
        kernel, plain = fs.sparse_fused_chunk, fs.sparse_fused_chunk_plain
        zty, zn2 = sparse_colstats_plain(ref.values, ref.rows, y, ref.p)
    else:
        name, head, plain_head = "dense_fused_chunk", (mat,), (mat,)
        kernel, plain = fs.dense_fused_chunk, fs.dense_fused_chunk_plain
        zty, zn2 = mat @ y, (mat * mat).sum(dim=1)
    tail = (y, resid, scal, idx, zty[idx], zn2[idx], k0, delta)
    got = kernel(*head, *tail, **kw)
    again = kernel(*head, *tail, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got[:5] + got[5], again[:5] + again[5])),
          f"{name} {label}: two launches differ")
    want = plain(*plain_head, *tail, **kw)
    i_k, i_p = got[0].cpu(), want[0].cpu()
    diff = (i_k != i_p).nonzero().view(-1)
    t = int(diff[0]) if diff.numel() else idx.shape[0]
    if t < idx.shape[0]:  # the plain residual before step t, then its scores there
        r_t = plain(*plain_head, y, resid, scal, idx[:t], zty[idx[:t]], zn2[idx[:t]], k0, delta,
                    **kw)[4] if t else resid
        mags = _scores(torch, ref, idx[t], r_t).abs()
        scale = float(torch.linalg.vector_norm(r_t)) * float(zn2.max().sqrt())
        margin = _top2_margin(torch, mags, idx[t])
        check(margin <= RTOL_SUM * scale, f"{name} {label}: i_star {int(i_k[t])} != "
              f"plain {int(i_p[t])} at step {t}, top-2 margin {margin:.3e}: no near-tie")
    check(torch.equal(got[3][:t].cpu(), want[3][:t].cpu()), f"{name} {label}: no_progress")
    e_lam = float((got[1][:t] - want[1][:t]).abs().max()) if t else 0.0
    e_dt = float((got[2][:t] - want[2][:t]).abs().max()) if t else 0.0
    check(e_lam <= RTOL_SUM and e_dt <= RTOL_SUM * float(delta),
          f"{name} {label}: lam err {e_lam:.2e}, delta_t err {e_dt:.2e}")
    errs = [e_lam, e_dt]
    note = f"step {t} differs at a near-tie" if t < idx.shape[0] else "all steps equal"
    if t == idx.shape[0]:
        e_r, a_r = _scaled_err(torch, got[4], want[4], float(torch.linalg.vector_norm(y)))
        sf_scale = (abs(float(want[5][0])) + abs(float(want[5][1]))
                    + float(torch.dot(y, y)))
        e_sf = max(abs(float(a) - float(b)) for a, b in zip(got[5], want[5]))
        check(e_r <= RTOL_SUM and e_sf <= RTOL_SUM * sf_scale,
              f"{name} {label}: residual err {e_r:.2e}, S/F err {e_sf:.3e}")
        errs += [a_r, e_sf]
        note += f", residual err {e_r:.2e} of ||y||, S/F err {e_sf / sf_scale:.2e} of scale"
    i_list = i_k.tolist()
    shown = i_list if len(i_list) <= 8 else i_list[:8] + ["..."]
    print(f"[kernels] {name} {label}: i_star {shown}, {note}, lam err {e_lam:.2e}, "
          f"delta_t err {e_dt:.2e}, two launches bitwise equal")
    return max(errs), i_k


def _check_replay(torch, fs, label, beta0, start, recs, k0, cfg):
    """The replay against its plain version, bit for bit (beta and the
    statistics). Returns the kernel's outputs."""
    out_k = fs.fused_replay(beta0.clone(), *start, *recs, k0, cfg)
    out_p = fs.fused_replay_plain(beta0.clone(), *start, *recs, k0, cfg)
    same = torch.equal(out_k[0], out_p[0]) and all(
        torch.equal(a.reshape(()), b.reshape(())) for a, b in zip(out_k[1:], out_p[1:]))
    print(f"[kernels] fused_replay p={beta0.numel()} {label}: scale {float(out_k[1])!r} "
          f"(plain {float(out_p[1])!r}), stall {int(out_k[4])}, bit-exact: {same}")
    check(same, f"fused_replay {label} disagrees with its plain version")
    return out_k


def replay_edge_cases(torch, fs, g):
    """The replay bit for bit against its plain version where its walk has
    edges: a coordinate that wins 3 times in one chunk (forwarded in
    registers); a renorm at the first and at the last record, with a
    coordinate winning on both sides of each; a masked tail (k0 near
    max_iters); 40 records (two batches of 32), a coordinate repeated
    across them and a renorm in the second."""
    from repro_torch.core import FWConfig

    dev = g.device
    cfg = FWConfig(delta=50.0, max_iters=1000)
    p = 100_000
    beta0 = torch.randn(p, generator=g, device=dev)
    start1 = (torch.tensor(1.0, device=dev), torch.tensor(0.4, device=dev),
              torch.tensor(0.1, device=dev), torch.tensor(2, dtype=torch.int32, device=dev))
    start_low = (torch.tensor(3e-6, device=dev),) + start1[1:]

    def records(K, lo=0.05, hi=0.4):
        i_stars = torch.randint(0, p, (K,), generator=g, device=dev)
        lams = lo + (hi - lo) * torch.rand(K, generator=g, device=dev)
        dts = torch.where(torch.rand(K, generator=g, device=dev) < 0.5, -50.0, 50.0)
        nps = torch.rand(K, generator=g, device=dev) < 0.3
        return i_stars, lams, dts, nps

    i_stars, lams, dts, nps = records(FUSE)
    i_stars[4] = i_stars[6] = i_stars[1]
    _check_replay(torch, fs, "K=8, one coordinate wins 3 times", beta0, start1,
                  (i_stars, lams, dts, nps), 0, cfg)
    i_stars, lams, dts, nps = records(FUSE, 0.05, 0.15)
    i_stars[3] = i_stars[7] = i_stars[0]
    lams[0] = 0.75  # 3e-6 * 0.25 < renorm_threshold: a renorm at the first record
    lams[7] = 0.9999999  # and, from a scale near 0.5, at the last
    out = _check_replay(torch, fs, "K=8, renorm at the first and the last record", beta0,
                        start_low, (i_stars, lams, dts, nps), 0, cfg)
    check(float(out[1]) == 1.0, "fused_replay: no renorm at the last record")
    out = _check_replay(torch, fs, "K=8, the same records, the last 3 masked", beta0, start_low,
                        (i_stars, lams, dts, nps), cfg.max_iters - 5, cfg)
    check(float(out[1]) != 1.0, "fused_replay: a masked record renormalized")
    i_stars, lams, dts, nps = records(40, 0.01, 0.1)
    i_stars[35] = i_stars[39] = i_stars[3]
    lams[36] = 0.9999995
    _check_replay(torch, fs, "K=40 (two batches), repeats across them, a renorm in the second",
                  beta0, start1, (i_stars, lams, dts, nps), 0, cfg)


def phase2_fused(torch, Xt_main, y_main):
    """K4 and the replay against their plain versions on the card."""
    from repro_torch.core import FWConfig
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import fused_step as fs

    dev = Xt_main.device
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    p, m = Xt_main.shape
    kappa = kappa_fraction(p, 0.01)
    delta = torch.tensor(50.0, device=dev)
    blocks = fs._blocks("dense", dev, m)
    print(f"[kernels] dense_fused_chunk: cooperative grid of {blocks} blocks x "
          f"512 threads at m={m}")

    # ---- K4 at the main shapes: K = 8, kappa = 1% of p, m = 800 ------------
    idx = TorchSampler(13, dev).uniform_chunk(FUSE, kappa, p)
    err, _ = _check_chunk(torch, fs, f"main K={FUSE} kappa={kappa} m={m}", Xt_main, y_main,
                          y_main, idx, 0, delta, _fused_kw(10**6))
    # a refresh (k = 63) and max_iters (66) inside the chunk
    _check_chunk(torch, fs, "main k0=60 refresh at s=3 max_iters=66", Xt_main, y_main,
                 y_main, idx, 60, delta, _fused_kw(66))

    # ---- ragged: m = 803, kappa not a multiple of the blocks' share,
    # duplicate draws, a three-way exact tie, masking and refresh inside ----
    p_r, m_r = 1000, 803
    X = torch.randn((p_r, m_r), generator=g, device=dev)
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    X[17] = X[5]
    X[900] = X[5]
    # rows 5, 17, 900 are equal, so they tie exactly, and lead the first step's
    # |scores|; the noise keeps the residual from vanishing within the chunk
    noise = torch.randn(m_r, generator=g, device=dev)
    yv = X[5] * 3.0 + 0.3 * noise / torch.linalg.vector_norm(noise)
    idx_r = torch.randint(0, p_r, (FUSE, 301), generator=g, device=dev)
    idx_r[0, :8] = torch.tensor([3, 17, 998, 5, 17, 42, 900, 5], device=dev)
    _, i_k = _check_chunk(torch, fs, f"p={p_r} m={m_r} kappa=301 tie+duplicates", X, yv,
                          yv, idx_r, 0, delta, _fused_kw(10**6))
    check(int(i_k[0]) == 17, f"fused chunk tie went to {int(i_k[0])}, first in order is 17")
    _check_chunk(torch, fs, f"p={p_r} m={m_r} kappa=301 k0=5 refresh_every=4 max_iters=11",
                 X, yv, yv, idx_r, 5, delta, _fused_kw(11, refresh_every=4))
    idx_big = torch.randint(0, p_r, (3, 5003), generator=g, device=dev)
    _check_chunk(torch, fs, f"p={p_r} m={m_r} K=3 kappa=5003", X, yv, yv, idx_big, 0, delta,
                 _fused_kw(10**6))

    # ---- the replay, bit for bit, a renorm inside the chunk ----------------
    cfg = FWConfig(delta=50.0, max_iters=1000)
    beta0 = torch.randn(p, generator=g, device=dev)
    i_stars = torch.randint(0, p, (FUSE,), generator=g, device=dev)
    i_stars[3] = i_stars[1]  # a coordinate hit twice
    lams = torch.rand(FUSE, generator=g, device=dev) * 0.5
    lams[4] = 0.75  # 3e-6 * prod(1 - lam) falls below renorm_threshold by here
    dts = torch.where(torch.rand(FUSE, generator=g, device=dev) < 0.5, -50.0, 50.0)
    nps = torch.rand(FUSE, generator=g, device=dev) < 0.3
    start = (torch.tensor(3e-6, device=dev), torch.tensor(0.4, device=dev),
             torch.tensor(0.1, device=dev), torch.tensor(2, dtype=torch.int32, device=dev))
    for k0, label in ((0, "K=8"), (cfg.max_iters - 6, "K=8, the last 2 records masked")):
        out_k = _check_replay(torch, fs, label, beta0, start, (i_stars, lams, dts, nps), k0,
                              cfg)
        # without a renorm the scale could only shrink from 3e-6
        check(float(out_k[1]) > 3e-6, "fused_replay: no renorm happened in the chunk")
    replay_edge_cases(torch, fs, g)
    torch.cuda.synchronize()
    return {"dense_fused_chunk": err, "fused_replay": 0.0}


def bf16_solves(torch, dev, backend):
    """F1: the golden's problem stored in bf16 solves on the card through
    ``backend`` ('kernels' on the dense design, 'sparse' on its block-ELL
    copy), one step per dispatch and with fuse_steps = 8 (K unfused steps:
    K4/K7 run f32 only), to the reference's bars (a finite objective,
    ||alpha||_1 <= delta * (1 + 5e-2)) and with its true objective, 0.5
    ||y - X alpha||^2 in float64, within 1e-2 of the f32 golden's; a tail
    launch a step and no chunk launch."""
    import numpy as np

    from repro_torch import convert, kernels
    from repro_torch.core import FWConfig, fw_solve
    from repro_torch.data import make_regression, standardize
    from repro_torch.sparse import SparseBlockMatrix

    ds = standardize(make_regression(m=80, p=300, n_informative=10, noise=0.5, seed=0))
    X, yv = convert.problem_from_numpy(ds.X.T, ds.y, dev)
    design = (X.to(torch.bfloat16) if backend == "kernels"
              else SparseBlockMatrix.from_dense(ds.X.T, block_size=64).to(dev).astype(
                  torch.bfloat16))
    X64, y64 = ds.X.T.astype(np.float64), ds.y.astype(np.float64)
    for fuse in (1, FUSE):
        cfg = FWConfig(delta=150.0, kappa=60, max_iters=5000, tol=1e-4, backend=backend,
                       fuse_steps=fuse)
        stream = np.tile(golden_stream(), (200, 1))
        kernels.reset_launch_counts()
        res = fw_solve(design, yv.to(torch.bfloat16), cfg,
                       convert.stream_from_reference(stream, dev), device=dev)
        launches = kernels.launch_counts()
        alpha = res.alpha.float().cpu().numpy().astype(np.float64)
        r = y64 - alpha @ X64
        true_obj, l1 = 0.5 * float(r @ r), float(np.abs(alpha).sum())
        print(f"[bf16] {backend} fuse_steps={fuse}: iters={res.iterations} objective "
              f"{float(res.objective)!r} (bf16), true objective {true_obj!r} (f32 golden "
              f"{GOLDEN_OBJECTIVE!r}), l1 {l1:.6g} (delta 150), tail launches "
              f"{launches['step_tail']}")
        check(res.alpha.dtype == torch.bfloat16 and math.isfinite(float(res.objective)),
              f"bf16 {backend}: objective")
        check(l1 <= 150.0 * (1 + 5e-2), f"bf16 {backend}: l1 {l1} past delta * (1 + 5e-2)")
        check(abs(true_obj - GOLDEN_OBJECTIVE) <= 1e-2 * GOLDEN_OBJECTIVE,
              f"bf16 {backend}: true objective {true_obj}")
        check(launches["step_tail"] == res.iterations and launches["dense_fused_chunk"] ==
              launches["sparse_fused_chunk"] == launches["fused_replay"] == 0,
              f"bf16 {backend} fuse_steps={fuse}: launches {launches}")


def golden_stream():
    """The golden's (25, 60) index stream as a numpy array."""
    import base64

    import numpy as np

    return np.frombuffer(base64.b64decode("".join(GOLDEN_STREAM)), "<i2").reshape(25, 60)


def golden_check(torch, dev):
    """The 'kernels' backend on the card replays the reference's converging
    golden from the reference's own index stream: 25 iterations, 1500
    dots, the same 25 vertices, the objective at the goldens' rtol 1e-6."""
    from repro_torch import convert
    from repro_torch.core import FWConfig, fw_solve
    from repro_torch.data import make_regression, standardize

    ds = standardize(make_regression(m=80, p=300, n_informative=10, noise=0.5, seed=0))
    X, yv = convert.problem_from_numpy(ds.X.T, ds.y, dev)
    cfg = FWConfig(delta=150.0, kappa=60, max_iters=5000, tol=1e-4, backend="kernels")
    seq = []
    res = fw_solve(X, yv, cfg, convert.stream_from_reference(golden_stream(), dev),
                   device=dev, on_step=lambda s: seq.append(int(s.i_star)))
    obj = float(res.objective)
    print(f"[golden] small_problem on the card: iters={res.iterations} n_dots={res.n_dots} "
          f"converged={bool(res.converged)} objective={obj!r} (reference "
          f"{GOLDEN_OBJECTIVE!r}), vertex sequence equal: {seq == GOLDEN_I_STAR}")
    check((res.iterations, res.n_dots, bool(res.converged)) == (25, 1500, True),
          "golden: iterations / dots / convergence")
    check(seq == GOLDEN_I_STAR, f"golden: vertex sequence {seq}")
    check(abs(obj - GOLDEN_OBJECTIVE) <= 1e-6 * GOLDEN_OBJECTIVE, "golden: objective")


# --------------------------------------------------------------------------
# phases 3 and 4
# --------------------------------------------------------------------------


class Recorder:
    """``fw_path`` step hook keeping, for the first grid points, each
    step's vertex and residual (device tensors: no sync)."""

    def __init__(self, n_points):
        self.n_points = n_points
        self.i_star = [[] for _ in range(n_points)]
        self.resid = [[] for _ in range(n_points)]

    def __call__(self, g, state):
        if g < self.n_points:
            self.i_star[g].append(state.i_star)
            self.resid[g].append(state.co.resid)

    def sequence(self, g):
        import torch

        if not self.i_star[g]:
            return torch.zeros(0, dtype=torch.int64)
        # a fused chunk's state holds the chunk's vertices
        return torch.cat([t.view(-1) for t in self.i_star[g]]).cpu()


def main_config(p, backend, fuse_steps=1):
    from repro_torch.core import FWConfig
    from repro_torch.core.sampling import kappa_fraction

    # the example's paper-size path: kappa = 1% of p, 5000 iterations, tol 1e-3
    return FWConfig(delta=1.0, kappa=kappa_fraction(p, 0.01), sampling="uniform",
                    max_iters=5000, tol=1e-3, backend=backend, fuse_steps=fuse_steps)


def phase3_main_path(torch, Xt, y, coef):
    from repro_torch import kernels
    from repro_torch.core import LASSO, delta_grid, fw_path

    p, m = Xt.shape
    cfg = main_config(p, "kernels")
    delta_max = 0.5 * float(coef.abs().sum())
    deltas = delta_grid(delta_max, n_points=N_POINTS)
    rec = Recorder(N_COMPARE)
    print(f"[main] fw_path backend=kernels p={p:,} m={m} kappa={cfg.kappa:,} "
          f"sampling=uniform max_iters={cfg.max_iters} tol={cfg.tol} "
          f"points={N_POINTS} delta_max={delta_max:.6g}")
    kernels.reset_launch_counts()
    res = fw_path(Xt, y, deltas, cfg, seed=0, device=Xt.device, on_step=rec)
    launches = kernels.launch_counts()
    _print_points("main", res, cfg)
    print(f"[main] launches during the path: {launches}")
    check(launches["colstats"] == len(res.points), "colstats launches != points")
    for name in ("sampled_scores", "vertex_argmax", "step_tail"):
        check(launches[name] == res.total_iters, f"{name} launches != iterations")
    check(launches["residual_update"] == 0, "the unfused path launched K3 beside the tail")
    # telemetry off: no ring, so no TEL instantiation runs
    check(all(launches[n] == 0 for n in TEL_KERNELS), "telemetry off launched a TEL kernel")
    # the certified duality gap bounds the last point's suboptimality: it
    # must be finite and (up to rounding) non-negative
    last = res.points[-1]
    alpha = _alpha_from_point(torch, last, p, Xt.device)
    gap = float(LASSO.gap(Xt, y, alpha, torch.tensor(last.reg, device=Xt.device)))
    print(f"[main] certified duality gap at the last point: {gap!r} "
          f"(objective {last.objective!r})")
    check(math.isfinite(gap) and gap >= -1e-4 * abs(last.objective), "certified gap")
    return launches, dict(cfg=cfg, deltas=deltas, res=res, rec=rec)


def _alpha_from_point(torch, pt, p, device):
    alpha = torch.zeros(p, device=device)
    alpha[torch.as_tensor(pt.alpha_nnz_idx, device=device)] = torch.as_tensor(
        pt.alpha_nnz_val, device=device)
    return alpha


def phase3_fused_path(torch, Xt, y, main):
    """The main path again with fuse_steps = FUSE: every chunk through K4
    and the replay, K2 and K3 never launched."""
    from repro_torch import kernels
    from repro_torch.core import LASSO, fw_path

    p = Xt.shape[0]
    cfg = dataclasses.replace(main["cfg"], fuse_steps=FUSE)
    deltas = main["deltas"]
    rec = Recorder(N_COMPARE)
    print(f"[fused] fw_path backend=kernels fuse_steps={FUSE}, the main path's grid and "
          "sampler seeds")
    kernels.reset_launch_counts()
    res = fw_path(Xt, y, deltas, cfg, seed=0, device=Xt.device, on_step=rec)
    launches = kernels.launch_counts()
    _print_points("fused", res, cfg)
    unfused = main["res"]
    print(f"[fused] one step per dispatch: {unfused.total_seconds:.3f} s, "
          f"{1e3 * unfused.total_seconds / max(unfused.total_iters, 1):.4f} ms/iteration, "
          f"{unfused.total_iters} iterations")
    print(f"[fused] launches during the path: {launches}")
    chunks = sum(-(-pt.iterations // FUSE) for pt in res.points)
    check(launches["dense_fused_chunk"] == chunks == launches["fused_replay"],
          f"fused launches {launches['dense_fused_chunk']}/{launches['fused_replay']} != "
          f"chunks {chunks}")
    check(launches["colstats"] == len(res.points), "fused path: colstats launches != points")
    for name in ("sampled_scores", "vertex_argmax", "residual_update", "step_tail"):
        check(launches[name] == 0, f"fused path launched {name}")
    last = res.points[-1]
    alpha = _alpha_from_point(torch, last, p, Xt.device)
    gap = float(LASSO.gap(Xt, y, alpha, torch.tensor(last.reg, device=Xt.device)))
    print(f"[fused] certified duality gap at the last point: {gap!r} "
          f"(objective {last.objective!r})")
    check(math.isfinite(gap) and gap >= -1e-4 * abs(last.objective), "fused certified gap")
    return launches, dict(cfg=cfg, res=res, rec=rec)


def phase3_full_point(torch, Xt, y, main):
    """One grid point with 'full' sampling (deterministic FW: every
    coordinate scored each step, blocks of 128), a fixed N_FULL_STEPS
    steps: K2's scores and argmax once a step at n = p. Its vertices
    against the 'torch' backend's, the same up to a near-tie."""
    from repro_torch import kernels
    from repro_torch.core import fw_solve
    from repro_torch.core.vertex import TorchSampler

    p = Xt.shape[0]
    delta = float(main["deltas"][N_POINTS // 2])
    runs = {}
    for backend in ("kernels", "torch"):
        cfg = dataclasses.replace(main["cfg"], backend=backend, sampling="full",
                                  max_iters=N_FULL_STEPS, tol=0.0, patience=10**9)
        seq, resid = [], []

        def hook(state):
            seq.append(state.i_star)
            resid.append(state.co.resid)

        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fw_solve(Xt, y, cfg, TorchSampler(0, Xt.device), delta=delta, device=Xt.device,
                       on_step=hook)
        obj = float(res.objective)
        dt = time.perf_counter() - t0
        launches = kernels.launch_counts()
        print(f"[full] delta={delta:.6g} backend={backend} sampling=full blocks of "
              f"{cfg.block_size}: iters={res.iterations} n_dots={res.n_dots} objective={obj!r} "
              f"{dt:.3f} s ({1e3 * dt / res.iterations:.4f} ms/iteration); launches {launches}")
        check(math.isfinite(obj) and res.iterations == N_FULL_STEPS, f"full point {backend}")
        check(res.n_dots == N_FULL_STEPS * p, f"full point {backend}: n_dots")
        if backend == "kernels":
            check(launches["sampled_scores"] == launches["vertex_argmax"] == N_FULL_STEPS
                  == launches["step_tail"], "full point: K2 / tail launches != steps")
            check(launches["residual_update"] == 0, "full point: K3 launched")
        runs[backend] = (torch.stack(seq).cpu(), resid, obj)
    (sk, _, ok), (st, rt, ot) = runs["kernels"], runs["torch"]
    diff = (sk != st).nonzero().view(-1)
    if diff.numel():
        t = int(diff[0])
        r_pre = rt[t - 1] if t > 0 else y
        top = torch.topk((Xt @ r_pre).abs(), 2).values
        margin = float(top[0] - top[1])
        rnorm = float(torch.linalg.vector_norm(r_pre))
        check(margin <= RTOL_TIE * rnorm, f"full point step {t}: vertex {int(sk[t])} (kernels) "
              f"vs {int(st[t])} (torch), top-2 margin {margin / rnorm:.2e} ||r||: no near-tie")
        print(f"[full] the same vertices for {t} steps, then a near-tie (margin "
              f"{margin / rnorm:.2e} ||r||)")
    else:
        rel = abs(ok - ot) / abs(ot)
        print(f"[full] identical vertex sequences ({N_FULL_STEPS} steps), objectives "
              f"{ok!r}/{ot!r}, rel diff {rel:.2e} (rtol {RTOL_OBJ_SAME:g})")
        check(rel <= RTOL_OBJ_SAME, "full point: objectives differ")


def _compare_paths(torch, Xt, y, deltas, kappa, a, b, max_overshoot, obj_scale=0.0):
    """Run ``a`` against run ``b`` (which recorded every step's residual)
    on ``Xt`` (dense, or a ``SparseBlockMatrix``)
    over their first points, from the same sampler seeds: vertex sequences
    equal up to the first difference, which must be a near-tie on b's
    residual; a stop of ``a`` at most ``max_overshoot`` steps after ``b``'s
    while the runs agree; objectives within RTOL_OBJ_SAME while they agree,
    and after, within RTOL_OBJ_APART or within the larger of the two
    points' certified duality gaps. The objectives' differences are
    relative to the larger of b's objective and ``obj_scale``."""
    from repro_torch.core import LASSO
    from repro_torch.core.path import point_seed
    from repro_torch.core.vertex import TorchSampler, matvec

    p = Xt.shape[0]
    la, lb = a["label"], b["label"]
    print(f"[compare] {la} vs {lb}: first {a['rec'].n_points} points, same sampler seeds; "
          f"near-tie: top-2 |scores| within {RTOL_TIE:g} * ||r||; objectives within "
          f"{RTOL_OBJ_SAME:g} while the runs agree, {RTOL_OBJ_APART:g} after")
    apart = False
    for g in range(a["rec"].n_points):
        pa, pb = a["res"].points[g], b["res"].points[g]
        sa, sb = a["rec"].sequence(g), b["rec"].sequence(g)
        note = "runs already apart"
        if not apart:
            common = min(len(sa), len(sb))
            diff = (sa[:common] != sb[:common]).nonzero().view(-1)
            if diff.numel():
                t = int(diff[0])
                if t > 0:
                    r_pre = b["rec"].resid[g][t - 1]
                elif g == 0:
                    r_pre = y
                else:  # the warm start of point g on run b
                    prev = b["res"].points[g - 1]
                    a0 = _alpha_from_point(torch, prev, p, Xt.device) * (float(deltas[g]) / prev.l1)
                    r_pre = y - matvec(Xt, a0)
                sampler = TorchSampler(point_seed(0, g), Xt.device)
                for _ in range(t + 1):
                    idx = sampler.uniform(kappa, p)
                mags = _scores(torch, Xt, idx, r_pre).abs()
                margin = _top2_margin(torch, mags, idx)
                rnorm = float(torch.linalg.vector_norm(r_pre))
                check(margin <= RTOL_TIE * rnorm,
                      f"point {g} step {t}: vertex {int(sa[t])} ({la}) vs {int(sb[t])} "
                      f"({lb}) with top-2 margin {margin:.3e} = {margin / rnorm:.2e} ||r||: "
                      "no near-tie")
                note = (f"same vertices for {t} steps, then a near-tie (margin "
                        f"{margin / rnorm:.2e} ||r||)")
                apart = True
            elif len(sa) != len(sb):
                over = len(sa) - len(sb)
                if max_overshoot:
                    check(0 <= over <= max_overshoot,
                          f"point {g}: {la} stopped {over} steps after {lb}, the same "
                          f"trajectory (at most {max_overshoot})")
                note = (f"same vertices for {common} steps, {la} stopped {over} steps "
                        f"after {lb}")
                apart = True
            else:
                note = f"identical vertex sequence ({common} steps)"
        rtol = RTOL_OBJ_APART if apart else RTOL_OBJ_SAME
        rel = abs(pa.objective - pb.objective) / max(abs(pb.objective), obj_scale)
        print(f"[compare] point {g} iters {pa.iterations}/{pb.iterations} objective "
              f"{pa.objective!r}/{pb.objective!r} rel diff {rel:.2e} (rtol {rtol:g}): {note}")
        if apart and rel > rtol:
            # two different runs, each stopped by the stall rule: each one's
            # certified duality gap bounds its distance to the optimum, so
            # the two objectives lie within the larger gap of each other
            d = torch.tensor(float(deltas[g]), device=Xt.device)
            gaps = [float(LASSO.gap(Xt, y, _alpha_from_point(torch, pt, p, Xt.device), d))
                    for pt in (pa, pb)]
            diff_f = abs(pa.objective - pb.objective)
            print(f"[compare] point {g}: |objective diff| {diff_f:.6g} against the certified "
                  f"gaps {gaps[0]:.6g} ({la}) and {gaps[1]:.6g} ({lb})")
            check(diff_f <= max(gaps), f"point {g}: objectives differ by {diff_f:.6g}, more "
                  "than either run's certified gap")
        else:
            check(rel <= rtol, f"point {g}: objectives differ by {rel:.2e}")


def phase4_other_backend(torch, Xt, y, main):
    from repro_torch.core import fw_path

    n = main["rec"].n_points
    deltas = main["deltas"][:n]
    cfg = dataclasses.replace(main["cfg"], backend="torch")
    rec_t = Recorder(n)
    res_t = fw_path(Xt, y, deltas, cfg, seed=0, device=Xt.device, on_step=rec_t)
    _compare_paths(torch, Xt, y, deltas, cfg.kappa,
                   dict(label="kernels", res=main["res"], rec=main["rec"]),
                   dict(label="torch", res=res_t, rec=rec_t), max_overshoot=0)


def phase4_fused_vs_unfused(torch, Xt, y, main, fused):
    """The fused path's first points against the unfused 'kernels' path's.
    Both score through the same per-row dot; the refresh's dot products are
    summed in another order (the kernel's fixed order, cuBLAS), so the runs
    agree to rounding."""
    _compare_paths(torch, Xt, y, main["deltas"], main["cfg"].kappa,
                   dict(label=f"fused K={FUSE}", res=fused["res"], rec=fused["rec"]),
                   dict(label="unfused", res=main["res"], rec=main["rec"]),
                   max_overshoot=FUSE - 1)


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------


def _time_queued(torch, fn, reps):
    """Device ms per call: the calls are enqueued behind a spin kernel, so
    the events time the calls back to back, not the host's launch rate
    (reps * launches per call stays under the ~1000-entry launch queue)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _time_cold(torch, fn, reps, flush):
    """Device ms per call, the L2 cache flushed before each."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vertex_argmax_times(torch, fw, scores, blk, bs, p, reps=400, plain_reps=40):
    """Device ms of ``fw.vertex_argmax`` and its plain version on these
    inputs, queued back to back, and the bytes and operations its bound
    counts: every score and sampled block id read once, 12 bytes out."""
    n = scores.numel()
    return dict(
        ms=_time_queued(torch, lambda i: fw.vertex_argmax(scores, blk, bs, p), reps),
        plain_ms=_time_queued(torch, lambda i: fw.argmax_plain(scores, blk, bs, p), plain_reps),
        nbytes=n * 4 + blk.numel() * 8 + 12, flops=3 * n)


def sparse_colstats_times(torch, sc, mat, y, flush, reps=5):
    """K6 (``sc.sparse_colstats``) over the whole block-ELL matrix with the
    L2 flushed before each launch: its device ms, its plain version's,
    cuSPARSE's CSR SpMV on a copy (zty alone; None if the copy fails), and
    the bytes and operations its bound counts: every value slot of the p
    features (the padding is found only by reading it), a row only for a
    stored nonzero, y once, two floats out a feature."""
    p, m, nnz = mat.p, mat.m, mat.nnz_max
    vals, rows = mat.values, mat.rows
    nz = int(torch.count_nonzero(vals.view(-1, nnz)[:p]))
    csr = None
    try:
        mask = vals.view(-1, nnz)[:p] != 0
        crow = torch.zeros(p + 1, dtype=torch.int64, device=vals.device)
        crow[1:] = torch.cumsum(mask.sum(dim=1), 0)
        csr = torch.sparse_csr_tensor(crow, rows.view(-1, nnz)[:p][mask].long(),
                                      vals.view(-1, nnz)[:p][mask], size=(p, m),
                                      check_invariants=False)
        del mask
        lib_ms = _time_cold(torch, lambda: torch.mv(csr, y), reps, flush)
        note = " [library: torch.mv on a CSR copy of Xt (cuSPARSE SpMV), zty alone]"
    except (RuntimeError, NotImplementedError) as e:  # the yardstick only
        lib_ms, note = None, f" [library: none, the CSR copy failed: {e}]"
    del csr
    return dict(
        ms=_time_cold(torch, lambda: sc.sparse_colstats(vals, rows, y, p), reps, flush),
        plain_ms=_time_cold(torch, lambda: sc.sparse_colstats_plain(vals, rows, y, p), 3,
                            flush),
        library_ms=lib_ms, nbytes=p * nnz * vals.element_size() + nz * 4 + 2 * p * 4 + m * 4,
        flops=4 * nz, nz=nz, note=note + f" L2 flushed, {nz:,} stored nonzeros")


def k5_digest_inputs(torch, mat):
    """K5's inputs for the bitwise check against the warp-per-feature K5's
    scores (``K5_SHA256``): kappa = 1%
    of p features drawn as phase 2 draws them (width 1), and 166 blocks of
    256 from a fixed permutation (width 256)."""
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.core.vertex import TorchSampler

    kappa = kappa_fraction(mat.p, 0.01)
    g = torch.Generator(device=mat.device)
    g.manual_seed(17)
    blk = torch.randperm(mat.nblocks, generator=g, device=mat.device)[:kappa // SPARSE_BLOCK]
    return {1: TorchSampler(7, mat.device).uniform(kappa, mat.p), SPARSE_BLOCK: blk}


def k5_digests(torch, sg, mat, y):
    """sha256 of K5's f32 score bytes at each width of ``k5_digest_inputs``."""
    import hashlib

    return {bs: hashlib.sha256(sg.sparse_sampled_scores(mat.values, mat.rows, y, ids, bs)
                               .cpu().numpy().tobytes()).hexdigest()
            for bs, ids in k5_digest_inputs(torch, mat).items()}


def unfused_step_wall_ms(torch, X, y, stats, cfg, delta, n_steps=300):
    """Host-clock ms per iteration of a fixed run of ``n_steps`` steps
    (``cfg`` with tol 0, so no stop), after a warm-up run, from the cold
    start; both runs end in a device sync."""
    from repro_torch.core import engine, fw_lasso
    from repro_torch.core.vertex import TorchSampler

    cfg = dataclasses.replace(cfg, max_iters=n_steps, tol=0.0, patience=10**9)
    for seed in (3, 5):  # a warm-up, then the timed run
        state0 = engine.init_state(fw_lasso.LASSO, X, y, None, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_loop(fw_lasso.LASSO, X, y, stats, state0, cfg, delta, 10**9,
                        TorchSampler(seed, X.device))
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps


def phase5_timing(torch, Xt, y):
    from repro_torch.core import engine, fw_lasso
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import colstats as cs
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import residual_update as ru

    p, m = Xt.shape
    cfg = main_config(p, "kernels")
    kappa = cfg.kappa
    dev = Xt.device
    out = {}
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2

    def row(name, ms, plain_ms, library_ms, nbytes, flops, note=""):
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        lib = "null" if library_ms is None else f"{library_ms:.6f} ms"
        print(f"[timing] {name}: {ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.6f} ms, "
              f"library {lib}{note}")

    nb1 = p * m * 4 + m * 4 + 2 * p * 4
    row("colstats",
        _time_cold(torch, lambda: cs.colstats(Xt, y), 5, flush),
        _time_cold(torch, lambda: cs.colstats_plain(Xt, y), 5, flush),
        _time_cold(torch, lambda: torch.mv(Xt, y), 5, flush),
        nb1, 4 * p * m, note=" [library: torch.mv for zty alone; L2 flushed]")

    sampler = TorchSampler(11, dev)
    idxs = [sampler.uniform(kappa, p) for _ in range(32)]  # 32 * 137 MB of rows >> L2
    r = y.clone()
    row("sampled_scores",
        _time_queued(torch, lambda i: fw.sampled_scores(Xt, r, idxs[i % 32], 1), 200),
        _time_queued(torch, lambda i: fw.sampled_scores_plain(Xt, r, idxs[i % 32], 1), 50),
        _time_queued(torch, lambda i: torch.mv(Xt.index_select(0, idxs[i % 32]), r), 50),
        kappa * m * 4 + m * 4 + kappa * 8 + kappa * 4, 2 * kappa * m,
        note=f" [kappa={kappa}, m={m}; library: torch.mv on Xt.index_select]")

    scores = fw.sampled_scores(Xt, r, idxs[0], 1)
    t = vertex_argmax_times(torch, fw, scores, idxs[0], 1, p)
    row("vertex_argmax", t["ms"], t["plain_ms"], None, t["nbytes"], t["flops"],
        note=f" [n = kappa = {kappa}, width 1; library: none]")
    blk = torch.arange(-(-p // 128), device=dev)  # 'full' sampling: every block of 128
    scores = fw.sampled_scores(Xt, r, blk, 128)
    t = vertex_argmax_times(torch, fw, scores, blk, 128, p, reps=200)
    b_ms, b_by = _bound(t["nbytes"], t["flops"])
    print(f"[timing] vertex_argmax at n = {scores.numel()} ('full' sampling, {blk.numel()} blocks "
          f"of 128): {t['ms']:.6f} ms, bound {b_ms:.6f} ms ({b_by}, {100 * b_ms / t['ms']:.1f}% "
          f"of bound), plain {t['plain_ms']:.6f} ms")
    del scores

    z = Xt[0].clone()
    lam = torch.tensor(0.25, device=dev)
    dt = torch.tensor(-3.0, device=dev)
    target = y - dt * z
    row("residual_update",
        _time_queued(torch, lambda i: ru.residual_update(r, y, z, lam, dt), 400),
        _time_queued(torch, lambda i: ru.residual_update_plain(r, y, z, lam, dt), 80),
        _time_queued(torch, lambda i: torch.lerp(r, target, lam), 400),
        4 * m * 4 + 8, 5 * m, note=f" [m={m}; library: torch.lerp toward y - dt*z]")

    # ---- the unfused step's tail at the main path's shapes ------------------
    from repro_torch.core import FWConfig
    from repro_torch.kernels import step_tail as st

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    tcfg = FWConfig(delta=5.0)
    beta_t, targs = _tail_args(torch, gen, p, m, torch.float32, int(idxs[0][0]))
    row("step_tail",
        _time_queued(torch, lambda i: st.step_tail(Xt, beta_t, *targs, tcfg), 400),
        # ~75 launches a call: 10 calls keep the queue under its ~1000 entries
        _time_queued(torch, lambda i: st.step_tail_plain(Xt, beta_t, *targs, tcfg), 10),
        None, 4 * m * 4 + 64, 5 * m,
        note=f" [dense, m={m}, no renorm; bytes: resid, y, the winner's row, the new resid, "
             "and the scalars; library: none, no one call runs the step's tail]")
    low = (torch.tensor(3e-7, device=dev),) + targs[1:]  # every step renormalizes
    t_renorm = _time_queued(torch, lambda i: st.step_tail(Xt, beta_t, *low, tcfg), 40)
    print(f"[timing] step_tail on a renorm step (beta *= scale over p={p:,}): {t_renorm:.6f} ms, "
          f"bound {_bound(4 * m * 4 + 64 + 2 * p * 4, 5 * m + p)[0]:.6f} ms")

    # ---- K4 and the replay at the main path's shapes ----------------------
    from repro_torch.kernels import fused_step as fs

    stats = engine.precompute_colstats(Xt, y, cfg)
    delta = torch.tensor(50.0, device=dev)
    chunks = []  # distinct index sets: a chunk reads 8 x 137 MB of rows, far beyond L2
    for _ in range(4):
        idx = sampler.uniform_chunk(FUSE, kappa, p)
        chunks.append((idx, stats.zty[idx], stats.znorm2[idx]))
    zero = torch.zeros((), device=dev)
    kw = _fused_kw(10**6)

    def chunk(i, fn=fs.dense_fused_chunk):
        idx, zty_s, zn2_s = chunks[i % 4]
        return fn(Xt, y, y, (zero, zero, zero), idx, zty_s, zn2_s, 0, delta, **kw)

    step_bytes = kappa * m * 4 + kappa * 16 + 3 * m * 4
    row("dense_fused_chunk",
        _time_queued(torch, chunk, 20),
        _time_queued(torch, lambda i: chunk(i, fs.dense_fused_chunk_plain), 2),
        None, FUSE * step_bytes, FUSE * 2 * kappa * m,
        note=f" [one chunk of K={FUSE} steps, kappa={kappa}, m={m}; library: none]")
    print(f"[timing] dense_fused_chunk per step: {out['dense_fused_chunk']['ms'] / FUSE:.6f} ms, "
          f"bound {out['dense_fused_chunk']['bound_ms'] / FUSE:.6f} ms")

    i_stars, _, dts, nps = chunk(0)[:4]
    lams = torch.linspace(0.05, 0.4, FUSE, device=dev)  # no renorm: a cold chunk's lam may be 1
    rcfg = main_config(p, "kernels", FUSE)
    beta = torch.zeros(p, device=dev)
    one, zero_i = torch.ones((), device=dev), torch.zeros((), dtype=torch.int32, device=dev)

    def replay(i, fn=fs.fused_replay):
        return fn(beta, one, zero, zero, zero_i, i_stars, lams, dts, nps, 0, rcfg)

    row("fused_replay",
        _time_queued(torch, replay, 200),
        # ~25 launches a record, K records a call: 4 calls stay under the launch queue
        _time_queued(torch, lambda i: replay(i, fs.fused_replay_plain), 4),
        None, FUSE * (8 + 4 + 4 + 1 + 4 + 4) + 4 * 4 + 4 * 4, FUSE * 12,
        note=f" [K={FUSE} records, no renorm; library: none]")

    floor = launch_floor_ms(torch, dev)
    print(f"[timing] launch floor: an empty kernel, queued back to back: {floor:.6f} ms a "
          f"launch; residual_update takes {out['residual_update']['ms'] / floor:.2f}x, "
          f"step_tail {out['step_tail']['ms'] / floor:.2f}x and "
          f"fused_replay {out['fused_replay']['ms'] / floor:.2f}x of it")

    # host share of a step: fixed-length runs of the main path's step, one
    # step per dispatch and fused
    kernel_ms = sum(out[k]["ms"] for k in ("sampled_scores", "vertex_argmax", "step_tail"))
    for backend, fuse, n_steps in (("kernels", 1, 300), ("torch", 1, 300),
                                   ("kernels", FUSE, 320), ("kernels", 32, 320)):
        bcfg = dataclasses.replace(main_config(p, backend, fuse), max_iters=n_steps,
                                   tol=0.0, patience=10**9)
        state0 = engine.init_state(fw_lasso.LASSO, Xt, y, None, bcfg)
        engine.run_loop(fw_lasso.LASSO, Xt, y, stats, state0, bcfg, delta, 10**9,
                        TorchSampler(3, dev))  # warm-up
        state0 = engine.init_state(fw_lasso.LASSO, Xt, y, None, bcfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_loop(fw_lasso.LASSO, Xt, y, stats, state0, bcfg, delta, 10**9,
                        TorchSampler(5, dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        if backend == "torch":
            print(f"[timing] step (torch backend): wall {wall_ms:.4f} ms")
            continue
        if fuse == 1:
            print(f"[timing] step (kernels): wall {wall_ms:.4f} ms, its kernels (K2's scores "
                  f"and argmax, the tail) {kernel_ms:.4f} ms, the rest (host launches, the "
                  f"per-step sync, the draw) {wall_ms - kernel_ms:.4f} ms = "
                  f"{100 * (wall_ms - kernel_ms) / wall_ms:.1f}% of the step")
        else:
            print(f"[timing] step (kernels, fuse_steps={fuse}): wall {wall_ms:.4f} ms per "
                  f"iteration, {wall_ms * fuse:.4f} ms per chunk")
        busy_ms = _device_busy_ms(torch, Xt, y, stats, bcfg, delta, n_steps=64 if fuse > 1 else 50)
        if busy_ms is None:
            print("[timing] device busy time per step: not measured (the "
                  "profiler reported no device time)")
        else:
            print(f"[timing] device busy per step (torch.profiler, fuse_steps={fuse}): "
                  f"{busy_ms:.4f} ms = {100 * busy_ms / wall_ms:.1f}% of the step's wall "
                  f"time, idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    return out


def launch_floor_ms(torch, dev, reps=400):
    """Device ms a launch of a kernel that does nothing (``empty_launch`` in
    the fused_step library), queued back to back: what any launch of the
    port's kernels takes at the least, the yardstick of the kernels whose
    bytes take far less (K3, the replay)."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.function("fused_step", "empty_launch", [ctypes.c_void_p])
    stream = _build.stream(dev)

    def launch(i):
        _build.check("fused_step", fn(stream), "empty_kernel")

    return _time_queued(torch, launch, reps)


def _device_busy_ms(torch, Xt, y, stats, cfg, delta, n_steps):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine, fw_lasso
    from repro_torch.core.vertex import TorchSampler

    cfg = dataclasses.replace(cfg, max_iters=n_steps)
    state0 = engine.init_state(fw_lasso.LASSO, Xt, y, None, cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run_loop(fw_lasso.LASSO, Xt, y, stats, state0, cfg, delta, 10**9,
                        TorchSampler(9, Xt.device))
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    # device-side rows only (kernels, memcpy, memset): the CPU ops' rows
    # repeat the time of the kernels they launched
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in rows)
    if total_us <= 0:
        return None
    print(f"[timing]   device work per step: {sum(e.count for e in rows) / n_steps:.1f} "
          f"kernels and copies, {total_us / n_steps:.2f} us")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[timing]   device {e.key[:60]}: {e.self_device_time_total / n_steps:.2f} us/step, "
              f"{e.count / n_steps:.3g} calls/step")
    return total_us / 1e3 / n_steps


# --------------------------------------------------------------------------
# the sparse path (E2006-log1p, block-ELL): phases 2-5
# --------------------------------------------------------------------------


def _ragged_sparse(torch, g, dev, dtype=None):
    """A ragged block-ELL matrix: p = 1000 over blocks of 256 (a partial
    tail block of 232 real features), m = 803, each feature 1-13 nonzeros
    so nnz_max = 13 with padded slots, unit norms; features 5, 17 and 900
    equal, so with r = z_5 they tie exactly for the largest |score|."""
    from repro_torch.sparse import SparseBlockMatrix

    dtype = torch.float32 if dtype is None else dtype
    p, m = 1000, 803
    X = torch.zeros((p, m), device=dev)
    nnz = torch.randint(1, 14, (p,), generator=g, device=dev)
    nnz[0] = nnz[5] = 13
    for f in range(p):
        rows = torch.randperm(m, generator=g, device=dev)[: int(nnz[f])]
        X[f, rows] = torch.randn(rows.numel(), generator=g, device=dev)
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    X[17] = X[5]
    X[900] = X[5]
    X = X.to(dtype).float()  # values exactly representable in the storage type
    mat = SparseBlockMatrix.from_dense(X.cpu(), block_size=SPARSE_BLOCK).to(dev)
    check(mat.nnz_max == 13 and mat.p_padded == 1024, "ragged sparse geometry")
    return mat.astype(dtype), X


def _ell_with_zeros(torch, g, p, m, nnz_max, dtype, block_size=128):
    """Block-ELL arrays on the card: feature f holds 0-nnz_max stored slots
    first, padding (value 0 at row 0) after, the tail features past p all
    padding; about one stored slot in ten holds an explicit 0 at its row."""
    dev = g.device
    pp = -(-p // block_size) * block_size
    count = torch.randint(0, nnz_max + 1, (pp, 1), generator=g, device=dev)
    stored = torch.arange(nnz_max, device=dev)[None, :] < count
    stored[p:] = False
    vals = torch.randn((pp, nnz_max), generator=g, device=dev) * stored
    vals[(torch.rand((pp, nnz_max), generator=g, device=dev) < 0.1) & stored] = 0.0
    rows = torch.randint(0, m, (pp, nnz_max), generator=g, device=dev,
                         dtype=torch.int32) * stored
    shape = (pp // block_size, block_size, nnz_max)
    return vals.to(dtype).view(shape), rows.view(shape)


def phase2_sparse_kernels(torch, mat, y):
    """K5, K6 and K7 against their plain versions on the card, at the
    sparse path's shapes and at ragged ones."""
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_colstats as sc
    from repro_torch.kernels import sparse_grad as sg

    dev = mat.device
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    errs = {}
    print(f"[kernels] sparse tolerance: sums of slot products within {RTOL_SUM:g} of "
          f"||z||*||r|| (summation order); argmax exact")
    p, nnz = mat.p, mat.nnz_max
    kappa = kappa_fraction(p, 0.01)
    ynorm = float(torch.linalg.vector_norm(y))  # unit-norm features: the scale ||z|| ||y||

    # ---- K5 at the main shapes: width 1 (uniform) and width 256 (block) ----
    def k5(label, m_, r, blk, bs, p_, scale, want=None):
        sk = sg.sparse_sampled_scores(m_.values, m_.rows, r, blk, bs)
        sp = sg.sparse_sampled_scores_plain(m_.values, m_.rows, r, blk, bs)
        e, a = _scaled_err(torch, sk, sp, scale)
        feats = fw.block_indices(blk.long(), bs)
        tail = feats >= p_
        check(e <= RTOL_SUM, f"sparse_sampled_scores {label} disagrees ({e:.2e})")
        check(bool((sk[tail] == 0).all()), f"sparse_sampled_scores {label}: tail not 0")
        ik, gk = fw.vertex_argmax(sk, blk, bs, p_)
        ip, gp = fw.argmax_plain(sp, blk, bs, p_)
        if int(ik) != int(ip):
            margin = _top2_margin(torch, sp.abs()[~tail], feats[~tail])
            check(margin <= RTOL_SUM * scale, f"sparse vertex {label}: {int(ik)} vs plain "
                  f"{int(ip)}, top-2 margin {margin:.3e}: no near-tie")
        ia, _ = fw.argmax_plain(sk, blk, bs, p_)
        check(int(ia) == int(ik), f"vertex_argmax {label}: {int(ik)} vs plain {int(ia)}")
        if want is not None:
            check(int(ik) == want, f"sparse vertex {label}: tie went to {int(ik)}, first in "
                  f"sample order is {want}")
        print(f"[kernels] sparse_sampled_scores {label} width={bs} n={sk.numel()}: err "
              f"{e:.2e} (abs {a:.2e}), tail features {int(tail.sum())} score 0, i_star "
              f"{int(ik)} (plain {int(ip)})")
        return a

    idx = TorchSampler(7, dev).uniform(kappa, p)
    errs["sparse_sampled_scores"] = k5(f"main kappa={kappa} nnz_max={nnz} f32", mat, y, idx, 1,
                                       p, ynorm)
    nb = kappa // SPARSE_BLOCK
    blk = torch.cat([torch.tensor([mat.nblocks - 1], device=dev),
                     torch.randperm(mat.nblocks - 1, generator=g, device=dev)[: nb - 1]])
    errs["sparse_sampled_scores"] = max(errs["sparse_sampled_scores"], k5(
        f"main nb={nb} blocks (the tail block first) f32", mat, y, blk, SPARSE_BLOCK, p, ynorm))

    for dt in (torch.float32, torch.bfloat16):
        rag, X = _ragged_sparse(torch, g, dev, dt)
        r = X[5].clone()
        lab = f"p=1000 m=803 nnz_max=13 {str(dt)[6:]}"
        for bs, b, want in (
            (1, torch.tensor([3, 17, 998, 5, 17, 42, 999, 900], device=dev), 17),
            (1, torch.randint(0, 1000, (300,), generator=g, device=dev), None),
            (SPARSE_BLOCK, torch.tensor([3, 0], device=dev), 900),
            (SPARSE_BLOCK, torch.tensor([0, 3], device=dev), 5),
        ):
            k5(lab + (" tie" if want is not None else " random draws"), rag, r, b, bs, 1000,
               1.0, want)

    # ---- K6 ------------------------------------------------------------------
    def k6(label, vals, rows, p_, yv):
        zty, zn2 = sc.sparse_colstats(vals, rows, yv, p_)
        again = sc.sparse_colstats(vals, rows, yv, p_)
        zty_p, zn2_p = sc.sparse_colstats_plain(vals, rows, yv, p_)
        norms = zn2_p.sqrt() * float(torch.linalg.vector_norm(yv.float()))
        e1, a1 = _scaled_err(torch, zty, zty_p, norms.clamp_min(1e-30))
        e2, a2 = _scaled_err(torch, zn2, zn2_p, zn2_p.clamp_min(1e-30))
        same = torch.equal(zty, again[0]) and torch.equal(zn2, again[1])
        pl = sc.plan(yv.numel(), vals.shape[2], vals.element_size())
        print(f"[kernels] sparse_colstats {label} ({pl}): zty err {e1:.2e} (abs {a1:.2e}), "
              f"znorm2 rel err {e2:.2e} (abs {a2:.2e}), two launches bitwise equal: {same}")
        check(e1 <= RTOL_SUM and e2 <= RTOL_SUM and zty.shape == (p_,) and same,
              f"sparse_colstats {label} disagrees")
        return max(a1, a2)

    errs["sparse_colstats"] = k6(f"main p={p} nnz_max={nnz} f32", mat.values, mat.rows, p, y)
    for dt in (torch.float32, torch.bfloat16):
        rag, _ = _ragged_sparse(torch, g, dev, dt)
        k6(f"p=1000 m=803 nnz_max=13 {str(dt)[6:]}", rag.values, rag.rows, rag.p,
           torch.randn(803, generator=g, device=dev))
    # explicit stored zeros, nnz_max 1 / 13 / 67 (a ragged tail past the last
    # tile), many tiles a block (the ring wraps), y past the staging budget
    for nnz_max, m_, p_, dts in ((1, 803, 1000, "f32 bf16"), (13, 803, 1000, "f32 bf16"),
                                 (67, 803, 1000, "f32 bf16"), (67, 803, 300_001, "f32 bf16"),
                                 (13, 60_000, 20_000, "f32 bf16")):
        for dt in dts.split():
            vals, rows = _ell_with_zeros(torch, g, p_, m_, nnz_max,
                                         torch.float32 if dt == "f32" else torch.bfloat16)
            k6(f"p={p_} m={m_} nnz_max={nnz_max} {dt} stored zeros", vals, rows, p_,
               torch.randn(m_, generator=g, device=dev))

    # ---- K7 at the main shapes, then ragged, then the ring's edges -----------
    pl = fs.plan(mat.m, nnz)
    blocks = fs._blocks("sparse", dev, mat.m, (nnz, *pl))
    print(f"[kernels] sparse_fused_chunk: cooperative grid of {blocks} blocks x {pl.threads} "
          f"threads at m={mat.m}, nnz_max={nnz}: {pl} ({pl.smem_bytes(mat.m)} bytes of shared "
          f"memory a block)")
    delta = torch.tensor(50.0, device=dev)
    idx = TorchSampler(13, dev).uniform_chunk(FUSE, kappa, p)
    err, _ = _check_chunk(torch, fs, f"main K={FUSE} kappa={kappa} m={mat.m}", mat, y, y, idx,
                          0, delta, _fused_kw(10**6))
    _check_chunk(torch, fs, "main k0=60 refresh at s=3 max_iters=66", mat, y, y, idx, 60, delta,
                 _fused_kw(66))
    errs["sparse_fused_chunk"] = err
    rag, X = _ragged_sparse(torch, g, dev)
    noise = torch.randn(803, generator=g, device=dev)
    yv = X[5] * 3.0 + 0.3 * noise / torch.linalg.vector_norm(noise)
    idx_r = torch.randint(0, 1000, (FUSE, 301), generator=g, device=dev)
    idx_r[0, :8] = torch.tensor([3, 17, 998, 5, 17, 42, 900, 5], device=dev)
    _, i_k = _check_chunk(torch, fs, "p=1000 m=803 nnz_max=13 kappa=301 tie+duplicates", rag,
                          yv, yv, idx_r, 0, delta, _fused_kw(10**6))
    check(int(i_k[0]) == 17, f"sparse fused chunk tie went to {int(i_k[0])}, first is 17")
    _check_chunk(torch, fs, "p=1000 m=803 kappa=301 k0=5 refresh_every=4 max_iters=11", rag,
                 yv, yv, idx_r, 5, delta, _fused_kw(11, refresh_every=4))
    _check_chunk(torch, fs, "p=1000 m=803 K=3 kappa=5003", rag, yv, yv,
                 torch.randint(0, 1000, (3, 5003), generator=g, device=dev), 0, delta,
                 _fused_kw(10**6))
    sparse_chunk_edge_cases(torch, fs, g)

    # ---- K5's scores keep the warp-per-feature kernel's bits ------------------
    got = k5_digests(torch, sg, mat, y)
    for bs, want in K5_SHA256.items():
        print(f"[kernels] sparse_sampled_scores width {bs} on k5_digest_inputs: sha256 "
              f"{got[bs][:16]}... (recorded {want[:16]}...): equal {got[bs] == want}")
        check(got[bs] == want, f"sparse_sampled_scores width {bs}: the scores' bits changed")

    # ---- the unfused step's tail, block-ELL: bit for bit ---------------------
    from repro_torch.kernels import step_tail as st

    # a drawn feature, its slots past its stored nonzeros padding
    i_pad = int(TorchSampler(7, dev).uniform(kappa, p)[0])
    check(int(torch.count_nonzero(mat.values.view(-1, nnz)[i_pad])) < nnz,
          "the sparse tail's main winner has no padding")
    tail_errs = [tail_edge_cases(torch, st, f"sparse main m={mat.m} nnz_max={nnz} (winner "
                                 "with padding)", (mat.values, mat.rows), p, mat.m,
                                 torch.float32, g, i_pad)]
    for dt in (torch.float32, torch.bfloat16):
        ell = _tail_ell(torch, g, 1000, 803, 13, dt, 5, [400, 0, 17, 802, 3])
        tail_errs.append(tail_edge_cases(
            torch, st, "sparse p=1000 m=803 nnz_max=13 (the winner's stored rows include row "
            "0, then padding)", ell, 1000, 803, dt, g, 5))
        ell = _tail_ell(torch, g, 300, 1, 3, dt, 42, [0])
        tail_errs.append(tail_edge_cases(torch, st, "sparse p=300 m=1 nnz_max=3", ell, 300, 1,
                                         dt, g, 42))
    errs["step_tail_sparse"] = max(tail_errs)
    phase2_fused_past_cap(torch, dev, g, "sparse")
    torch.cuda.synchronize()
    return errs


def _unit_ell(torch, g, p, m, nnz_max, extra_blocks=0, block_size=128):
    """A ``SparseBlockMatrix`` laid out as ``_ell_with_zeros`` lays its slots
    out (0-nnz_max stored slots first, about one in ten an explicit 0, then
    padding), with distinct rows within a feature (as ``from_coo`` makes
    them: the winner's slots are scatter-added without a collision) and
    unit-norm features; and the same arrays with ``extra_blocks`` blocks of
    padding features appended."""
    from repro_torch.sparse import SparseBlockMatrix

    dev = g.device
    pp = -(-p // block_size) * block_size
    count = torch.randint(0, nnz_max + 1, (pp, 1), generator=g, device=dev)
    stored = torch.arange(nnz_max, device=dev)[None, :] < count
    stored[p:] = False
    vals = torch.randn((pp, nnz_max), generator=g, device=dev) * stored
    vals[(torch.rand((pp, nnz_max), generator=g, device=dev) < 0.1) & stored] = 0.0
    vals /= torch.linalg.vector_norm(vals, dim=1, keepdim=True).clamp_min(1e-30)
    rows = torch.rand((pp, m), generator=g, device=dev).topk(nnz_max, dim=1).indices.int()
    shape = (pp // block_size, block_size, nnz_max)
    vals, rows = vals.view(shape), (rows * stored).view(shape)
    mat = SparseBlockMatrix(vals, rows, p, m, block_size, nnz_max)
    pad = torch.zeros((extra_blocks, block_size, nnz_max), device=dev)
    ext = SparseBlockMatrix(torch.cat([vals, pad]), torch.cat([rows, pad.int()]),
                            (pp // block_size + extra_blocks) * block_size, m, block_size,
                            nnz_max)
    return mat, ext


def sparse_chunk_edge_cases(torch, fs, g):
    """K7 against its plain version, two launches bitwise equal, where its
    ring has edges: odd and even ids (a feature's slots start 16-byte
    aligned only for some), a feature drawn twice in one step and again in
    the next, ids in the padded tail and past the arrays (>= n_feat: scored
    0 without a read; the plain side reads appended padding), nnz_max 1, 13,
    66 and 300 (a feature in 4 pieces of 96 slots), 66 in pieces of 32 (m
    = 30,000, the smallest pieces, beside a large residual) and no ring (m
    = M_MAX_SPARSE), K = 1, and kappa smaller than the grid's warps."""
    dev = g.device
    delta = torch.tensor(20.0, device=dev)
    kw = _fused_kw(10**6)

    def case(label, p, m, nnz_max, K, kappa, edit=None, extra_blocks=0):
        mat, ext = _unit_ell(torch, g, p, m, nnz_max, extra_blocks)
        idx = torch.randint(0, p, (K, kappa), generator=g, device=dev)
        if edit is not None:
            edit(idx, mat.values.shape[0] * mat.values.shape[1])
        noise = torch.randn(m, generator=g, device=dev)
        yv = noise / torch.linalg.vector_norm(noise) * 3.0
        pl = fs.plan(m, nnz_max)
        _check_chunk(torch, fs, f"{label} (p={p} m={m} nnz_max={nnz_max} K={K} kappa={kappa}, "
                     f"{pl})", mat, yv, yv, idx, 0, delta, kw, plain_mat=ext)

    def ids(idx, n_feat):
        idx[0, :10] = torch.tensor([3, 4, 7, 7, 10, 4, n_feat + 5, 1001, n_feat + 200, 1023],
                                   device=dev)
        idx[1, :4] = torch.tensor([7, 4, n_feat + 5, 1002], device=dev)
        idx[2, -3:] = torch.tensor([7, 7, n_feat + 127], device=dev)

    case("odd/even ids, repeats within and across steps, padded ids", 1000, 803, 66, FUSE,
         301, ids, extra_blocks=2)
    for nnz_max in (1, 13, 300):
        case(f"nnz_max={nnz_max}", 1000, 803, nnz_max, FUSE, 301)
    case("pieces of 32 slots", 1000, 30_000, 66, FUSE, 301)
    case("no ring: m = M_MAX_SPARSE", 1000, fs.M_MAX_SPARSE, 66, FUSE, 301)
    case("K=1", 1000, 803, 66, 1, 301)
    case("kappa below the grid's warps", 1000, 803, 66, FUSE, 7)


def sparse_golden_check(torch, dev):
    """The reference's converging golden through backend='sparse' on its
    block-ELL copy (64-wide blocks): unfused, 25 iterations, 1500 dots, the
    25 vertices; fused at K = 8, the same 25 vertices and a stop at most 7
    steps later (the stream is the golden's 25 rows, tiled: the steps past
    the unfused stop are the chunk's overshoot)."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.core import FWConfig, fw_solve
    from repro_torch.data import make_regression, standardize
    from repro_torch.sparse import SparseBlockMatrix

    ds = standardize(make_regression(m=80, p=300, n_informative=10, noise=0.5, seed=0))
    mat = SparseBlockMatrix.from_dense(ds.X.T, block_size=64).to(dev)
    yv = convert.problem_from_numpy(ds.X.T, ds.y, dev)[1]
    for fuse in (1, FUSE):
        cfg = FWConfig(delta=150.0, kappa=60, max_iters=5000, tol=1e-4, backend="sparse",
                       fuse_steps=fuse)
        seq = []
        stream = np.tile(golden_stream(), (8, 1))
        res = fw_solve(mat, yv, cfg, convert.stream_from_reference(stream, dev), device=dev,
                       on_step=lambda s: seq.extend(s.i_star.view(-1).tolist()))
        obj = float(res.objective)
        print(f"[golden] sparse fuse_steps={fuse} on the card: iters={res.iterations} "
              f"n_dots={res.n_dots} converged={bool(res.converged)} objective={obj!r} "
              f"(reference {GOLDEN_OBJECTIVE!r}), first 25 vertices equal: "
              f"{seq[:25] == GOLDEN_I_STAR}")
        check(seq[:25] == GOLDEN_I_STAR, f"sparse golden fuse={fuse}: vertex sequence {seq}")
        check(bool(res.converged) and abs(obj - GOLDEN_OBJECTIVE) <= 1e-6 * GOLDEN_OBJECTIVE,
              f"sparse golden fuse={fuse}: convergence / objective")
        if fuse == 1:
            check((res.iterations, res.n_dots) == (25, 1500), "sparse golden: iterations")
        else:
            check(25 <= res.iterations <= 25 + FUSE - 1, "sparse golden: fused overshoot")


def sparse_config(p, fuse_steps=FUSE, **kw):
    from repro_torch.core import FWConfig
    from repro_torch.core.sampling import kappa_fraction

    # examples/lasso_fullpath_4m.py --paper-size --backend sparse
    return FWConfig(delta=1.0, kappa=kappa_fraction(p, 0.01), sampling="uniform",
                    max_iters=5000, tol=1e-3, backend="sparse", fuse_steps=fuse_steps, **kw)


def _print_points(tag, res, cfg, extra_dots=0):
    """Each point of a path, checked: a finite objective, l1 <= delta, and
    (uniform sampling) kappa dots a step, plus the oracle's ``extra_dots``;
    then the path's totals."""
    for g, pt in enumerate(res.points):
        print(f"[{tag}] point {g:3d} delta={pt.reg:.6g} iters={pt.iterations} "
              f"n_dots={pt.n_dots} objective={pt.objective!r} l1={pt.l1:.6g} "
              f"active={pt.active} seconds={pt.seconds:.4f}")
        check(math.isfinite(pt.objective), f"{tag} point {g}: objective not finite")
        check(pt.l1 <= pt.reg * (1 + 1e-4), f"{tag} point {g}: l1 {pt.l1} > delta {pt.reg}")
        check(pt.n_dots == pt.iterations * (cfg.kappa + extra_dots) or cfg.sampling != "uniform",
              f"{tag} point {g}: n_dots")
    print(f"[{tag}] path: {len(res.points)} points, {res.total_iters} iterations, "
          f"{res.total_dots:,} dots, {res.total_seconds:.3f} s, "
          f"{1e3 * res.total_seconds / max(res.total_iters, 1):.4f} ms/iteration, "
          f"mean active {res.mean_active:.1f}")


def phase3_sparse_fused_path(torch, mat, y, coef):
    """The 100-point grid on 'sparse' with fuse_steps = 8: K6 once per
    point, K7 and the replay once per chunk, K5 and the argmax never."""
    from repro_torch import kernels
    from repro_torch.core import LASSO, delta_grid, fw_path

    cfg = sparse_config(mat.p)
    delta_max = 0.5 * float(coef.abs().sum())
    deltas = delta_grid(delta_max, n_points=N_POINTS)
    rec = Recorder(N_COMPARE)
    print(f"[sparse] fw_path backend=sparse fuse_steps={FUSE} p={mat.p:,} m={mat.m:,} "
          f"kappa={cfg.kappa:,} sampling=uniform max_iters={cfg.max_iters} tol={cfg.tol} "
          f"points={N_POINTS} delta_max={delta_max:.6g}")
    kernels.reset_launch_counts()
    res = fw_path(mat, y, deltas, cfg, seed=0, device=mat.device, on_step=rec)
    launches = kernels.launch_counts()
    _print_points("sparse", res, cfg)
    print(f"[sparse] launches during the path: {launches}")
    chunks = sum(-(-pt.iterations // FUSE) for pt in res.points)
    check(launches["sparse_fused_chunk"] == chunks == launches["fused_replay"],
          f"sparse fused launches {launches['sparse_fused_chunk']}/{launches['fused_replay']} "
          f"!= chunks {chunks}")
    check(launches["sparse_colstats"] == len(res.points), "sparse_colstats launches != points")
    for name in ("sparse_sampled_scores", "vertex_argmax", "colstats", "sampled_scores",
                 "residual_update", "dense_fused_chunk", "step_tail") + TEL_KERNELS:
        check(launches[name] == 0, f"the fused sparse path launched {name}")
    last = res.points[-1]
    alpha = _alpha_from_point(torch, last, mat.p, mat.device)
    gap = float(LASSO.gap(mat, y, alpha, torch.tensor(last.reg, device=mat.device)))
    print(f"[sparse] certified duality gap at the densest point: {gap!r} "
          f"(objective {last.objective!r})")
    check(math.isfinite(gap) and gap >= -1e-4 * abs(last.objective), "sparse certified gap")
    return launches, dict(cfg=cfg, deltas=deltas, res=res, rec=rec)


def phase3_warm_start_bits(torch, mat, fused):
    """F3: the warm start's X @ alpha (``sparse_ops.sparse_matvec``) twice,
    at the densest point's alpha and at a large active set (100,000
    features drawn from a seed): equal bits (its fixed-order sum), and its
    time, and the bits of the host's sequential scatter-add. Beside it,
    for the record only, the same sum as one CUDA ``index_add_`` (the
    route before: colliding rows added by atomics), twice."""
    last = fused["res"].points[-1]
    _warm_start_case(torch, mat, _alpha_from_point(torch, last, mat.p, mat.device),
                     "at the densest point")
    g = torch.Generator(device=mat.device)
    g.manual_seed(11)
    alpha = torch.zeros(mat.p, device=mat.device)
    alpha[torch.randperm(mat.p, generator=g, device=mat.device)[:100_000]] = torch.randn(
        100_000, generator=g, device=mat.device)
    _warm_start_case(torch, mat, alpha, "at a large active set")


def _warm_start_case(torch, mat, alpha, label):
    from repro_torch.sparse import ops as sparse_ops

    times = []
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(sparse_ops.sparse_matvec(mat, alpha))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    a, b = outs
    nz = torch.nonzero(alpha).view(-1)
    vals = mat.values.reshape(-1, mat.nnz_max).index_select(0, nz)
    rows = mat.rows.reshape(-1, mat.nnz_max).index_select(0, nz).view(-1)
    contrib = (vals * alpha.index_select(0, nz)[:, None]).view(-1)
    seq = torch.zeros(mat.m).index_add_(0, rows.long().cpu(), contrib.cpu())  # sequential

    def index_add_route():
        out = torch.zeros(mat.m, device=mat.device)
        return out.index_add_(0, rows, contrib)

    c, d = index_add_route(), index_add_route()
    same = _same_bits(torch, a, b)
    as_host = _same_bits(torch, a.cpu(), seq)
    print(f"[sparse] F3 warm start {label} ({nz.numel():,} nonzero coefficients, "
          f"{int(torch.count_nonzero(vals)):,} stored contributions): sparse_matvec twice, "
          f"bitwise equal: {same} ({times[0]:.3f} ms, then {times[1]:.3f} ms a call, host "
          f"clock); the card's bits are the host's sequential scatter-add's: "
          f"{as_host}, max |diff| {float((a.cpu() - seq).abs().max()):.3e}"
          f"; the one-index_add_ route twice, bitwise equal: {_same_bits(torch, c, d)}, max "
          f"|diff| {float((c - d).abs().max()):.3e}")
    check(same, f"F3: two warm starts {label} differ in their bits")
    check(as_host, f"F3: the warm start {label} is not the sequential sum's bits")


def phase3_sparse_unfused_points(torch, mat, y, fused):
    """The grid's first points one step per dispatch: K5 at width 1 and
    K2's argmax once per step, K6 once per point."""
    from repro_torch import kernels
    from repro_torch.core import fw_path

    cfg = dataclasses.replace(fused["cfg"], fuse_steps=1)
    rec = Recorder(N_COMPARE)
    kernels.reset_launch_counts()
    res = fw_path(mat, y, fused["deltas"][:N_COMPARE], cfg, seed=0, device=mat.device,
                  on_step=rec)
    launches = kernels.launch_counts()
    _print_points("sparse-unfused", res, cfg)
    print(f"[sparse-unfused] launches: {launches}")
    check(launches["sparse_sampled_scores"] == launches["vertex_argmax"] == res.total_iters
          == launches["step_tail"], "unfused sparse: K5 / argmax / tail launches != iterations")
    check(launches["residual_update"] == 0, "unfused sparse: K3 launched")
    check(launches["sparse_colstats"] == N_COMPARE, "unfused sparse: K6 launches != points")
    check(launches["sparse_fused_chunk"] == 0 == launches["fused_replay"],
          "unfused sparse path launched the fused chunk")
    return launches, dict(cfg=cfg, res=res, rec=rec)


def phase3_sparse_block_point(torch, mat, y, fused):
    """One grid point with 'block' sampling, a fixed N_BLOCK_STEPS steps:
    K5 at width 256 once per step."""
    from repro_torch import kernels
    from repro_torch.core import fw_solve
    from repro_torch.core.vertex import TorchSampler

    cfg = dataclasses.replace(fused["cfg"], sampling="block", fuse_steps=1,
                              max_iters=N_BLOCK_STEPS, tol=0.0, patience=10**9)
    delta = float(fused["deltas"][N_POINTS // 2])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = fw_solve(mat, y, cfg, TorchSampler(21, mat.device), delta=delta, device=mat.device)
    obj = float(res.objective)
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    nb = cfg.kappa // mat.block_size
    print(f"[sparse-block] delta={delta:.6g} sampling=block {nb} blocks of {mat.block_size} "
          f"a step: iters={res.iterations} n_dots={res.n_dots} objective={obj!r} "
          f"{dt:.3f} s ({1e3 * dt / res.iterations:.4f} ms/iteration); launches {launches}")
    check(math.isfinite(obj) and res.iterations == N_BLOCK_STEPS, "block point")
    check(res.n_dots == N_BLOCK_STEPS * nb * mat.block_size, "block point: n_dots")
    check(launches["sparse_sampled_scores"] == N_BLOCK_STEPS == launches["vertex_argmax"]
          == launches["step_tail"], "block point: K5 / argmax / tail launches != steps")
    return launches


def phase4_sparse_routes(torch, mat, y, fused, unfused):
    """The sparse path's first points: fused against unfused, and the
    kernels against the plain ops (sparse_kernel=False) on the card."""
    from repro_torch.core import fw_path

    deltas = fused["deltas"]
    kappa = fused["cfg"].kappa
    _compare_paths(torch, mat, y, deltas, kappa,
                   dict(label=f"sparse fused K={FUSE}", res=fused["res"], rec=fused["rec"]),
                   dict(label="sparse unfused", res=unfused["res"], rec=unfused["rec"]),
                   max_overshoot=FUSE - 1)
    cfg = dataclasses.replace(unfused["cfg"], sparse_kernel=False)
    rec = Recorder(N_COMPARE)
    res = fw_path(mat, y, deltas[:N_COMPARE], cfg, seed=0, device=mat.device, on_step=rec)
    _print_points("sparse-plain", res, cfg)
    _compare_paths(torch, mat, y, deltas, kappa,
                   dict(label="sparse kernels", res=unfused["res"], rec=unfused["rec"]),
                   dict(label="sparse plain ops", res=res, rec=rec), max_overshoot=0)


def phase4_sparse_vs_dense(torch, dev):
    """The sparse backend against the dense 'kernels' backend on the
    E2006-log1p proxy at scale 0.01 (m = 160, p = 42,722), the same sampler
    seeds, one step per dispatch: the same vertices up to a near-tie."""
    from repro_torch.core import FWConfig, delta_grid, fw_path
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.data import make_sparse_proxy

    ds = make_sparse_proxy("e2006-log1p", scale=0.01, seed=0, block_size=SPARSE_BLOCK)
    mat = ds.mat.to(dev)
    y = torch.from_numpy(ds.y).to(dev)
    Xt = mat.to_dense()
    deltas = delta_grid(0.5 * float(abs(ds.coef).sum()), n_points=N_COMPARE)
    kw = dict(delta=1.0, kappa=kappa_fraction(mat.p, 0.01), max_iters=5000, tol=1e-3)
    print(f"[sparse-vs-dense] {ds.name}: m={mat.m} p={mat.p} nnz_max={mat.nnz_max}, "
          f"kappa={kw['kappa']}")
    runs = {}
    for backend, X in (("sparse", mat), ("kernels", Xt)):
        rec = Recorder(N_COMPARE)
        res = fw_path(X, y, deltas, FWConfig(backend=backend, **kw), seed=0, device=dev,
                      on_step=rec)
        _print_points(f"sparse-vs-dense {backend}", res, FWConfig(**kw))
        runs[backend] = dict(label=backend, res=res, rec=rec)
    # the two backends sum each score and the S/F refresh in other orders
    # (a feature's slots against its dense row), so their objectives
    # 0.5 y.y + 0.5 S - F agree to rounding of those terms, ||y||^2 / 2 in
    # scale: near the densest point the objective itself is 200x smaller
    _compare_paths(torch, Xt, y, deltas, kw["kappa"], runs["sparse"], runs["kernels"],
                   max_overshoot=0, obj_scale=0.5 * float(torch.dot(y, y)))


def phase5_sparse_timing(torch, mat, y):
    """CUDA-event times of K5 (widths 1 and 256), K6 (L2 flushed) and K7 per
    chunk with their bounds, plain versions and library yardsticks; then
    the sparse path's step wall time and device busy share, unfused and
    fused at K = 8 and 32."""
    from repro_torch.core import engine, fw_lasso
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import sparse_colstats as sc
    from repro_torch.kernels import sparse_grad as sg

    p, m, nnz = mat.p, mat.m, mat.nnz_max
    cfg = sparse_config(p, fuse_steps=1)
    kappa = cfg.kappa
    dev = mat.device
    out = {}
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    vals, rows = mat.values, mat.rows

    def row(name, ms, plain_ms, library_ms, nbytes, flops, note=""):
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        lib = "null" if library_ms is None else f"{library_ms:.6f} ms"
        print(f"[timing] {name}: {ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.6f} ms, "
              f"library {lib}{note}")

    # The bounds count what the data needs: every value slot of a read
    # feature (4 bytes; a kernel must read the padding to find it), but a
    # row index and two operations only for each slot that holds a nonzero.
    slots = vals.view(-1, nnz)

    def stored(feats):  # mean stored nonzeros over the timed feature sets
        return sum(int(torch.count_nonzero(slots[f.reshape(-1).long()])) for f in feats) / len(feats)

    sampler = TorchSampler(11, dev)
    idxs = [sampler.uniform(kappa, p) for _ in range(32)]  # 32 * 22 MB of slots >> L2
    r = y.clone()
    nz = stored(idxs)
    row("sparse_sampled_scores",
        _time_queued(torch, lambda i: sg.sparse_sampled_scores(vals, rows, r, idxs[i % 32], 1),
                     200),
        _time_queued(torch, lambda i: sg.sparse_sampled_scores_plain(vals, rows, r,
                                                                     idxs[i % 32], 1), 50),
        None, kappa * nnz * 4 + nz * 4 + kappa * 4 + kappa * 8 + m * 4, 2 * nz,
        note=f" [width 1, kappa={kappa}, nnz_max={nnz}, m={m}; library: none, no one call "
             "gathers and scores sampled block-ELL features]")
    nb = kappa // SPARSE_BLOCK
    blks = [torch.randperm(mat.nblocks, generator=sampler.generator, device=dev)[:nb]
            for _ in range(32)]
    n = nb * SPARSE_BLOCK
    t_k = _time_queued(torch, lambda i: sg.sparse_sampled_scores(vals, rows, r, blks[i % 32],
                                                                 SPARSE_BLOCK), 200)
    t_p = _time_queued(torch, lambda i: sg.sparse_sampled_scores_plain(vals, rows, r,
                                                                       blks[i % 32],
                                                                       SPARSE_BLOCK), 50)
    nz = stored([(b[:, None] * SPARSE_BLOCK + torch.arange(SPARSE_BLOCK, device=dev))
                 for b in blks])
    b_ms, b_by = _bound(n * nnz * 4 + nz * 4 + n * 4 + nb * 8 + m * 4, 2 * nz)
    print(f"[timing] sparse_sampled_scores width {SPARSE_BLOCK} ({nb} blocks): {t_k:.6f} ms, "
          f"bound {b_ms:.6f} ms ({b_by}, {100 * b_ms / t_k:.1f}% of bound), plain {t_p:.6f} ms")

    from repro_torch.core import FWConfig
    from repro_torch.kernels import step_tail as st

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    tcfg = FWConfig(delta=5.0)
    i_t = int(idxs[0][0])
    beta_t, targs = _tail_args(torch, gen, p, m, torch.float32, i_t)
    t_k = _time_queued(torch, lambda i: st.step_tail((vals, rows), beta_t, *targs, tcfg), 400)
    t_p = _time_queued(torch, lambda i: st.step_tail_plain((vals, rows), beta_t, *targs, tcfg),
                       10)  # ~75 launches a call, so 10 calls stay under the launch queue
    b_ms, b_by = _bound(3 * m * 4 + nnz * 8 + 64, 4 * m + 2 * nnz)
    out["step_tail_sparse"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
    print(f"[timing] step_tail sparse (m={m}, nnz_max={nnz}, no renorm): {t_k:.6f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}, {100 * b_ms / t_k:.1f}% of bound), plain {t_p:.6f} ms, "
          "library null")

    k6 = sparse_colstats_times(torch, sc, mat, y, flush)
    row("sparse_colstats", k6["ms"], k6["plain_ms"], k6["library_ms"], k6["nbytes"],
        k6["flops"], note=k6["note"])

    stats = engine.precompute_colstats(mat, y, cfg)
    delta = torch.tensor(50.0, device=dev)
    chunks = []
    for _ in range(4):
        idx = sampler.uniform_chunk(FUSE, kappa, p)
        chunks.append((idx, stats.zty[idx], stats.znorm2[idx]))
    zero = torch.zeros((), device=dev)
    kw = _fused_kw(10**6)

    def chunk(i, fn=fs.sparse_fused_chunk):
        idx, zty_s, zn2_s = chunks[i % 4]
        return fn(vals, rows, y, y, (zero, zero, zero), idx, zty_s, zn2_s, 0, delta, **kw)

    nz = stored([idx for idx, _, _ in chunks])  # a chunk's K steps of kappa features
    row("sparse_fused_chunk",
        _time_queued(torch, chunk, 20),
        _time_queued(torch, lambda i: chunk(i, fs.sparse_fused_chunk_plain), 2),
        None, FUSE * (kappa * nnz * 4 + kappa * 16 + 3 * m * 4) + nz * 4, 2 * nz,
        note=f" [one chunk of K={FUSE} steps, kappa={kappa}, nnz_max={nnz}, m={m}; "
             "library: none]")
    print(f"[timing] sparse_fused_chunk per step: {out['sparse_fused_chunk']['ms'] / FUSE:.6f} "
          f"ms, bound {out['sparse_fused_chunk']['bound_ms'] / FUSE:.6f} ms")
    # a step's fixed cost: kappa = 1 leaves the grid barrier, the cross-block
    # reduction and the scalar algebra, plus each block's O(m) residual pass
    # unless the steps are masked (k0 = max_iters: no update, no refresh)
    one = [(idx[:, :1].contiguous(), zty_s[:, :1].contiguous(), zn2_s[:, :1].contiguous())
           for idx, zty_s, zn2_s in chunks]
    fixed = {}
    for label, k0 in (("with the O(m) update", 0), ("masked, no update", 10**6)):
        fixed[label] = _time_queued(torch, lambda i: fs.sparse_fused_chunk(
            vals, rows, y, y, (zero, zero, zero), *one[i % 4], k0, delta, **kw), 20) / FUSE
    t_step = out["sparse_fused_chunk"]["ms"] / FUSE
    t_upd, t_bar = fixed["with the O(m) update"], fixed["masked, no update"]
    print(f"[timing] sparse_fused_chunk fixed cost per step (kappa=1): {t_upd:.6f} ms with the "
          f"O(m) update, {t_bar:.6f} ms masked (barrier, reduction, scalars); of the "
          f"{t_step:.6f} ms step: barrier+reduction {100 * t_bar / t_step:.1f}%, O(m) update "
          f"{100 * (t_upd - t_bar) / t_step:.1f}%, scoring the rest "
          f"{100 * (t_step - t_upd) / t_step:.1f}%")

    k1 = out["sparse_sampled_scores"]["ms"]
    for fuse, n_steps in ((1, 300), (FUSE, 320), (32, 320)):
        bcfg = dataclasses.replace(sparse_config(p, fuse), max_iters=n_steps, tol=0.0,
                                   patience=10**9)
        state0 = engine.init_state(fw_lasso.LASSO, mat, y, None, bcfg)
        engine.run_loop(fw_lasso.LASSO, mat, y, stats, state0, bcfg, delta, 10**9,
                        TorchSampler(3, dev))  # warm-up
        state0 = engine.init_state(fw_lasso.LASSO, mat, y, None, bcfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_loop(fw_lasso.LASSO, mat, y, stats, state0, bcfg, delta, 10**9,
                        TorchSampler(5, dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        note = (f", K5 {k1:.4f} ms and the tail {out['step_tail_sparse']['ms']:.4f} ms of it"
                if fuse == 1 else f", {wall_ms * fuse:.4f} ms per chunk")
        print(f"[timing] sparse step (fuse_steps={fuse}): wall {wall_ms:.4f} ms per "
              f"iteration{note}")
        busy_ms = _device_busy_ms(torch, mat, y, stats, bcfg, delta,
                                  n_steps=64 if fuse > 1 else 50)
        if busy_ms is None:
            print("[timing] device busy time per step: not measured (the profiler reported "
                  "no device time)")
        else:
            print(f"[timing] sparse device busy per step (torch.profiler, fuse_steps={fuse}): "
                  f"{busy_ms:.4f} ms = {100 * busy_ms / wall_ms:.1f}% of the step's wall "
                  f"time, idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    return out



# --------------------------------------------------------------------------
# batched delta lanes (engine.solve_batched, path.fw_path_batched): the
# lane-axis kernels in phase 2, the example's batched driver in phase 3,
# lanes against sequential replays in phase 4, timing in phase 5
# --------------------------------------------------------------------------

LANE_WIDTH = 13  # the example's lane width at 100 points: -(-100 // 8)
LANE_COUNTS = (1, 3, 13)
P_LANES = 200_000  # phase 4: recorded streams of 4 lanes x 400 steps fit


def _lane_sets(L):
    """The lanes that run: all; all but lane 1 (a frozen lane among active
    ones); none (every lane frozen)."""
    sets = [list(range(L))]
    if L > 1:
        sets.append([lane for lane in range(L) if lane != 1])
    return sets + [[]]


def _lane_scores_check(torch, fw, label, lanes_fn, one_fn, plain_fn, blk, bs, p, L, scale):
    """A lane scores kernel (``lanes_fn(ids)``) and K2's lane argmax on its
    scores, for each set of running lanes: every running lane's scores and
    winner bitwise the one-lane launches' on its own inputs (``one_fn``), a
    frozen lane's winner (-1, 0), two argmax launches bitwise equal (each
    lane's ticket back at 0), the winners bitwise the plain argmax's on the
    same scores, the scores within RTOL_SUM * scale of the plain version's.
    Returns max |kernel - plain| over the scores."""
    dev = blk.device
    err = 0.0
    for run in _lane_sets(L):
        ids = torch.tensor(run, dtype=torch.int32, device=dev)
        got = lanes_fn(ids)
        i1, g1 = fw.vertex_argmax_lanes(got, blk, bs, p, ids)
        i2, g2 = fw.vertex_argmax_lanes(got, blk, bs, p, ids)
        check(_same_bits(torch, i1, i2) and _same_bits(torch, g1, g2),
              f"{label} L={L} lanes {run}: two argmax launches differ")
        if run:
            plain = plain_fn(ids)
            rel, d = _scaled_err(torch, got[run], plain[run], scale)
            check(rel <= RTOL_SUM, f"{label} L={L}: scores off the plain version by {rel:.2e}")
            err = max(err, d)
            ip, gp = fw.argmax_lanes_plain(got, blk, bs, p, ids)
            check(_same_bits(torch, i1, ip) and _same_bits(torch, g1, gp),
                  f"{label} L={L}: the lane argmax differs from its plain version")
        i_host, g_host = i1.tolist(), g1.tolist()
        for lane in range(L):
            if lane not in run:
                check(i_host[lane] == -1 and g_host[lane] == 0.0,
                      f"{label} L={L}: frozen lane {lane} got ({i_host[lane]}, {g_host[lane]})")
                continue
            bl = fw.lane_blk(blk, lane)
            one = one_fn(lane, bl)
            check(_same_bits(torch, got[lane], one),
                  f"{label} L={L}: lane {lane}'s scores differ from a one-lane launch")
            io, go = fw.vertex_argmax(one, bl, bs, p)
            check(i_host[lane] == int(io) and _same_bits(torch, g1[lane], go),
                  f"{label} L={L}: lane {lane}'s winner differs from a one-lane launch")
    print(f"[lanes] {label} L={L}: every running lane bitwise its one-lane launch (scores and "
          f"winner), frozen lanes (-1, 0), two argmax launches equal; max |kernel - plain| "
          f"{err:.3e}")
    return err


def _lane_tail_state(torch, g, p, m, dtype, L):
    """A lane-stacked state for the lane tail: beta (L, p), then
    step_tail_lanes' arguments from ``scale`` to ``delta``; lane 0's scale
    is just above the renorm threshold, so its step renormalizes (lam past
    1%) and no other lane's does."""
    dev = g.device
    scale = torch.full((L,), 0.9, device=dev)
    scale[0] = 1.01e-6
    gs = torch.randn(L, generator=g, device=dev) * 5
    gs[0] = 50.0  # lam near 0.4 in lane 0
    beta = torch.randn((L, p), generator=g, device=dev).to(dtype)
    args = (scale.to(dtype), (torch.rand(L, generator=g, device=dev) + 1).to(dtype),
            torch.rand(L, generator=g, device=dev).to(dtype),
            torch.arange(L, dtype=torch.int32, device=dev),
            torch.randn((L, m), generator=g, device=dev).to(dtype),
            (torch.rand(L, generator=g, device=dev) * 30 + 10).to(dtype),
            (torch.rand(L, generator=g, device=dev) * 10).to(dtype),
            torch.randn(m, generator=g, device=dev).to(dtype),
            torch.randn(p, generator=g, device=dev).to(dtype),
            (torch.rand(p, generator=g, device=dev) + 0.5).to(dtype),
            torch.randint(0, p, (L,), generator=g, device=dev), gs,
            torch.full((L,), 20.0, device=dev))
    return beta, args


def _lane_tail_check(torch, st, label, mat, beta, args, L, cfg):
    """The lane tail for each set of running lanes: every output bitwise its
    plain version's; every running lane bitwise a one-lane launch on its
    row and scalars; a frozen lane's outputs its inputs, its beta row
    untouched; only lane 0 renormalizes. Returns max |kernel - plain|."""
    dev = beta.device
    scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, zty, zn2, i_star, gs, delta = args
    for run in _lane_sets(L):
        ids = torch.tensor(run, dtype=torch.int32, device=dev)
        b_k, b_p = beta.clone(), beta.clone()
        got = st.step_tail_lanes(mat, b_k, *args, ids, cfg)
        want = st.step_tail_lanes_plain(mat, b_p, *args, ids, cfg)
        differ = [n for n, a, b in zip(TAIL_OUT, got, want) if not _same_bits(torch, a, b)]
        check(not differ, f"step_tail_lanes {label} L={L} lanes {run}: {differ} differ from the "
                          "plain version")
        for lane in range(L):
            if lane not in run:
                check(_same_bits(torch, b_k[lane], beta[lane]), f"{label}: frozen beta moved")
                for n, out, inp in zip(TAIL_OUT[1:], got[1:], args[:7]):
                    check(_same_bits(torch, out[lane], inp[lane]),
                          f"step_tail_lanes {label}: frozen lane {lane}'s {n} changed")
                continue
            b1 = beta[lane].clone()
            one = st.step_tail(mat, b1, scale[lane].clone(), maxabs[lane].clone(),
                               stall[lane].clone(), resid[lane].clone(), s_quad[lane].clone(),
                               f_lin[lane].clone(), y, zty, zn2, i_star[lane].clone(),
                               gs[lane].clone(), delta[lane].clone(), cfg)
            check(_same_bits(torch, b_k[lane], b1) and all(
                _same_bits(torch, out[lane], o) for out, o in zip(got[1:], one[1:])),
                f"step_tail_lanes {label} L={L}: lane {lane} differs from a one-lane launch")
        if run:
            renormed = [lane for lane in run if float(got[1][lane]) == 1.0]
            check(renormed == [0] if 0 in run else not renormed,
                  f"step_tail_lanes {label}: lanes {renormed} renormalized, lane 0 alone should")
    print(f"[lanes] step_tail_lanes {label} L={L}: bit for bit its plain version and each lane's "
          "one-lane launch, frozen lanes untouched, the renorm in lane 0 only")
    return 0.0


def phase2_lane_kernels(torch, Xt, y):
    """The dense lane-axis kernels at the main path's shapes (kappa = 1% of
    p, width 1; the tail at p = 4,272,227, m = 800) and 'full' sampling (n
    = p, the block ids shared) for L = 1, 3 and 13, and in bf16 at L = 3."""
    from repro_torch.core import FWConfig
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import step_tail as st

    p, m = Xt.shape
    dev = Xt.device
    kappa = kappa_fraction(p, 0.01)
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    row_scale = float(torch.linalg.vector_norm(Xt[:100000], dim=1).max())
    errs = {"sampled_scores_lanes": 0.0, "vertex_argmax_lanes": 0.0, "step_tail_lanes": 0.0}
    for L in LANE_COUNTS:
        r = torch.randn((L, m), generator=g, device=dev)
        blk = torch.randint(0, p, (L, kappa), generator=g, device=dev)
        scale = float(torch.linalg.vector_norm(r, dim=1).max()) * row_scale
        errs["sampled_scores_lanes"] = max(errs["sampled_scores_lanes"], _lane_scores_check(
            torch, fw, f"sampled_scores_lanes kappa={kappa}", 
            lambda ids: fw.sampled_scores_lanes(Xt, r, blk, 1, ids),
            lambda lane, bl: fw.sampled_scores(Xt, r[lane].clone(), bl, 1),
            lambda ids: fw.sampled_scores_lanes_plain(Xt, r, blk, 1, ids), blk, 1, p, L, scale))
        beta, args = _lane_tail_state(torch, g, p, m, torch.float32, L)
        _lane_tail_check(torch, st, f"dense p={p} m={m}", Xt, beta, args, L, FWConfig(delta=20.0))
        del beta, args
    # 'full' sampling: n = p, one block-id vector shared by the lanes
    L = 3
    r = torch.randn((L, m), generator=g, device=dev)
    blk = torch.arange(-(-p // 128), device=dev)
    scale = float(torch.linalg.vector_norm(r, dim=1).max()) * row_scale
    _lane_scores_check(torch, fw, "sampled_scores_lanes 'full' n=p",
                       lambda ids: fw.sampled_scores_lanes(Xt, r, blk, 128, ids),
                       lambda lane, bl: fw.sampled_scores(Xt, r[lane].clone(), bl, 128),
                       lambda ids: fw.sampled_scores_lanes_plain(Xt, r, blk, 128, ids),
                       blk, 128, p, L, scale)
    # bf16 designs, L = 3
    Xb = torch.randn((1000, 803), generator=g, device=dev).to(torch.bfloat16)
    rb = torch.randn((L, 803), generator=g, device=dev)
    blk = torch.randint(0, 1000, (L, 700), generator=g, device=dev)
    _lane_scores_check(torch, fw, "sampled_scores_lanes bf16 p=1000 m=803",
                       lambda ids: fw.sampled_scores_lanes(Xb, rb, blk, 1, ids),
                       lambda lane, bl: fw.sampled_scores(Xb, rb[lane].clone(), bl, 1),
                       lambda ids: fw.sampled_scores_lanes_plain(Xb, rb, blk, 1, ids),
                       blk, 1, 1000, L, 803 * 40.0)
    beta, args = _lane_tail_state(torch, g, 1000, 803, torch.bfloat16, L)
    _lane_tail_check(torch, st, "dense bf16 p=1000 m=803", Xb, beta, args, L,
                     FWConfig(delta=20.0))
    torch.cuda.synchronize()
    return errs


def phase2_sparse_lane_kernels(torch, mat, y):
    """K5's lane scores at E2006-log1p's shapes (width 1 at kappa = 1% of p,
    width 256 over 166 blocks; m = 16,087, odd, so lanes past 0 stage an
    unaligned residual) and the sparse lane tail, for L = 1, 3 and 13; K5's
    warp-per-feature route (bf16) and the bf16 tail at L = 3."""
    from repro_torch.core import FWConfig
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg
    from repro_torch.kernels import step_tail as st

    p, m = mat.p, mat.m
    dev = mat.device
    kappa = kappa_fraction(p, 0.01)
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    vals, rows = mat.values, mat.rows
    col_scale = float(torch.linalg.vector_norm(vals.float().view(-1, mat.nnz_max)[:200000],
                                               dim=1).max())
    errs = {"sparse_sampled_scores_lanes": 0.0, "step_tail_lanes_sparse": 0.0}
    for L in LANE_COUNTS:
        r = torch.randn((L, m), generator=g, device=dev)
        scale = float(torch.linalg.vector_norm(r, dim=1).max()) * col_scale
        for bs, blk in ((1, torch.randint(0, p, (L, kappa), generator=g, device=dev)),
                        (SPARSE_BLOCK, torch.stack([
                            torch.randperm(mat.nblocks, generator=g, device=dev)[
                                :max(1, kappa // SPARSE_BLOCK)] for _ in range(L)]))):
            errs["sparse_sampled_scores_lanes"] = max(
                errs["sparse_sampled_scores_lanes"], _lane_scores_check(
                    torch, fw, f"sparse_sampled_scores_lanes width {bs}",
                    lambda ids: sg.sparse_sampled_scores_lanes(vals, rows, r, blk, bs, ids),
                    lambda lane, bl: sg.sparse_sampled_scores(vals, rows, r[lane].clone(), bl, bs),
                    lambda ids: sg.sparse_sampled_scores_lanes_plain(vals, rows, r, blk, bs, ids),
                    blk, bs, p, L, scale))
        beta, args = _lane_tail_state(torch, g, p, m, torch.float32, L)
        _lane_tail_check(torch, st, f"sparse p={p} m={m}", (vals, rows), beta, args, L,
                         FWConfig(delta=20.0))
        del beta, args
    L = 3
    small, _ = _ragged_sparse(torch, g, dev, torch.bfloat16)
    rb = torch.randn((L, small.m), generator=g, device=dev)
    blk = torch.randint(0, small.p, (L, 300), generator=g, device=dev)
    check(sg.scores_plan(small.dtype, small.m, small.nnz_max).depth == 0, "bf16 K5: no ring")
    _lane_scores_check(torch, fw, "sparse_sampled_scores_lanes bf16 (warp per feature)",
                       lambda ids: sg.sparse_sampled_scores_lanes(small.values, small.rows, rb,
                                                                  blk, 1, ids),
                       lambda lane, bl: sg.sparse_sampled_scores(small.values, small.rows,
                                                                 rb[lane].clone(), bl, 1),
                       lambda ids: sg.sparse_sampled_scores_lanes_plain(
                           small.values, small.rows, rb, blk, 1, ids),
                       blk, 1, small.p, L, small.m * 40.0)
    beta, args = _lane_tail_state(torch, g, small.p, small.m, torch.bfloat16, L)
    _lane_tail_check(torch, st, "sparse bf16", (small.values, small.rows), beta, args, L,
                     FWConfig(delta=20.0))
    torch.cuda.synchronize()
    return errs


def phase3_batched_path(torch, design, y, coef, layout):
    """The example's default driver (``--driver batched``): the 100-point
    grid through ``fw_path_batched`` in lanes of 13, unfused, on 'kernels'
    (dense) or 'sparse'. Per batched step one launch each of the lane
    scores (K2 or K5), the lane argmax and the lane tail; K1 or K6 once a
    chunk; the fused chunks and the one-lane kernels never."""
    from repro_torch import kernels
    from repro_torch.core import LASSO, delta_grid, engine, fw_path_batched

    sparse = layout == "sparse"
    p = design.shape[0]
    cfg = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    delta_max = 0.5 * float(coef.abs().sum())
    deltas = delta_grid(delta_max, n_points=N_POINTS)
    tag = f"batched-{layout}"
    steps = [0]

    def count(state, active):
        steps[0] += 1

    def solve_counted(*args):
        return engine.solve_batched_prepared(*args, on_step=count)

    print(f"[{tag}] fw_path_batched backend={cfg.backend} lane_width={LANE_WIDTH} p={p:,} "
          f"kappa={cfg.kappa:,} sampling=uniform max_iters={cfg.max_iters} tol={cfg.tol} "
          f"points={N_POINTS} delta_max={delta_max:.6g}")
    kernels.reset_launch_counts()
    res = fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=LANE_WIDTH,
                          device=design.device, solve_batched_fn=solve_counted)
    launches = kernels.launch_counts()
    _print_points(tag, res, cfg)
    n_chunks = -(-N_POINTS // LANE_WIDTH)
    print(f"[{tag}] {res.total_seconds:.3f} s, {res.total_iters} lane-iterations of the "
          f"{N_POINTS} points, {steps[0]} batched steps in {n_chunks} chunks, saved_iters "
          f"{res.saved_iters}; {1e3 * res.total_seconds / max(res.total_iters, 1):.4f} ms per "
          f"lane-iteration, {1e3 * res.total_seconds / max(steps[0], 1):.4f} ms per batched step")
    print(f"[{tag}] launches during the path: {launches}")
    scores = "sparse_sampled_scores_lanes" if sparse else "sampled_scores_lanes"
    for name in (scores, "vertex_argmax_lanes", "step_tail_lanes"):
        check(launches[name] == steps[0], f"{tag}: {name} launches {launches[name]} != "
                                          f"batched steps {steps[0]}")
    colstats = "sparse_colstats" if sparse else "colstats"
    check(launches[colstats] == n_chunks, f"{tag}: {colstats} launches != chunks")
    for name in ("dense_fused_chunk", "sparse_fused_chunk", "fused_replay", "sampled_scores",
                 "sparse_sampled_scores", "vertex_argmax", "step_tail", "residual_update"):
        check(launches[name] == 0, f"{tag}: launched {name}")
    last = res.points[-1]
    alpha = _alpha_from_point(torch, last, p, design.device)
    gap = float(LASSO.gap(design, y, alpha, torch.tensor(last.reg, device=design.device)))
    print(f"[{tag}] densest point: objective {last.objective!r}, certified duality gap "
          f"{gap!r}")
    check(math.isfinite(gap) and gap >= -1e-4 * abs(last.objective), f"{tag}: certified gap")
    return launches, dict(res=res, steps=steps[0])


class LaneRecorder:
    """A lane sampler that hands on another's draws and keeps, for each lane,
    the rows it drew while active (the stream a sequential replay takes)."""

    def __init__(self, inner, lanes):
        self.inner = inner
        self.rows = [[] for _ in range(lanes)]

    def uniform_lanes(self, kappa, p, active):
        rows = self.inner.uniform_lanes(kappa, p, active)
        for lane, a in enumerate(active):
            if a:
                self.rows[lane].append(rows[lane])
        return rows


def phase4_lanes_vs_sequential(torch, dev):
    """One chunk of 4 lanes at p = 200,000, m = 800, kappa = 1% of p and 400
    steps on both layouts, unfused and with fuse_steps = 8, the first lane's
    delta small enough that it freezes early: each lane's alpha bits,
    iterations, n_dots and vertex sequence equal a sequential solve
    replaying the rows that lane drew (with fuse_steps = 8, the sequential
    chunk of K unfused steps, run_loop's per_step route)."""
    from repro_torch.core import LASSO, FWConfig, LaneSampler, StreamSampler, engine
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.data import make_sparse_wide_problem, make_wide_problem

    kappa = kappa_fraction(P_LANES, 0.01)
    for layout in ("dense", "sparse"):
        if layout == "dense":
            X, y, coef = make_wide_problem(P_LANES, M_PAPER, N_REL, seed=1, device=dev)
        else:
            X, y, coef = make_sparse_wide_problem(M_PAPER, P_LANES, 0.02, N_REL, seed=1,
                                                  device=dev, block_size=SPARSE_BLOCK)
        delta_max = 0.5 * float(coef.abs().sum())
        deltas = [delta_max / 1000, delta_max / 30, delta_max / 3, delta_max]
        for fuse in (1, FUSE):
            cfg = FWConfig(delta=1.0, kappa=kappa, max_iters=400, tol=1e-3, fuse_steps=fuse,
                           backend="sparse" if layout == "sparse" else "kernels")
            rec = LaneRecorder(LaneSampler(4, len(deltas), dev), len(deltas))
            trace = []
            res, saved = engine.solve_batched(
                LASSO, X, y, cfg, rec, None, deltas, device=dev,
                on_step=lambda state, active: trace.append((state.i_star.clone(), active)))
            iters = res.iterations
            check(min(iters) < max(iters) and saved > 0,
                  f"lanes {layout} fuse={fuse}: no lane froze early ({iters})")
            for lane, d in enumerate(deltas):
                seq = []
                one = engine.solve(LASSO, X, y, cfg, StreamSampler(torch.stack(rec.rows[lane])),
                                   None, d, device=dev, per_step=lambda s: seq.append(s.i_star))
                lane_seq = torch.stack([i[lane] for i, act in trace if act[lane]]).cpu()
                check(one.iterations == iters[lane] and one.n_dots == res.n_dots[lane],
                      f"lanes {layout} fuse={fuse} lane {lane}: iterations/n_dots")
                check(torch.equal(torch.stack(seq).cpu(), lane_seq),
                      f"lanes {layout} fuse={fuse} lane {lane}: vertex sequences differ")
                check(_same_bits(torch, one.alpha, res.alpha[lane]),
                      f"lanes {layout} fuse={fuse} lane {lane}: alpha bits differ")
            print(f"[lanes] {layout} fuse_steps={fuse}: 4 lanes, iterations {iters}, saved "
                  f"{saved}: each lane's alpha bits, iterations, n_dots and vertex sequence "
                  "equal its sequential replay")
        del X, y, coef
        torch.cuda.empty_cache()


def _batched_run(torch, design, y, stats, cfg, L, n_steps, seed):
    from repro_torch.core import LASSO, LaneSampler, engine

    states0 = engine.stack_states([engine.init_state(LASSO, design, y, None, cfg)
                                   for _ in range(L)])
    deltas = torch.full((L,), 50.0, device=design.device)
    bcfg = dataclasses.replace(cfg, max_iters=n_steps, tol=0.0, patience=10**9)
    return lambda: engine.batched_loop(LASSO, design, y, stats, states0, bcfg, deltas, 10**9,
                                       LaneSampler(seed, L, design.device))


def batched_step_ms(torch, design, y, stats, cfg, L, n_steps=200):
    """The batched step's host-clock ms (a fixed run of ``n_steps`` batched
    steps of L lanes after a warm-up, each run ending in a device sync) and
    its device busy ms per step (``torch.profiler`` over 50 more)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for seed in (3, 5):
        run = _batched_run(torch, design, y, stats, cfg, L, n_steps, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_steps
    run = _batched_run(torch, design, y, stats, cfg, L, 50, 9)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in rows)
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 50:.2f} us"
                    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:5])
    return wall, (total_us / 1e3 / 50 if total_us > 0 else None), top


def phase5_lane_timing(torch, design, y, layout):
    """The lane kernels at L = 13 (CUDA events, queued back to back) beside
    their bounds, plain versions and library yardsticks, and the batched
    step's wall and device ms and idle share at 13 lanes and at 1."""
    from repro_torch.core import FWConfig, LaneSampler, engine
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg
    from repro_torch.kernels import step_tail as st

    sparse = layout == "sparse"
    p, m = design.shape[0], design.shape[1]
    cfg = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    kappa, L, dev = cfg.kappa, LANE_WIDTH, design.device
    out = {}

    def row(name, ms, plain_ms, library_ms, nbytes, flops, note=""):
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        lib = "null" if library_ms is None else f"{library_ms:.6f} ms"
        print(f"[timing] {name} ({layout}, L={L}): {ms:.6f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}, {100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.6f} ms, "
              f"library {lib}{note}")

    sampler = LaneSampler(13, L, dev)
    every = [True] * L
    ids = torch.arange(L, dtype=torch.int32, device=dev)
    draws = [sampler.uniform_lanes(kappa, p, every) for _ in range(4)]  # 4 x L x kappa rows
    r = y.float().expand(L, m).contiguous()
    if sparse:
        vals, rows = design.values, design.rows
        nnz = design.nnz_max
        slots = vals.view(-1, nnz)
        nz = sum(int(torch.count_nonzero(slots[d.reshape(-1)])) for d in draws) / len(draws)
        row("sparse_sampled_scores_lanes",
            _time_queued(torch, lambda i: sg.sparse_sampled_scores_lanes(
                vals, rows, r, draws[i % 4], 1, ids), 100),
            _time_queued(torch, lambda i: sg.sparse_sampled_scores_lanes_plain(
                vals, rows, r, draws[i % 4], 1, ids), 5),
            None, L * (kappa * nnz * 4 + kappa * 4 + kappa * 8 + m * 4) + nz * 4, 2 * nz,
            note=f" [width 1, kappa={kappa}, {nz:.0f} stored nonzeros in the {L} lanes' "
                 "features; library: none]")
        scores = sg.sparse_sampled_scores_lanes(vals, rows, r, draws[0], 1, ids)
        mat = (vals, rows)
        tail_bytes = L * (3 * m * 4 + nnz * 8 + 64)
    else:
        row("sampled_scores_lanes",
            _time_queued(torch, lambda i: fw.sampled_scores_lanes(design, r, draws[i % 4], 1,
                                                                  ids), 40),
            _time_queued(torch, lambda i: fw.sampled_scores_lanes_plain(design, r, draws[i % 4],
                                                                        1, ids), 5),
            _time_queued(torch, lambda i: torch.bmm(
                design.index_select(0, draws[i % 4].view(-1)).view(L, kappa, m),
                r.view(L, m, 1)), 5),
            L * (kappa * m * 4 + m * 4 + kappa * 12), 2 * L * kappa * m,
            note=f" [kappa={kappa}, m={m}; library: torch.bmm on Xt.index_select]")
        scores = fw.sampled_scores_lanes(design, r, draws[0], 1, ids)
        mat = design
        tail_bytes = L * (4 * m * 4 + 64)
    row("vertex_argmax_lanes" if not sparse else "vertex_argmax_lanes_sparse",
        _time_queued(torch, lambda i: fw.vertex_argmax_lanes(scores, draws[0], 1, p, ids), 400),
        _time_queued(torch, lambda i: fw.argmax_lanes_plain(scores, draws[0], 1, p, ids), 5),
        None, L * (kappa * 4 + kappa * 8 + 12), 3 * L * kappa,
        note=f" [n = kappa = {kappa} a lane; library: none]")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    beta, args = _lane_tail_state(torch, g, p, m, torch.float32, L)
    args = (torch.full((L,), 0.9, device=dev),) + args[1:]  # no renorm
    tcfg = FWConfig(delta=20.0)
    row("step_tail_lanes" if not sparse else "step_tail_lanes_sparse",
        _time_queued(torch, lambda i: st.step_tail_lanes(mat, beta, *args, ids, tcfg), 400),
        # ~75 launches a lane: one call of 13 lanes fills the launch queue
        _time_queued(torch, lambda i: st.step_tail_lanes_plain(mat, beta, *args, ids, tcfg), 1),
        None, tail_bytes, L * 5 * m, note=f" [m={m}, no renorm; library: none]")
    del beta, args

    stats = engine.precompute_colstats(design, y, cfg)
    for lanes in (L, 1):
        wall, busy, top = batched_step_ms(torch, design, y, stats, cfg, lanes)
        busy_txt = ("device busy not measured (the profiler reported no device time)"
                    if busy is None else
                    f"device busy {busy:.4f} ms ({top}), idle {100 * (1 - busy / wall):.1f}%")
        print(f"[timing] batched step ({layout}, {lanes} lanes): wall {wall:.4f} ms, "
              f"{wall / lanes:.4f} ms per lane-iteration; {busy_txt}")
    return out


def history_check(torch, dev):
    """solve_with_history on a small problem on the card (p = 2,000, m =
    100, 200 steps), unfused and with fuse_steps = 8: the history is the
    objective a per-step hook sees in the same run, bit for bit."""
    from repro_torch.core import LASSO, FWConfig, TorchSampler, engine
    from repro_torch.data import make_wide_problem

    X, y, coef = make_wide_problem(2000, 100, 20, seed=2, device=dev)
    stats = engine.precompute_colstats(X, y, FWConfig(delta=1.0, backend="kernels"))
    for fuse in (1, FUSE):
        cfg = FWConfig(delta=0.5 * float(coef.abs().sum()), kappa=50, backend="kernels",
                       fuse_steps=fuse)
        res, hist = engine.solve_with_history(LASSO, X, y, cfg, TorchSampler(1, dev), 200,
                                              device=dev)
        seen = []
        hcfg = dataclasses.replace(cfg, max_iters=200, patience=engine.history_patience(200))
        engine.solve(LASSO, X, y, hcfg, TorchSampler(1, dev), device=dev,
                     per_step=lambda s: seen.append(LASSO.objective(y, stats, s.co)))
        check(hist.shape == (200,) and res.iterations == 200, "history: length")
        check(_same_bits(torch, hist, torch.stack(seen)), f"history fuse={fuse}: differs from "
                                                           "the per-step objectives")
        print(f"[history] solve_with_history p=2000 m=100 fuse_steps={fuse}: 200 values, "
              f"{float(hist[0])!r} -> {float(hist[-1])!r}, bit for bit the per-step objectives")


# --------------------------------------------------------------------------
# the extension oracles (paper §6): the elastic-net's kernel instantiations
# in phase 2, the elastic-net and logistic paths at full width in phase 3,
# their routes against each other in phase 4, their kernels' and steps'
# times in phase 5
# --------------------------------------------------------------------------

# the reference's family section (benchmarks/table5_fw.py:174-230):
# ENOracle(l2=1.0) and the logistic labels sign(y) + (y == 0) on the same
# data, kappa = 1% of p, the lasso path's delta_max; the logistic solves
# with max_iters 2000 and tol 1e-4, and its sparse path runs max(4, 40 // 4)
# = 10 points, sequential and in lanes of 4
EN_L2 = 1.0
EN_UNFUSED = 3  # the EN path's first points, also one step per dispatch
LEDGER_K = 72  # phase 2's long EN chunk, a ledger of 72 slots
LOG_MAX_ITERS, LOG_TOL = 2000, 1e-4
LOG_POINTS, LOG_LANES, LOG_POINTS_DENSE = 10, 4, 3
N_EXT_COMPARE = 2  # points of each extension path held against the plain route
EN_KERNELS = ("vertex_argmax_shifted", "vertex_argmax_shifted_lanes", "step_tail_en",
              "step_tail_en_lanes", "dense_fused_chunk_en", "sparse_fused_chunk_en")
EN_OUT = TAIL_OUT + ("Q",)


def logistic_labels(torch, y):
    """The reference family's logistic labels: sign(y), 0 made +1."""
    return torch.sign(y) + (y == 0).to(y.dtype)


def _check_shifted(torch, fw, label, scores, blk, bs, p, shift):
    """K2's shifted argmax against its plain version: (i_star, g_raw, g_sel)
    bit for bit, two launches equal, one launch a call, a real index."""
    before = fw.vertex_argmax_shifted.launches
    got = fw.vertex_argmax_shifted(scores, blk, bs, p, shift)
    again = fw.vertex_argmax_shifted(scores, blk, bs, p, shift)
    want = fw.argmax_shifted_plain(scores, blk, bs, p, shift)
    check(fw.vertex_argmax_shifted.launches == before + 2, f"shifted argmax {label}: launches")
    check(all(_same_bits(torch, a, b) for a, b in zip(got, again)),
          f"shifted argmax {label}: two launches differ")
    check(all(_same_bits(torch, a, b) for a, b in zip(got, want)),
          f"shifted argmax {label}: differs from its plain version")
    check(int(got[0]) < p, f"shifted argmax {label}: a padded index won")
    print(f"[en] vertex_argmax_shifted {label}: i_star {int(got[0])}, g_raw {float(got[1])!r}, "
          f"g_sel {float(got[2])!r}: bit-exact with the plain version, two launches equal")
    return got


def shifted_argmax_cases(torch, fw, scores, idx, p, g):
    """The shifted argmax at the path's shapes (n = kappa, width 1; beta
    with 300 nonzero coefficients, f32 and bf16) and at n = p (blocks of
    128, as 'full' sampling reads it), and its edge cases: a shift that
    turns the winner; raw scores all zero with a nonzero shift; a padded
    index (past p, in the last block) whose shifted score would win."""
    dev = scores.device
    beta = torch.zeros(p, device=dev)
    beta[idx[:300]] = torch.randn(idx[:300].numel(), generator=g, device=dev) * 5
    scale = torch.tensor(0.8, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        _check_shifted(torch, fw, f"n=kappa={idx.numel()} beta {str(dtype)[6:]}", scores, idx,
                       1, p, fw.ScoreShift(beta.to(dtype), scale.to(dtype), EN_L2))
    shift = fw.ScoreShift(beta, scale, EN_L2)
    blk = torch.arange(-(-p // 128), device=dev)
    full = torch.randn(blk.numel() * 128, generator=g, device=dev)
    _check_shifted(torch, fw, f"n=p={full.numel()} ('full', blocks of 128)", full, blk, 128, p,
                   shift)
    turned = torch.full_like(scores, 0.1)
    turned[3] = 1.0  # the raw winner, at position 3
    j = min(600, idx.numel() - 1)
    b2 = torch.zeros_like(beta)
    b2[idx[j]] = 10.0  # the shift of position j turns it
    got = _check_shifted(torch, fw, "a shift that turns the winner", turned, idx, 1, p,
                         fw.ScoreShift(b2, scale, EN_L2))
    check(int(got[0]) == int(idx[j]), "shifted argmax: the shift did not turn the winner")
    _check_shifted(torch, fw, "raw scores all zero", torch.zeros_like(scores), idx, 1, p, shift)
    last = blk[-1:]  # the last block of 128 holds indices past p
    pad = torch.randn(128, generator=g, device=dev) * 0.01
    pad[127] = 100.0  # index 128 * nblocks - 1 >= p
    b3 = beta.clone()
    b3[p - 1] = 1e3  # its clipped shift is the largest too
    _check_shifted(torch, fw, "a padded index whose shifted score would win", pad, last, 128, p,
                   fw.ScoreShift(b3, scale, EN_L2))


def shifted_lanes_check(torch, fw, label, scores_fn, blk, p, g, L):
    """K2's lane argmax with the shift, for each set of running lanes:
    bitwise its plain version, each running lane bitwise its one-lane
    shifted launch, a frozen lane (-1, 0, 0)."""
    dev = blk.device
    shift = fw.ScoreShift(torch.randn((L, p), generator=g, device=dev),
                          torch.rand(L, generator=g, device=dev) + 0.5, EN_L2)
    for run in _lane_sets(L):
        ids = torch.tensor(run, dtype=torch.int32, device=dev)
        scores = scores_fn(ids)
        got = fw.vertex_argmax_shifted_lanes(scores, blk, 1, p, ids, shift)
        want = fw.argmax_shifted_lanes_plain(scores, blk, 1, p, ids, shift)
        check(all(_same_bits(torch, a, b) for a, b in zip(got, want)),
              f"{label} L={L} lanes {run}: differs from its plain version")
        for lane in range(L):
            if lane not in run:
                check(int(got[0][lane]) == -1 and float(got[2][lane]) == 0.0,
                      f"{label}: frozen lane {lane}")
                continue
            one = fw.vertex_argmax_shifted(scores[lane].contiguous(), fw.lane_blk(blk, lane), 1,
                                           p, shift.lane(lane))
            check(all(_same_bits(torch, a[lane], b) for a, b in zip(got, one)),
                  f"{label} L={L}: lane {lane} differs from a one-lane launch")
    print(f"[en] {label} L={L}: bit for bit its plain version and each lane's one-lane launch, "
          "frozen lanes (-1, 0, 0)")


def _check_en_tail(torch, st, label, mat, beta, args, en, cfg):
    """The EN tail against ``step_tail_plain`` with ``en``: every output bit
    for bit (Q included), two launches equal, one launch a call."""
    before = st.step_tail_en.launches
    out_k = st.step_tail_en(mat, beta.clone(), *args, cfg, en=en)
    again = st.step_tail_en(mat, beta.clone(), *args, cfg, en=en)
    out_p = st.step_tail_plain(mat, beta.clone(), *args, cfg, en=en)
    check(st.step_tail_en.launches == before + 2, f"step_tail_en {label}: launches")
    check(all(_same_bits(torch, a, b) for a, b in zip(out_k, again)),
          f"step_tail_en {label}: two launches differ")
    differ = [n for n, a, b in zip(EN_OUT, out_k, out_p) if not _same_bits(torch, a, b)]
    check(not differ, f"step_tail_en {label}: {differ} differ from the plain version")
    print(f"[en] step_tail_en {label}: scale {float(out_k[1])!r}, stall {int(out_k[4])}, "
          f"Q {float(out_k[8])!r}: bit-exact with the plain version, two launches equal")
    return out_k


def en_tail_cases(torch, st, label, mat, p, m, dtype, g, i_star):
    """The EN tail on one layout and dtype: a random state, a renorm step,
    lam clamped at 1 and the same coordinate twice in a row."""
    from repro_torch.core import FWConfig

    cfg = FWConfig(delta=5.0)
    lab = f"{label} {str(dtype)[6:]}"

    def en_for(args, g_sel=-3.25):
        return st.ENTail(torch.tensor(g_sel, device=g.device),
                         torch.tensor(40.0, device=g.device).to(dtype), EN_L2)

    beta, args = _tail_args(torch, g, p, m, dtype, i_star)
    out = _check_en_tail(torch, st, f"{lab} random", mat, beta, args, en_for(args), cfg)
    b, scale, maxabs, _, stall, resid, s_quad, f_lin, q = out
    _check_en_tail(torch, st, f"{lab} the same coordinate again", mat, b,
                   (scale, maxabs, stall, resid, s_quad, f_lin) + args[6:],
                   st.ENTail(torch.tensor(-2.0, device=g.device), q, EN_L2), cfg)
    beta, args = _tail_args(torch, g, p, m, dtype, i_star, scale=1.2e-6)
    out = _check_en_tail(torch, st, f"{lab} renorm", mat, beta, args, en_for(args), cfg)
    check(float(out[1]) == 1.0, f"step_tail_en {lab}: no renorm")
    beta, args = _tail_args(torch, g, p, m, dtype, i_star, s_quad=0.0, f_lin=0.0, zty_i=7.5,
                            zn2_i=1e-3)
    _check_en_tail(torch, st, f"{lab} lam near 1", mat, beta, args, en_for(args, -7.5), cfg)


def en_tail_lanes_check(torch, st, label, mat, beta, args, L, cfg):
    """The EN lane tail for each set of running lanes: bit for bit its plain
    version, each running lane bitwise its one-lane EN launch, frozen lanes
    keep their outputs (Q included)."""
    dev = beta.device
    scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, zty, zn2, i_star, gs, delta = args
    en = st.ENTail(gs + 0.5, torch.full((L,), 40.0, device=dev), EN_L2)
    for run in _lane_sets(L):
        ids = torch.tensor(run, dtype=torch.int32, device=dev)
        b_k, b_p = beta.clone(), beta.clone()
        before = st.step_tail_en_lanes.launches
        got = st.step_tail_en_lanes(mat, b_k, *args, ids, cfg, en=en)
        want = st.step_tail_lanes_plain(mat, b_p, *args, ids, cfg, en=en)
        check(st.step_tail_en_lanes.launches == before + 1, f"step_tail_en_lanes {label}: launches")
        differ = [n for n, a, b in zip(EN_OUT, got, want) if not _same_bits(torch, a, b)]
        check(not differ, f"step_tail_en_lanes {label} L={L} lanes {run}: {differ} differ from "
                          "the plain version")
        for lane in range(L):
            if lane not in run:
                check(_same_bits(torch, got[8][lane], en.q_norm[lane]), f"{label}: frozen Q")
                continue
            b1 = beta[lane].clone()
            one = st.step_tail_en(mat, b1, scale[lane].clone(), maxabs[lane].clone(),
                                  stall[lane].clone(), resid[lane].clone(), s_quad[lane].clone(),
                                  f_lin[lane].clone(), y, zty, zn2, i_star[lane].clone(),
                                  gs[lane].clone(), delta[lane].clone(), cfg,
                                  en=st.ENTail(en.g_sel[lane].clone(), en.q_norm[lane].clone(),
                                               EN_L2))
            check(_same_bits(torch, b_k[lane], b1) and all(
                _same_bits(torch, out[lane], o) for out, o in zip(got[1:], one[1:])),
                f"step_tail_en_lanes {label} L={L}: lane {lane} differs from a one-lane launch")
    print(f"[en] step_tail_en_lanes {label} L={L}: bit for bit its plain version and each lane's "
          "one-lane launch, frozen lanes untouched")


def _en_sel_at(torch, raw, ids, alpha_t, recs, t, l2):
    """The plain chunk's selected scores at step t, from its records of the
    steps before (the alpha ledger: P = prod(1 - lam), slot s = lam_s dt_s
    rescaled by every later step)."""
    i_stars, lams, dts = (r[:t].double().cpu() for r in recs)
    P, slots = 1.0, []
    for s in range(t):
        one_m = 1.0 - float(lams[s])
        P *= one_m
        slots = [(i, c * one_m) for i, c in slots] + [(int(i_stars[s]), float(lams[s] * dts[s]))]
    a = P * alpha_t.double().cpu()
    for i, c in slots:
        a = a + c * (ids.cpu() == i).double()
    return raw.double().cpu() + l2 * a


def _check_en_chunk(torch, fs, label, mat, y, idx, alpha_s, k0, delta, kw, q0=0.7):
    """K4 or K7 with the alpha ledger against the plain chunk from the same
    chunk start: two launches bitwise equal; i_star and no_progress equal
    up to the first step whose plain selected scores' top-2 are a near-tie;
    up to there lam and delta_t within RTOL_SUM; with no step apart, the
    residual within RTOL_SUM of ||y|| and (S, F, Q) within RTOL_SUM of
    their scale. Returns the largest abs error and the kernel's i_star."""
    from repro_torch.core import ENOracle

    dev = y.device
    scal = tuple(torch.tensor(v, device=dev) for v in (3.0, 1.5, q0))
    if _is_sparse(mat):
        from repro_torch.kernels.sparse_colstats import sparse_colstats_plain

        name, head, kernel, plain = ("sparse_fused_chunk_en", (mat.values, mat.rows),
                                     fs.sparse_fused_chunk_en, fs.sparse_fused_chunk_plain)
        zty, zn2 = sparse_colstats_plain(mat.values, mat.rows, y, mat.p)
    else:
        name, head, kernel, plain = ("dense_fused_chunk_en", (mat,), fs.dense_fused_chunk_en,
                                     fs.dense_fused_chunk_plain)
        zty, zn2 = mat @ y, (mat * mat).sum(dim=1)
    kw = dict(kw, oracle=ENOracle(l2=EN_L2), alpha_s=alpha_s)
    tail = (y, y, scal, idx, zty[idx], zn2[idx], k0, delta)
    before = kernel.launches
    got = kernel(*head, *tail, **kw)
    again = kernel(*head, *tail, **kw)
    check(kernel.launches == before + 2, f"{name} {label}: launches")
    check(all(torch.equal(a, b) for a, b in zip(got[:5] + got[5], again[:5] + again[5])),
          f"{name} {label}: two launches differ")
    want = plain(*head, *tail, **kw)
    i_k, i_p = got[0].cpu(), want[0].cpu()
    diff = (i_k != i_p).nonzero().view(-1)
    K = idx.shape[0]
    t = int(diff[0]) if diff.numel() else K
    if t < K:
        r_t = plain(*head, y, y, scal, idx[:t], zty[idx[:t]], zn2[idx[:t]], k0, delta,
                    **dict(kw, alpha_s=alpha_s[:t]))[4] if t else y
        sel = _en_sel_at(torch, _scores(torch, mat, idx[t], r_t), idx[t], alpha_s[t],
                         (want[0], want[1], want[2]), t, EN_L2)
        scale = float(torch.linalg.vector_norm(r_t)) * float(zn2.max().sqrt())
        margin = _top2_margin(torch, sel.abs().float(), idx[t].cpu())
        check(margin <= RTOL_SUM * scale, f"{name} {label}: i_star {int(i_k[t])} != plain "
              f"{int(i_p[t])} at step {t}, top-2 margin {margin:.3e}: no near-tie")
    check(torch.equal(got[3][:t].cpu(), want[3][:t].cpu()), f"{name} {label}: no_progress")
    e_lam = float((got[1][:t] - want[1][:t]).abs().max()) if t else 0.0
    e_dt = float((got[2][:t] - want[2][:t]).abs().max()) if t else 0.0
    check(e_lam <= RTOL_SUM and e_dt <= RTOL_SUM * float(delta),
          f"{name} {label}: lam err {e_lam:.2e}, delta_t err {e_dt:.2e}")
    errs = [e_lam, e_dt]
    note = f"step {t} differs at a near-tie" if t < K else "all steps equal"
    if t == K:
        e_r, a_r = _scaled_err(torch, got[4], want[4], float(torch.linalg.vector_norm(y)))
        sfq_scale = sum(abs(float(x)) for x in want[5]) + float(torch.dot(y, y))
        e_sfq = max(abs(float(a) - float(b)) for a, b in zip(got[5], want[5]))
        check(e_r <= RTOL_SUM and e_sfq <= RTOL_SUM * sfq_scale,
              f"{name} {label}: residual err {e_r:.2e}, S/F/Q err {e_sfq:.3e}")
        errs += [a_r, e_sfq]
        note += f", residual err {e_r:.2e} of ||y||, S/F/Q err {e_sfq / sfq_scale:.2e} of scale"
    i_list = i_k.tolist()
    shown = i_list if len(i_list) <= 8 else i_list[:8] + ["..."]
    print(f"[en] {name} {label}: i_star {shown}, {note}, lam err {e_lam:.2e}, two launches "
          "bitwise equal")
    return max(errs), i_k


def phase2_en_kernels(torch, design, y, layout):
    """The elastic-net's instantiations on the card against their plain
    versions, at the path's shapes (kappa = 1% of p; m = 800 dense, 16,087
    sparse) and at edge cases: the shifted argmax (one lane, and 1, 3, 13
    lanes each bitwise its one-lane launch), bit for bit; the EN tail in
    f32 and bf16 (a renorm, lam near 1, the same coordinate twice), one lane
    and 13, bit for bit; K4 or K7 with the ledger against the plain chunk at
    K = 8, at a chunk where one coordinate wins twice and at K = LEDGER_K,
    two launches bitwise equal."""
    from repro_torch.core import FWConfig
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg
    from repro_torch.kernels import step_tail as st

    sparse = layout == "sparse"
    dev = design.device
    p, m = design.shape[0], design.shape[1]
    kappa = kappa_fraction(p, 0.01)
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    idx = TorchSampler(31, dev).uniform(kappa, p)
    r = y.float()
    if sparse:
        scores = sg.sparse_sampled_scores(design.values, design.rows, r, idx, 1)
    else:
        scores = fw.sampled_scores(design, r, idx, 1)
    shifted_argmax_cases(torch, fw, scores, idx, p, g)
    for L in LANE_COUNTS:
        rl = torch.randn((L, m), generator=g, device=dev)
        blk = torch.randint(0, p, (L, kappa), generator=g, device=dev)
        if sparse:
            scores_fn = lambda ids: sg.sparse_sampled_scores_lanes(  # noqa: E731
                design.values, design.rows, rl, blk, 1, ids)
        else:
            scores_fn = lambda ids: fw.sampled_scores_lanes(design, rl, blk, 1, ids)  # noqa: E731
        shifted_lanes_check(torch, fw, f"vertex_argmax_shifted_lanes {layout} kappa={kappa}",
                            scores_fn, blk, p, g, L)

    # ---- the EN tail: the path's layout in f32, a small one in bf16 -------
    win = int(idx[0])
    mat = (design.values, design.rows) if sparse else design
    en_tail_cases(torch, st, f"{layout} p={p} m={m}", mat, p, m, torch.float32, g, win)
    if sparse:
        vals, rows = _tail_ell(torch, g, 5000, m, 66, torch.bfloat16, 7, [3, 0, m - 7, 11])
        en_tail_cases(torch, st, f"sparse p=5000 m={m}", (vals, rows), 5000, m, torch.bfloat16,
                      g, 7)
    else:
        Xb = torch.randn((5000, m), generator=g, device=dev).to(torch.bfloat16)
        en_tail_cases(torch, st, f"dense p=5000 m={m}", Xb, 5000, m, torch.bfloat16, g, 7)
    beta, args = _lane_tail_state(torch, g, p, m, torch.float32, LANE_WIDTH)
    en_tail_lanes_check(torch, st, f"{layout} p={p} m={m}", mat, beta, args, LANE_WIDTH,
                        FWConfig(delta=20.0))
    del beta, args

    # ---- K4 / K7 with the alpha ledger ------------------------------------
    delta = torch.tensor(50.0, device=dev)
    chunk_idx = TorchSampler(37, dev).uniform_chunk(FUSE, kappa, p)
    alpha_s = torch.randn((FUSE, kappa), generator=g, device=dev) * 0.05
    err, _ = _check_en_chunk(torch, fs, f"main K={FUSE} kappa={kappa} m={m}", design, y,
                             chunk_idx, alpha_s, 0, delta, _fused_kw(10**6))
    rep = chunk_idx.clone()
    star = int(rep[0, 0])
    rep[[0, 2]] = star  # one coordinate alone in steps 0 and 2, first in the others
    rep[:, 0] = star
    alpha_r = alpha_s.clone()
    alpha_r[:, 0] = 0.02
    alpha_r[[0, 2]] = 0.02
    err2, i_k = _check_en_chunk(torch, fs, "one coordinate wins in steps 0 and 2", design, y,
                                rep, alpha_r, 60, delta, _fused_kw(10**6))
    check(int((i_k == star).sum()) >= 2, "EN chunk: the repeated coordinate won once")
    # a long chunk: its ledger's LEDGER_K slots sized from K in dynamic shared memory
    long_idx = TorchSampler(41, dev).uniform_chunk(LEDGER_K, kappa, p)
    alpha_l = torch.randn((LEDGER_K, kappa), generator=g, device=dev) * 0.05
    err3, _ = _check_en_chunk(torch, fs, f"K={LEDGER_K}, {fs.ledger_bytes(LEDGER_K)} ledger "
                              "bytes", design, y, long_idx, alpha_l, 0, delta,
                              _fused_kw(10**6))
    name = "sparse_fused_chunk_en" if sparse else "dense_fused_chunk_en"
    torch.cuda.synchronize()
    return {name: max(err, err2, err3), "vertex_argmax_shifted": 0.0,
            "vertex_argmax_shifted_lanes": 0.0, "step_tail_en": 0.0, "step_tail_en_lanes": 0.0}


class StarRecorder:
    """``fw_path`` step hook keeping, for the first grid points, each step's
    vertex (a device tensor: no sync)."""

    def __init__(self, n_points):
        self.n_points = n_points
        self.i_star = [[] for _ in range(n_points)]

    def __call__(self, g, state):
        if g < self.n_points:
            self.i_star[g].append(state.i_star)

    sequence = Recorder.sequence


def _ext_gap(torch, oracle, design, y, pt):
    """The certified duality gap of a path point, with the oracle's own
    gradient (``oracle.gap``: one full pass)."""
    alpha = _alpha_from_point(torch, pt, design.shape[0], design.device)
    return float(oracle.gap(design, y, alpha, torch.tensor(pt.reg, device=design.device)))


def _check_launches(tag, launches, equal, zero):
    for names, n in equal:
        for name in names:
            check(launches[name] == n, f"{tag}: {name} launches {launches[name]} != {n}")
    for name in zero:
        check(launches[name] == 0, f"{tag}: launched {name} {launches[name]} times")


def _ext_path(torch, tag, design, y, deltas, cfg, oracle, n_rec, batched=0):
    """One path through ``fw_path`` (or, with ``batched`` lanes,
    ``fw_path_batched``), its points printed and checked, the launches
    counted; returns (launches, run). The densest point's certified gap,
    with the oracle's own gradient, must be finite."""
    from repro_torch import kernels
    from repro_torch.core import engine, fw_path, fw_path_batched

    rec = StarRecorder(n_rec)
    steps = [0]

    def count(state, active):
        steps[0] += 1

    kernels.reset_launch_counts()
    if batched:
        res = fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=batched, oracle=oracle,
                              device=design.device, solve_batched_fn=lambda *a: (
                                  engine.solve_batched_prepared(*a, on_step=count)))
    else:
        res = fw_path(design, y, deltas, cfg, seed=0, oracle=oracle, device=design.device,
                      on_step=rec)
    launches = kernels.launch_counts()
    _print_points(tag, res, cfg, oracle.extra_dots)
    extra = f", {steps[0]} batched steps, saved_iters {res.saved_iters}" if batched else ""
    print(f"[{tag}] {res.total_seconds:.3f} s for {len(res.points)} points{extra}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    gap = _ext_gap(torch, oracle, design, y, res.points[-1])
    print(f"[{tag}] densest point: objective {res.points[-1].objective!r}, certified duality "
          f"gap {gap!r}")
    check(math.isfinite(gap) and gap >= -1e-4 * max(abs(res.points[-1].objective), 1.0),
          f"{tag}: certified gap")
    return launches, dict(res=res, rec=rec, cfg=cfg, deltas=deltas, steps=steps[0],
                          label=tag)


def phase3_en_paths(torch, design, y, coef, layout):
    """The elastic-net path (ENOracle(l2=1.0)) at full width over the lasso
    path's 100-point grid: fused at K = 8 (K4 or K7 with the ledger and the
    replay once a chunk; K1 or K6 once a point), its first 3 points one step
    per dispatch (the scores, the shifted argmax and the EN tail once a
    step), and through ``fw_path_batched`` in lanes of 13 (the lane scores,
    the shifted lane argmax and the EN lane tail once a batched step)."""
    from repro_torch.core import ENOracle, delta_grid

    sparse = layout == "sparse"
    p = design.shape[0]
    oracle = ENOracle(l2=EN_L2)
    fused_cfg = sparse_config(p) if sparse else main_config(p, "kernels", FUSE)
    cfg1 = dataclasses.replace(fused_cfg, fuse_steps=1)
    deltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=N_POINTS)
    print(f"[en-{layout}] ENOracle(l2={EN_L2}) p={p:,} kappa={fused_cfg.kappa:,} "
          f"max_iters={fused_cfg.max_iters} tol={fused_cfg.tol} points={N_POINTS} "
          f"delta_max={deltas[-1]:.6g}")
    colstats = "sparse_colstats" if sparse else "colstats"
    scores = "sparse_sampled_scores" if sparse else "sampled_scores"
    chunk = "sparse_fused_chunk_en" if sparse else "dense_fused_chunk_en"
    lasso_only = ("dense_fused_chunk", "sparse_fused_chunk", "vertex_argmax", "step_tail",
                  "vertex_argmax_lanes", "step_tail_lanes", "residual_update")
    out = {}

    l_f, fused = _ext_path(torch, f"en-{layout}-fused", design, y, deltas, fused_cfg, oracle,
                           EN_UNFUSED)
    chunks = sum(-(-pt.iterations // FUSE) for pt in fused["res"].points)
    _check_launches(f"en-{layout}-fused", l_f, [((chunk, "fused_replay"), chunks),
                                               ((colstats,), N_POINTS)],
                    lasso_only + (scores, "vertex_argmax_shifted", "step_tail_en"))
    out[chunk] = l_f[chunk]

    l_1, unfused = _ext_path(torch, f"en-{layout}-unfused", design, y, deltas[:EN_UNFUSED],
                             cfg1, oracle, EN_UNFUSED)
    _check_launches(f"en-{layout}-unfused", l_1,
                    [((scores, "vertex_argmax_shifted", "step_tail_en"),
                      unfused["res"].total_iters), ((colstats,), EN_UNFUSED)],
                    lasso_only + (chunk, "fused_replay"))
    out["vertex_argmax_shifted"] = l_1["vertex_argmax_shifted"]
    out["step_tail_en"] = l_1["step_tail_en"]

    l_b, batched = _ext_path(torch, f"en-{layout}-batched", design, y, deltas, cfg1, oracle, 0,
                             batched=LANE_WIDTH)
    lane_scores = "sparse_sampled_scores_lanes" if sparse else "sampled_scores_lanes"
    _check_launches(f"en-{layout}-batched", l_b,
                    [((lane_scores, "vertex_argmax_shifted_lanes", "step_tail_en_lanes"),
                      batched["steps"]), ((colstats,), -(-N_POINTS // LANE_WIDTH))],
                    lasso_only + (chunk, scores, "vertex_argmax_shifted", "step_tail_en"))
    out["vertex_argmax_shifted_lanes"] = l_b["vertex_argmax_shifted_lanes"]
    out["step_tail_en_lanes"] = l_b["step_tail_en_lanes"]
    f, b = fused["res"], batched["res"]
    print(f"[en-{layout}] fused K={FUSE}: {f.total_seconds:.3f} s, {f.total_iters} iterations; "
          f"batched in lanes of {LANE_WIDTH}: {b.total_seconds:.3f} s, {b.total_iters} "
          f"lane-iterations; densest objectives {f.points[-1].objective!r} / "
          f"{b.points[-1].objective!r}")
    return out, dict(fused=fused, unfused=unfused, batched=batched, oracle=oracle)


def phase3_logistic_paths(torch, design, y, coef, layout):
    """The logistic path (labels sign(y) + (y == 0), max_iters 2000, tol
    1e-4) at full width over a 10-point grid to the lasso's delta_max: on
    the sparse layout all 10 points, sequential and in lanes of 4 (the
    reference family's batched logistic path); on the dense one its first
    3. Per step the scores (K2 or K5) and the lasso's argmax on the card,
    the bisection tail in plain PyTorch (no tail kernel, no column
    statistics)."""
    from repro_torch.core import LOGISTIC, delta_grid

    sparse = layout == "sparse"
    p = design.shape[0]
    yl = logistic_labels(torch, y)
    base = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    cfg = dataclasses.replace(base, max_iters=LOG_MAX_ITERS, tol=LOG_TOL)
    deltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=LOG_POINTS)
    deltas = deltas if sparse else deltas[:LOG_POINTS_DENSE]
    print(f"[log-{layout}] LOGISTIC p={p:,} kappa={cfg.kappa:,} max_iters={cfg.max_iters} "
          f"tol={cfg.tol} points={len(deltas)} of a {LOG_POINTS}-point grid to "
          f"{float(deltas[-1]):.6g}; labels +1 {int((yl > 0).sum())}, -1 {int((yl < 0).sum())}")
    scores = "sparse_sampled_scores" if sparse else "sampled_scores"
    never = ("colstats", "sparse_colstats", "step_tail", "step_tail_en", "step_tail_lanes",
             "step_tail_en_lanes", "dense_fused_chunk", "sparse_fused_chunk",
             "dense_fused_chunk_en", "sparse_fused_chunk_en", "fused_replay",
             "vertex_argmax_shifted", "vertex_argmax_shifted_lanes", "residual_update")
    l_s, seq = _ext_path(torch, f"log-{layout}", design, yl, deltas, cfg, LOGISTIC,
                         N_EXT_COMPARE)
    _check_launches(f"log-{layout}", l_s, [((scores, "vertex_argmax"), seq["res"].total_iters)],
                    never)
    runs = dict(seq=seq, y=yl)
    if sparse:
        l_b, bat = _ext_path(torch, f"log-{layout}-batched", design, yl, deltas, cfg, LOGISTIC,
                             0, batched=LOG_LANES)
        _check_launches(f"log-{layout}-batched", l_b,
                        [(("sparse_sampled_scores_lanes", "vertex_argmax_lanes"), bat["steps"])],
                        never + (scores, "vertex_argmax"))
        runs["batched"] = bat
    return runs


def _point_start(torch, design, deltas, run, g):
    """Point g's start in ``run``: its warm start (from the run's point g -
    1, scaled to delta_g; None at g = 0) and its sampler seed."""
    from repro_torch.core.path import point_seed

    a0 = None
    if g > 0:
        prev = run["res"].points[g - 1]
        a0 = _alpha_from_point(torch, prev, design.shape[0], design.device) * (
            float(deltas[g]) / prev.l1)
    return a0, point_seed(0, g)


def _replay_state(torch, oracle, design, y, cfg, deltas, run, g, t):
    """Run ``run``'s point g again up to its step t (its sampler seed, its
    warm start from its point g - 1, one step per dispatch): the state
    before step t, and the sampled indices of step t."""
    from repro_torch.core import engine
    from repro_torch.core.vertex import TorchSampler

    p, dev = design.shape[0], design.device
    a0, seed = _point_start(torch, design, deltas, run, g)
    state = [engine.init_state(oracle, design, y, a0, cfg)]
    if t:
        engine.solve_prepared(oracle, design, y, dataclasses.replace(
            cfg, max_iters=t, tol=0.0, patience=10**9), TorchSampler(seed, dev), a0,
            float(deltas[g]), on_step=lambda s: state.__setitem__(0, s))
    sampler = TorchSampler(seed, dev)
    for _ in range(t + 1):
        idx = sampler.uniform(cfg.kappa, p)
    return state[0], idx


# a step's stall test, as a row of its trace: the sampled gap num, its
# gap_scale, Q before the step, the gap flag num <= gap_rtol * gap_scale,
# the stall flag (the step's stall counter > 0: the gap flag or step_inf <=
# tol) and step_inf
STALL_COLS = ("num", "gap_scale", "Q", "gap_flag", "stall_flag", "step_inf")


def _stall_trace_unfused(torch, oracle, design, y, cfg, delta, a0, seed):
    """An EN point one step per dispatch, each step's stall test read at
    its tail: num and gap_scale from the tail's inputs in its kernel's op
    order (``en_ls_closed_form``'s; the kernel matches it bit for bit), the
    stall flag and step_inf from its outputs. Returns (iterations, the
    (steps, 6) trace)."""
    from repro_torch.core import engine, vertex
    from repro_torch.core.vertex import TorchSampler

    rows, real = [], vertex.step_tail
    rtol = torch.tensor(cfg.gap_rtol, dtype=torch.float32, device=design.device)

    def tail(Xt, yy, stats, beta, scale, maxabs, stall, resid, s_quad, f_lin, i_star, g, dlt,
             cfg_, en=None, tel=None):
        a_star = scale.float() * beta.index_select(0, i_star.view(1)).view(()).float()
        dt = -dlt * torch.sign(en.g_sel.float())
        s, f, q, gx, l2 = s_quad.float(), f_lin.float(), en.q_norm.float(), g.float(), en.l2
        num = s - dt * gx - f + l2 * (q - dt * a_star)
        gs = s + torch.abs(f) + torch.abs(dt * gx) + l2 * (q + torch.abs(dt * a_star))
        out = real(Xt, yy, stats, beta, scale, maxabs, stall, resid, s_quad, f_lin, i_star, g,
                   dlt, cfg_, en, tel=tel)
        rows.append(torch.stack([num, gs, q, (num <= rtol * gs).float(),
                                 (out[4] > 0).float(), out[3].float()]))
        return out

    vertex.step_tail = tail
    try:
        res = engine.solve_prepared(oracle, design, y, cfg, TorchSampler(seed, design.device),
                                    a0, delta)
    finally:
        vertex.step_tail = real
    return res.iterations, torch.stack(rows).double().cpu()


def _stall_trace_fused(torch, oracle, design, y, cfg, delta, a0, seed):
    """An EN point in K-step chunks through K4 or K7, each step's stall
    test read from the chunk's record (the kernel's num, gap_scale, Q and
    gap flag) and its stall flag and step_inf from the replay run again
    one record at a time on a copy of the state (which must end on the
    whole chunk's replay, bit for bit). Returns (iterations, the trace)."""
    from repro_torch.core import engine, vertex
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import fused_step as fs

    rows, pending = [], []
    real_chunk, real_replay = vertex.run_fused_kernel, engine._fused_replay

    def chunk(*args):
        out = real_chunk(*args)
        lam = out[1]  # column 0 of the chunk's (K, REC) record rows
        pending.append(lam.as_strided((lam.shape[0], fs.REC), (fs.REC, 1)))
        return out

    def replay(state, cfg_, i_stars, lams, delta_ts, no_progs, per_step):
        recs = pending.pop()
        st = (state.beta.clone(), state.scale, state.maxabs, state.step_inf, state.stall)
        for t in range(min(i_stars.shape[0], cfg_.max_iters - state.k)):
            one = slice(t, t + 1)
            st = fs.fused_replay(*st, i_stars[one], lams[one], delta_ts[one], no_progs[one],
                                 state.k + t, cfg_)
            rows.append(torch.stack([recs[t, 5], recs[t, 6], recs[t, 7], recs[t, 4],
                                     (st[4] > 0).float(), st[3].float()]))
        out = real_replay(state, cfg_, i_stars, lams, delta_ts, no_progs, per_step)
        check(all(_same_bits(torch, a, b) for a, b in zip(out, st)),
              "the fused replay one record at a time differs from the chunk's")
        return out

    vertex.run_fused_kernel, engine._fused_replay = chunk, replay
    try:
        res = engine.solve_prepared(oracle, design, y, cfg, TorchSampler(seed, design.device),
                                    a0, delta)
    finally:
        vertex.run_fused_kernel, engine._fused_replay = real_chunk, real_replay
    return res.iterations, torch.stack(rows).double().cpu()


def _stall_split(torch, oracle, design, y, a, b, g, n):
    """Why fused run ``a`` stopped more than K - 1 steps after unfused run
    ``b`` at point g, on the same n vertices: run both again with their
    stall tests traced. Every step of the n whose stall flag differs must
    sit within RTOL_STALL of its threshold in both runs (rounding that the
    two runs' differences can cross): a gap flag within RTOL_STALL *
    gap_scale of gap_rtol * gap_scale, or step_inf within RTOL_STALL * tol
    of tol. With no such step, a's streak must break after step n inside
    the chunk that b's stop fell in. Prints each such step with both runs'
    readings and Q's share of the gap's difference; returns a note."""
    cfg_a, cfg_b, deltas = a["cfg"], b["cfg"], b["deltas"]
    a0, seed = _point_start(torch, design, deltas, b, g)
    delta = float(deltas[g])
    it_a, ta = _stall_trace_fused(torch, oracle, design, y, cfg_a, delta, a0, seed)
    it_b, tb = _stall_trace_unfused(torch, oracle, design, y, cfg_b, delta, a0, seed)
    check(it_a == a["res"].points[g].iterations and it_b == b["res"].points[g].iterations,
          f"point {g}: the traced runs took {it_a}/{it_b} iterations, the paths "
          f"{a['res'].points[g].iterations}/{b['res'].points[g].iterations}")
    rtol = torch.tensor(cfg_a.gap_rtol, dtype=torch.float32)
    gap_a = (ta[:, 0].float() <= rtol * ta[:, 1].float()).double()
    check(torch.equal(gap_a, ta[:, 3]), f"point {g}: a fused record's gap flag is not num <= "
          "gap_rtol * gap_scale")
    check(bool((tb[:, 4] >= tb[:, 3]).all()), f"point {g}: an unfused step with its gap flag "
          "kept no stall")
    differ = (ta[:n, 4] != tb[:n, 4]).nonzero().view(-1).tolist()
    tol = cfg_a.tol
    print(f"[stall] point {g}: {n} shared steps, stall flags differ at steps {differ} "
          f"(fused {it_a} steps, unfused {it_b}; gap_rtol {cfg_a.gap_rtol:g}, tol {tol:g})")
    worst = 0.0
    for t in differ:
        ra, rb = ta[t].tolist(), tb[t].tolist()
        da, db = dict(zip(STALL_COLS, ra)), dict(zip(STALL_COLS, rb))
        if da["gap_flag"] != db["gap_flag"]:
            marg = [(d["num"] - cfg_a.gap_rtol * d["gap_scale"]) / d["gap_scale"]
                    for d in (da, db)]
            dnum = da["num"] - db["num"]
            dq = EN_L2 * (da["Q"] - db["Q"])
            print(f"[stall] step {t}: gap flag fused {int(da['gap_flag'])} unfused "
                  f"{int(db['gap_flag'])}; num {da['num']!r} / {db['num']!r}, gap_scale "
                  f"{da['gap_scale']!r} / {db['gap_scale']!r}, margin/gap_scale {marg[0]:.3e} / "
                  f"{marg[1]:.3e}; num diff {dnum:.4g} ({dnum / db['gap_scale']:.3e} of "
                  f"gap_scale), of it l2 * (Q diff) {dq:.4g} (Q {da['Q']!r} / {db['Q']!r})")
            kind, m_ab = "gap", max(abs(x) for x in marg)
        elif (da["step_inf"] <= tol) != (db["step_inf"] <= tol):
            marg = [(d["step_inf"] - tol) / tol for d in (da, db)]
            print(f"[stall] step {t}: step_inf fused {da['step_inf']!r} unfused "
                  f"{db['step_inf']!r} against tol {tol:g}: margin/tol {marg[0]:.3e} / "
                  f"{marg[1]:.3e}")
            kind, m_ab = "step_inf", max(abs(x) for x in marg)
        else:
            check(False, f"point {g} step {t}: stall flags differ, neither test does")
        check(m_ab <= RTOL_STALL, f"point {g} step {t}: the {kind} test's flags differ "
              f"{m_ab:.3e} of its scale from its threshold (more than rounding, {RTOL_STALL:g})")
        worst = max(worst, m_ab)
    if differ:
        return (f"same vertices for {n} steps; the stall flags differ at {len(differ)} of them, "
                f"each within {worst:.2e} of its threshold (rounding)")
    K = cfg_a.fuse_steps
    end = min(-(-n // K) * K, it_a)
    breaks = [t for t in range(n, end) if ta[t, 4] == 0]
    check(bool(breaks), f"point {g}: equal stall flags over {n} steps and no break of the "
          f"fused streak in steps {n}..{end - 1}")
    return (f"same vertices and stall flags for {n} steps; the fused streak broke at step "
            f"{breaks[0]}, inside the chunk of the unfused stop")


def _compare_ext(torch, design, y, oracle, a, b, max_overshoot, split=None):
    """Run ``a`` against run ``b`` (one step per dispatch) over their first
    points, from the same sampler seeds: vertex sequences equal up to the
    first difference, which must be a near-tie of the oracle's selected
    scores on b's state before that step (rebuilt by replaying b); a stop
    of ``a`` at most ``max_overshoot`` steps after ``b``'s while they agree,
    or later where ``split`` (``_stall_split``) shows why; objectives within
    RTOL_OBJ_SAME while they agree, and after within RTOL_OBJ_APART or
    within the larger of the two points' certified gaps."""
    la, lb, deltas = a["label"], b["label"], b["deltas"]
    apart = False
    for g in range(min(a["rec"].n_points, b["rec"].n_points)):
        pa, pb = a["res"].points[g], b["res"].points[g]
        sa, sb = a["rec"].sequence(g), b["rec"].sequence(g)
        note = "runs already apart"
        if not apart:
            common = min(len(sa), len(sb))
            diff = (sa[:common] != sb[:common]).nonzero().view(-1)
            if diff.numel():
                t = int(diff[0])
                state, idx = _replay_state(torch, oracle, design, y, b["cfg"], deltas, b, g, t)
                w = oracle.cograd(state.co, y)
                sel = _scores(torch, design, idx, w.float())
                shift = oracle.score_extra(state.beta, state.scale)
                if shift is not None:
                    sel = sel + shift(idx)
                margin = _top2_margin(torch, sel.abs(), idx)
                wnorm = float(torch.linalg.vector_norm(w.float()))
                check(margin <= RTOL_TIE * wnorm,
                      f"point {g} step {t}: vertex {int(sa[t])} ({la}) vs {int(sb[t])} ({lb}) "
                      f"with top-2 margin {margin:.3e} = {margin / wnorm:.2e} ||w||: no near-tie")
                note = (f"same vertices for {t} steps, then a near-tie (margin "
                        f"{margin / wnorm:.2e} ||w||)")
                apart = True
            elif len(sa) != len(sb):
                over = len(sa) - len(sb)
                check(0 <= over and (over <= max_overshoot or split is not None),
                      f"point {g}: {la} stopped {over} steps after {lb}, the same trajectory "
                      f"(at most {max_overshoot})")
                note = f"same vertices for {common} steps, {la} stopped {over} steps after {lb}"
                if over > max_overshoot:
                    note = split(torch, oracle, design, y, a, b, g, common)
                apart = True
            else:
                note = f"identical vertex sequence ({common} steps)"
        rtol = RTOL_OBJ_APART if apart else RTOL_OBJ_SAME
        rel = abs(pa.objective - pb.objective) / max(abs(pb.objective), 1e-30)
        print(f"[compare] {la} vs {lb} point {g}: iters {pa.iterations}/{pb.iterations} "
              f"objective {pa.objective!r}/{pb.objective!r} rel diff {rel:.2e} (rtol {rtol:g}): "
              f"{note}")
        if apart and rel > rtol:
            gaps = [_ext_gap(torch, oracle, design, y, pt) for pt in (pa, pb)]
            diff_f = abs(pa.objective - pb.objective)
            print(f"[compare] point {g}: |objective diff| {diff_f:.6g} against the certified "
                  f"gaps {gaps[0]:.6g} ({la}) and {gaps[1]:.6g} ({lb})")
            check(diff_f <= max(gaps), f"point {g}: objectives differ by {diff_f:.6g}, more "
                  "than either run's certified gap")
        else:
            check(rel <= rtol, f"{la} vs {lb} point {g}: objectives differ by {rel:.2e}")


def phase4_extensions(torch, design, y, en, log, layout):
    """The elastic-net's fused path against its unfused first points, and
    each oracle's kernels against the plain route ('torch' dense, the plain
    sparse ops) on the first points, with the near-tie rule. The fused EN
    chunk matches the unfused steps to rounding (the ledger reassociates
    scale * beta, src/repro/kernels/fused_step/fused_step.py:48-56), which
    can move a stall test: a stop more than K - 1 steps after the unfused
    one is traced (``_stall_split``) and splits the runs, whose objectives
    and certified gaps are then compared."""
    sparse = layout == "sparse"
    plain = dict(sparse_kernel=False) if sparse else dict(backend="torch")
    _compare_ext(torch, design, y, en["oracle"], dict(en["fused"], label=f"en-{layout}-fused"),
                 en["unfused"], FUSE - 1, _stall_split)
    for label, oracle, run, yy in (("en", en["oracle"], en["unfused"], y),
                                   ("log", None, log["seq"], log["y"])):
        from repro_torch.core import LOGISTIC

        oracle = LOGISTIC if oracle is None else oracle
        cfg = dataclasses.replace(run["cfg"], **plain)
        _, ref = _ext_path(torch, f"{label}-{layout}-plain", design, yy,
                           run["deltas"][:N_EXT_COMPARE], cfg, oracle, N_EXT_COMPARE)
        _compare_ext(torch, design, yy, oracle, run, ref, 0)


def _oracle_step_ms(torch, oracle, design, y, stats, cfg, delta, n_steps=200):
    """The host-clock ms of one step (a fixed run of ``n_steps`` after a
    warm-up, each run ending in a device sync) and its device busy ms
    (``torch.profiler`` over 50 more; None when it reports no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.core.vertex import TorchSampler

    def run(n, seed):
        c = dataclasses.replace(cfg, max_iters=n, tol=0.0, patience=10**9)
        state0 = engine.init_state(oracle, design, y, None, c)
        engine.run_loop(oracle, design, y, stats, state0, c, delta, 10**9,
                        TorchSampler(seed, design.device))

    run(n_steps, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n_steps, 5)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(50, 9)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in rows)
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 50:.2f} us"
                    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:4])
    launches = sum(e.count for e in rows) / 50
    return wall, (total_us / 1e3 / 50 if total_us > 0 else None), top, launches


def phase5_ext_timing(torch, design, y, layout):
    """The elastic-net's instantiations at the path's shapes (CUDA events,
    queued back to back) beside their bounds and plain versions, and the
    elastic-net and logistic steps' wall and device ms and idle share (one
    step per dispatch, and the EN step at K = 8)."""
    from repro_torch.core import LOGISTIC, ENOracle, FWConfig, LaneSampler, engine
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg
    from repro_torch.kernels import step_tail as st

    sparse = layout == "sparse"
    dev = design.device
    p, m = design.shape[0], design.shape[1]
    cfg = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    kappa, L = cfg.kappa, LANE_WIDTH
    suffix = "_sparse" if sparse else ""
    out = {}

    def row(name, ms, plain_ms, nbytes, flops, note=""):
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by)
        print(f"[timing] {name}: {ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.6f} ms, library "
              f"null{note}")

    g = torch.Generator(device=dev)
    g.manual_seed(41)
    sampler = TorchSampler(43, dev)
    idxs = [sampler.uniform(kappa, p) for _ in range(4)]
    beta = torch.zeros(p, device=dev)
    beta[idxs[0][:300]] = torch.randn(idxs[0][:300].numel(), generator=g, device=dev)
    shift = fw.ScoreShift(beta, torch.tensor(0.8, device=dev), EN_L2)
    r = y.float()
    if sparse:
        scores = sg.sparse_sampled_scores(design.values, design.rows, r, idxs[0], 1)
    else:
        scores = fw.sampled_scores(design, r, idxs[0], 1)
    row("vertex_argmax_shifted" + suffix,
        _time_queued(torch, lambda i: fw.vertex_argmax_shifted(scores, idxs[0], 1, p, shift), 400),
        _time_queued(torch, lambda i: fw.argmax_shifted_plain(scores, idxs[0], 1, p, shift), 40),
        kappa * 4 + kappa * 8 + kappa * 4 + 4 + 16, 5 * kappa,
        note=f" [n = kappa = {kappa}; bytes: the scores, their ids, beta at them, the scale]")
    ids = torch.arange(L, dtype=torch.int32, device=dev)
    blk = torch.stack([sampler.uniform(kappa, p) for _ in range(L)])
    rl = y.float().expand(L, m).contiguous()
    if sparse:
        lscores = sg.sparse_sampled_scores_lanes(design.values, design.rows, rl, blk, 1, ids)
    else:
        lscores = fw.sampled_scores_lanes(design, rl, blk, 1, ids)
    nzi = idxs[0][:300].unique()
    lshift = fw.ScoreShift(torch.zeros((L, p), device=dev).index_copy_(
        1, nzi, torch.randn((L, nzi.numel()), generator=g, device=dev)),
        torch.full((L,), 0.8, device=dev), EN_L2)
    row("vertex_argmax_shifted_lanes" + suffix,
        _time_queued(torch, lambda i: fw.vertex_argmax_shifted_lanes(lscores, blk, 1, p, ids, lshift), 400),
        _time_queued(torch, lambda i: fw.argmax_shifted_lanes_plain(lscores, blk, 1, p, ids,
                                                                    lshift), 2),
        L * (kappa * 16 + 4 + 16), 5 * L * kappa, note=f" [{L} lanes, n = kappa a lane]")
    del lshift

    tcfg = FWConfig(delta=5.0)
    mat = (design.values, design.rows) if sparse else design
    beta_t, targs = _tail_args(torch, g, p, m, torch.float32, int(idxs[0][0]))
    en = st.ENTail(torch.tensor(-3.25, device=dev), torch.tensor(40.0, device=dev), EN_L2)
    nnz = design.nnz_max if sparse else 0
    tail_bytes = (3 * m * 4 + nnz * 8 if sparse else 4 * m * 4) + 72
    row("step_tail_en" + suffix,
        _time_queued(torch, lambda i: st.step_tail_en(mat, beta_t, *targs, tcfg, en=en), 400),
        _time_queued(torch, lambda i: st.step_tail_plain(mat, beta_t, *targs, tcfg, en=en), 10),
        tail_bytes, 5 * m, note=f" [m={m}, no renorm]")
    lbeta, largs = _lane_tail_state(torch, g, p, m, torch.float32, L)
    largs = (torch.full((L,), 0.9, device=dev),) + largs[1:]
    len_ = st.ENTail(largs[11] + 0.5, torch.full((L,), 40.0, device=dev), EN_L2)
    row("step_tail_en_lanes" + suffix,
        _time_queued(torch, lambda i: st.step_tail_en_lanes(mat, lbeta, *largs, ids, tcfg,
                                                            en=len_), 400),
        _time_queued(torch, lambda i: st.step_tail_lanes_plain(mat, lbeta, *largs, ids, tcfg,
                                                               en=len_), 1),
        L * tail_bytes, L * 5 * m, note=f" [{L} lanes, m={m}, no renorm]")
    del lbeta, largs, beta_t, targs

    stats = engine.precompute_colstats(design, y, cfg)
    delta = torch.tensor(50.0, device=dev)
    chunks = []
    for _ in range(4):
        cidx = sampler.uniform_chunk(FUSE, kappa, p)
        chunks.append((cidx, stats.zty[cidx], stats.znorm2[cidx],
                       torch.randn((FUSE, kappa), generator=g, device=dev) * 0.01))
    zero = torch.zeros((), device=dev)
    kw = dict(_fused_kw(10**6), oracle=ENOracle(l2=EN_L2))
    name = "sparse_fused_chunk_en" if sparse else "dense_fused_chunk_en"
    head = (design.values, design.rows) if sparse else (design,)
    fn, plain = ((fs.sparse_fused_chunk_en, fs.sparse_fused_chunk_plain) if sparse
                 else (fs.dense_fused_chunk_en, fs.dense_fused_chunk_plain))

    def chunk(i, f=fn):
        cidx, zty_s, zn2_s, alpha_s = chunks[i % 4]
        return f(*head, y, y, (zero, zero, zero), cidx, zty_s, zn2_s, 0, delta,
                 alpha_s=alpha_s, **kw)

    if sparse:
        nz = sum(int(torch.count_nonzero(design.values.view(-1, nnz)[c[0].reshape(-1)]))
                 for c in chunks) / len(chunks)
        step_bytes = kappa * nnz * 4 + kappa * 20 + 3 * m * 4
        chunk_bytes, chunk_flops = FUSE * step_bytes + nz * 4, 2 * nz
    else:
        step_bytes = kappa * m * 4 + kappa * 20 + 3 * m * 4
        chunk_bytes, chunk_flops = FUSE * step_bytes, FUSE * 2 * kappa * m
    row(name, _time_queued(torch, chunk, 20), _time_queued(torch, lambda i: chunk(i, plain), 2),
        chunk_bytes, chunk_flops, note=f" [one chunk of K={FUSE}, kappa={kappa}, m={m}]")
    print(f"[timing] {name} per step: {out[name]['ms'] / FUSE:.6f} ms, bound "
          f"{out[name]['bound_ms'] / FUSE:.6f} ms")

    # the steps: wall, device busy, idle share
    yl = logistic_labels(torch, y)
    for label, oracle, yy, fuse in (("elastic-net", ENOracle(l2=EN_L2), y, 1),
                                    (f"elastic-net K={FUSE}", ENOracle(l2=EN_L2), y, FUSE),
                                    ("logistic", LOGISTIC, yl, 1)):
        scfg = dataclasses.replace(cfg, fuse_steps=fuse)
        sstats = stats if oracle.needs_stats else None
        wall, busy, top, n_launch = _oracle_step_ms(torch, oracle, design, yy, sstats, scfg,
                                                    delta, n_steps=160 if fuse > 1 else 200)
        busy_txt = ("device busy not measured (the profiler reported no device time)"
                    if busy is None else
                    f"device busy {busy:.4f} ms ({n_launch:.1f} kernels and copies a step; "
                    f"{top}), idle {100 * (1 - busy / wall):.1f}%")
        print(f"[timing] {label} step ({layout}): wall {wall:.4f} ms per iteration; {busy_txt}")
    return out


# --------------------------------------------------------------------------
# the step rules (core/step_rule): the direction tail and K2/K5 at width 1
# in phase 2, the rule paths at full width in phase 3, their routes and the
# reference's acceptance design in phase 4, their steps in phase 5
# --------------------------------------------------------------------------

RULES = ("away", "pairwise", "partan", "lazy")
RULE_POINTS = 3  # the first points of the 100-point grid each rule path runs
DIR_CASES = ("away", "pairwise", "drop", "same", "empty", "zero weights", "renorm", "refresh",
             "full")
DIR_OUT = ("scale", "maxabs", "step_inf", "S", "F", "Q", "g")


def _ell_of(mat):
    return (mat.values, mat.rows) if _is_sparse(mat) else mat


def _plain_scores(torch, mat, idx, r):
    """K2's or K5's plain scores at width 1 of ``idx`` (clipped by the
    caller) against ``r``."""
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg

    if _is_sparse(mat):
        return sg.sparse_sampled_scores_plain(mat.values, mat.rows, r, idx, 1)
    return fw.sampled_scores_plain(mat, r, idx, 1)


def _kernel_scores(torch, mat, idx, r):
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg

    if _is_sparse(mat):
        return sg.sparse_sampled_scores(mat.values, mat.rows, r, idx, 1)
    return fw.sampled_scores(mat, r, idx, 1)


def _col_norm_max(torch, mat, ids):
    from repro_torch.kernels.step_tail import dense_columns

    cols = dense_columns(_ell_of(mat), ids, mat.shape[1]).float()
    return float(torch.linalg.vector_norm(cols, dim=1).max())


def dir_tail_case(torch, mat, y_noise, case, g, en_l2=None, dtype=None, cap=32, tries=64):
    """A state for the direction tail, of the lasso or (``en_l2``) the
    elastic-net, that the plain version classifies as ``case`` (one of
    DIR_CASES), tried with new draws until the case holds: y = X a_true +
    ``y_noise``, alpha = 2 a_true on a random support (so that leaving an
    atom pays: its gradient is about a_true), the residual, S, F and Q from
    alpha, delta = 10 ||alpha||_1 + 1, the buffer, its scores and a FW
    vertex (the best of 64 random features off the support). A drop state
    has one light atom (alpha 1e-3) whose true weight is -500; a renorm
    state a scale of 1.01e-6 (just over the threshold), alpha = a_true /
    100, delta = ||a_true||_1 / 2, no buffer and its FW vertex on the
    support (a classic step that goes most of the way). Returns ``(beta,
    kwargs of dir_tail, en or None, plain output)``."""
    from repro_torch.core.vertex import matvec
    from repro_torch.kernels import step_tail as st

    dev = y_noise.device
    p, m = mat.shape
    dtype = y_noise.dtype if dtype is None else dtype
    cfg = _dir_cfg()
    for _ in range(tries):
        n_sup = cap if case == "full" else 6
        sup = torch.randperm(p, generator=g, device=dev)[:n_sup]
        a_true = torch.zeros(p, device=dev)
        a_true[sup] = torch.randn(n_sup, generator=g, device=dev)
        alpha = 2.0 * a_true
        scale = float(torch.rand((), generator=g, device=dev)) + 0.5
        if case == "drop":
            a_true[sup[0]], alpha[sup[0]] = -500.0, 1e-3
        if case == "renorm":
            alpha, scale = a_true / 100, 1.01e-6
        delta = (0.5 * float(a_true.abs().sum()) if case == "renorm"
                 else 10.0 * float(alpha.abs().sum()) + 1.0)
        y = (matvec(mat, a_true.to(dtype)).float() + 0.01 * y_noise.float()).to(dtype)
        beta = (alpha / scale).to(dtype)
        a = scale * beta.float()
        v = matvec(mat, a.to(dtype)).float()
        yf = y.float()
        resid = (yf - v).to(dtype)
        S, F, Q = float(v @ v), float(v @ yf), float(a @ a)
        if case in ("empty", "renorm"):
            buf = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        elif case == "zero weights":
            zeros = torch.nonzero(a == 0).view(-1)[:4]
            buf = torch.cat([zeros, torch.full((cap - 4,), -1, dtype=torch.int64, device=dev)])
        else:
            buf = torch.cat([sup, torch.full((cap - n_sup,), -1, dtype=torch.int64,
                                             device=dev)])[:cap]
            buf = buf[torch.randperm(cap, generator=g, device=dev)]
        safe = buf.clamp(0, p - 1)
        raw_b = _plain_scores(torch, mat, safe, resid)
        sample = torch.randint(0, p, (64,), generator=g, device=dev)
        # a renorm step heads for a support atom; the others for a new one
        sample = sup if case == "renorm" else sample[~torch.isin(sample, sup)]
        sc = _plain_scores(torch, mat, sample, resid)
        if en_l2 is not None:
            sc = sc + en_l2 * a[sample]
        j = int(torch.argmax(sc.abs()))
        i_f, sel_f = sample[j], sc[j]
        scale_t = torch.tensor(scale, device=dev).to(dtype)
        en = None if en_l2 is None else st.DirEN(en_l2, torch.tensor(Q, device=dev).to(dtype))
        if case == "same":  # the FW vertex is the away vertex
            sel_b = raw_b + (0.0 if en is None else en_l2 * a[safe])
            i_f = st.away_vertex(sel_b, buf, beta, scale_t, p)[0]
            sel_f = sel_b[int(torch.nonzero(buf == i_f)[0])]
        kw = dict(scale=scale_t, maxabs=a.abs().max().to(dtype),
                  stall=torch.tensor(3, dtype=torch.int32, device=dev), resid=resid,
                  s_quad=torch.tensor(S, device=dev).to(dtype),
                  f_lin=torch.tensor(F, device=dev).to(dtype), y=y, buf=buf, raw_b=raw_b,
                  i_f=i_f.clone(), sel_f=sel_f.float().clone(),
                  delta=torch.tensor(delta, dtype=torch.float32, device=dev),
                  refresh=case == "refresh", pairwise=case in ("pairwise", "same", "full"))
        out = st.dir_tail_plain(_ell_of(mat), beta.clone(), *_dir_args(kw), cfg, en)
        use_alt = int(out.i_star) == int(out.i_a) != int(i_f)
        dropped = use_alt and float(out.beta[out.i_a]) == 0.0 and float(beta[out.i_a]) != 0.0
        ok = {"away": use_alt and not dropped, "refresh": use_alt, "drop": dropped,
              "pairwise": use_alt, "same": int(out.i_a) == int(i_f) and float(out.g) > 0,
              "empty": True, "zero weights": not use_alt,
              "renorm": float(out.scale) == 1.0 and float(out.g) > 0,
              "full": not torch.equal(out.buf, buf)}[case]
        if ok:
            return beta, kw, en, out
    raise CheckFailed(f"dir_tail: no state for the case {case!r} in {tries} draws")


def _dir_cfg():
    from repro_torch.core import FWConfig

    return FWConfig(delta=1.0)


def _dir_args(kw):
    return (kw["scale"], kw["maxabs"], kw["stall"], kw["resid"], kw["s_quad"], kw["f_lin"],
            kw["y"], kw["buf"], kw["raw_b"], kw["i_f"], kw["sel_f"], kw["delta"], kw["refresh"],
            kw["pairwise"])


def _dir_floats(out):
    return [out.scale, out.maxabs, out.step_inf, out.s_quad, out.f_lin,
            out.q_norm if out.q_norm is not None else out.s_quad, out.g]


def check_dir_tail(torch, label, mat, beta, kw, en, want=None):
    """The direction tail's kernel (``dir_tail`` or, with ``en``,
    ``dir_tail_en``) against ``dir_tail_plain`` from the same state: the
    vertices, stall, the buffer and a drop's zero exact; beta, the residual
    and the scalars within RTOL_SUM of their scale (the three dots sum in
    another order); two launches bitwise equal, one launch a call. Returns
    max |kernel - plain| over the scalars and the residual."""
    from repro_torch.kernels import step_tail as st

    cfg = _dir_cfg()
    fn = st.dir_tail if en is None else st.dir_tail_en
    name = fn.__name__
    ell = _ell_of(mat)
    before = fn.launches
    extra = () if en is None else (en,)
    out_k = fn(ell, beta.clone(), *_dir_args(kw), cfg, *extra)
    again = fn(ell, beta.clone(), *_dir_args(kw), cfg, *extra)
    out_p = st.dir_tail_plain(ell, beta.clone(), *_dir_args(kw), cfg, en) if want is None else want
    if beta.is_cuda:
        check(fn.launches == before + 2, f"{name}: one launch a call")
    for a, b in zip(out_k, again):
        if a is not None:
            check(_same_bits(torch, a, b), f"{name} {label}: two launches differ")
    for f in ("stall", "buf", "i_star", "i_a"):
        check(torch.equal(getattr(out_k, f), getattr(out_p, f)),
              f"{name} {label}: {f} {getattr(out_k, f).tolist()} != plain "
              f"{getattr(out_p, f).tolist()}")
    i_a = int(out_p.i_a)
    check((float(out_k.beta[i_a]) == 0.0) == (float(out_p.beta[i_a]) == 0.0),
          f"{name} {label}: the away coordinate's zero")
    ids = torch.stack([kw["i_f"], out_p.i_a])
    u_scale = float(kw["delta"]) * 2 * _col_norm_max(torch, mat, ids)
    rn = float(torch.linalg.vector_norm(kw["resid"].float()))
    yn = float(torch.linalg.vector_norm(kw["y"].float()))
    dot_scale = (rn + yn + u_scale) ** 2
    err = 0.0
    for n, a, b in zip(DIR_OUT, _dir_floats(out_k), _dir_floats(out_p)):
        d = abs(float(a) - float(b))
        tol = RTOL_SUM * (abs(float(b)) + (dot_scale if n in ("S", "F", "Q") else 1e-30))
        if kw["resid"].dtype == torch.bfloat16:
            tol = max(tol, abs(float(b)) * 2 ** -7)  # one bf16 rounding of the stored scalar
        check(d <= tol, f"{name} {label}: {n} {float(a)!r} vs plain {float(b)!r}")
        err = max(err, d)
    r_scale = (kw["resid"].float().abs().max() + kw["y"].float().abs().max()
               ).item() + u_scale
    rd = float((out_k.resid.float() - out_p.resid.float()).abs().max())
    r_tol = RTOL_SUM * r_scale * max(1.0, float(out_p.g))
    if kw["resid"].dtype == torch.bfloat16:
        r_tol += float(out_p.resid.float().abs().max()) * 2 ** -7
    check(rd <= r_tol, f"{name} {label}: residual max |diff| {rd:.3e} > {r_tol:.3e}")
    bd = float((out_k.beta.float() - out_p.beta.float()).abs().max())
    b_tol = RTOL_SUM * (float(out_p.beta.float().abs().max()) + u_scale)
    check(bd <= b_tol, f"{name} {label}: beta max |diff| {bd:.3e} > {b_tol:.3e}")
    moved = "kept" if torch.equal(out_k.buf, kw["buf"]) else "moved"
    print(f"[kernels] {name} {label}: i* {int(out_k.i_star)} (i_a {i_a}), g {float(out_k.g)!r}, "
          f"stall {int(out_k.stall)}, buffer {moved}: as the plain version (scalars within "
          f"{err:.2e}, residual {rd:.2e}), two launches equal")
    return max(err, rd)


def phase2_rule_kernels(torch, design, y, layout):
    """The direction tail (``dir_tail``, ``dir_tail_en``) against its plain
    version on every DIR_CASES case, at the path's shapes in f32 and on a
    small design in bf16 (and a dense f32 one of m = 9,000, three blocks of
    the grid); K2 or K5 at width 1 at 32 and 16 caller indices with -1
    slots against their plain versions."""
    dev = y.device
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    errs = {"dir_tail": 0.0, "dir_tail_en": 0.0}
    p = design.shape[0]
    r = torch.randn(design.shape[1], generator=g, device=dev)
    for n in (32, 16):
        idx = torch.randint(0, p, (n,), generator=g, device=dev)
        idx[::5] = -1
        safe = idx.clamp(0, p - 1)
        got, want = _kernel_scores(torch, design, safe, r), _plain_scores(torch, design, safe, r)
        cs = float(torch.linalg.vector_norm(r)) * _col_norm_max(torch, design, safe)
        d = float((got - want).abs().max())
        check(d <= RTOL_SUM * cs, f"{layout} scores at width 1 on {n} caller indices")
        print(f"[kernels] {'K5' if layout == 'sparse' else 'K2'} at width 1 on {n} caller "
              f"indices with -1 slots: max |kernel - plain| {d:.3e} (scale {cs:.3e})")
    small_m = 9_000
    if layout == "sparse":
        from repro_torch.data import make_sparse_wide_problem

        small, _, _ = make_sparse_wide_problem(small_m, 20_000, 0.01, 50, seed=1, device=dev,
                                               block_size=SPARSE_BLOCK)
    else:
        small = torch.randn((20_000, small_m), generator=g, device=dev)
        small /= torch.linalg.vector_norm(small, dim=1, keepdim=True)
    ys = torch.randn(small_m, generator=g, device=dev)
    designs = [(f"{layout} f32 at the path's shapes", design, y, torch.float32),
               (f"{layout} f32 m={small_m}", small, ys, torch.float32),
               (f"{layout} bf16 m={small_m}", small if layout == "dense" else small.astype(
                   torch.bfloat16), ys, torch.bfloat16)]
    for label, mat, yy, dtype in designs:
        if dtype == torch.bfloat16 and layout == "dense":
            mat = mat.to(torch.bfloat16)
        for en_l2 in (None, EN_L2):
            key = "dir_tail" if en_l2 is None else "dir_tail_en"
            for case in DIR_CASES:
                beta, kw, en, want = dir_tail_case(torch, mat, yy, case, g, en_l2, dtype)
                errs[key] = max(errs[key], check_dir_tail(torch, f"{label}, {case}", mat, beta,
                                                          kw, en, want))
    return errs if layout == "dense" else {f"{k}_sparse": v for k, v in errs.items()}


class RuleStepLog:
    """``fw_path`` step hook of a rule path: each step's vertex (a device
    tensor, no sync) for the first points, and every step's n_dots
    increment (host ints), which tell a lazy step's hit (the cache's dots
    only) from its miss."""

    def __init__(self, n_points):
        self.n_points = n_points
        self.i_star = [[] for _ in range(n_points)]
        self.dots = []
        self.last = 0

    def __call__(self, g, state):
        if g < self.n_points:
            self.i_star[g].append(state.i_star)
        if state.k == 1:
            self.last = 0
        self.dots.append(state.n_dots - self.last)
        self.last = state.n_dots

    sequence = Recorder.sequence


def _rule_path(torch, tag, design, y, deltas, cfg, oracle, n_rec):
    """One rule path through ``fw_path``: points printed, launches counted,
    l1 <= delta and a finite certified gap at the densest point (the
    oracle's own gradient). Returns (launches, run)."""
    from repro_torch import kernels
    from repro_torch.core import fw_path

    log = RuleStepLog(n_rec)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = fw_path(design, y, deltas, cfg, seed=0, oracle=oracle, device=design.device,
                  on_step=log)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    from repro_torch.core import step_rule

    per_step = {"away": cfg.kappa + cfg.active_set_size + step_rule.DIR_EXTRA_DOTS,
                "pairwise": cfg.kappa + cfg.active_set_size + step_rule.DIR_EXTRA_DOTS,
                "classic": cfg.kappa}.get(cfg.step_rule)
    from repro_torch.core.engine import ColStats
    from repro_torch.core.vertex import matvec

    stats = ColStats(zty=None, znorm2=None, yty=torch.dot(y, y))
    flagged = []
    for g, pt in enumerate(res.points):
        # the objective from alpha itself beside the one the co-state's
        # recursions report: how far those drifted over the point's steps,
        # flagged past the point's certified gap and their rounding
        # (RTOL_OBJ_SAME; ROADMAP.md R5)
        alpha = _alpha_from_point(torch, pt, design.shape[0], design.device)
        co = oracle.init_co(y, matvec(design, alpha), alpha, alpha.dtype)
        true_obj = float(oracle.objective(y, stats, co))
        pt_gap = _ext_gap(torch, oracle, design, y, pt)
        drift = abs(pt.objective - true_obj)
        print(f"[{tag}] point {g:3d} delta={pt.reg:.6g} iters={pt.iterations} "
              f"n_dots={pt.n_dots} objective={pt.objective!r} (from alpha {true_obj!r}) "
              f"certified gap {pt_gap!r} l1={pt.l1:.6g} active={pt.active} "
              f"seconds={pt.seconds:.4f}")
        if drift > max(pt_gap, RTOL_OBJ_SAME * abs(true_obj)):
            flagged.append(g)
            print(f"[flag] {tag} point {g}: the recursions' objective is {drift!r} off alpha's, "
                  f"past the certified gap {pt_gap!r} (ROADMAP.md R5)")
        check(math.isfinite(pt.objective), f"{tag} point {g}: objective not finite")
        check(pt.l1 <= pt.reg * (1 + 1e-4), f"{tag} point {g}: l1 {pt.l1} > delta {pt.reg}")
        check(per_step is None or pt.n_dots == pt.iterations * (per_step + oracle.extra_dots),
              f"{tag} point {g}: n_dots")
    gap = _ext_gap(torch, oracle, design, y, res.points[-1])
    print(f"[{tag}] {wall:.3f} s, {res.total_iters} iterations, {res.total_dots:,} dots; "
          f"launches { {k: v for k, v in launches.items() if v} }; densest point: objective "
          f"{res.points[-1].objective!r}, certified gap {gap!r}")
    check(math.isfinite(gap), f"{tag}: certified gap")
    return launches, dict(res=res, log=log, cfg=cfg, deltas=deltas, label=tag, seconds=wall,
                          gap=gap, flagged=flagged)


def _replay_flagged(torch, tag, design, y, run, oracle):
    """The path of a flagged direction-rule run (``_rule_path``) again, up to
    its first flagged point, with every direction tail replayed through its
    plain version (``TailShadow``): the same points, bit for bit (the
    kernels' launches are deterministic), and each step's kernel output the
    plain algebra's on the same inputs, so the drift is the algebra's."""
    from repro_torch.core import fw_path

    g = run["flagged"][0]
    first = run["res"].points[g]
    with TailShadow(torch, design) as shadow:
        res = fw_path(design, y, run["deltas"][:g + 1], run["cfg"], seed=0, oracle=oracle,
                      device=design.device)
    again = res.points[g]
    check((again.iterations, again.objective) == (first.iterations, first.objective),
          f"{tag}: the replayed point {g} ran {again.iterations} steps to {again.objective!r}, "
          f"the first run {first.iterations} to {first.objective!r}")
    print(f"[flag] {tag} point {g} replayed: {shadow.summary()}")


def phase3_rule_paths(torch, design, y, coef, layout):
    """The rules at full width: the first RULE_POINTS points of the lasso
    path's 100-point warm-started grid through ``fw_path`` on the kernels'
    backend, under each rule; the elastic-net (l2 = 1) under 'away'; on the
    sparse layout the logistic under 'away' on its grid's first point. The
    launches a step: away and pairwise the scores twice (the draw, the
    buffer), the argmax and the direction tail once (five with the draw);
    PARTAN the classic step's kernels; lazy the tail and the cache's
    scores every step, the draw's scores and the argmax on a miss."""
    from repro_torch.core import LASSO, LOGISTIC, ENOracle, delta_grid

    sparse = layout == "sparse"
    p = design.shape[0]
    base = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    deltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=N_POINTS)[:RULE_POINTS]
    scores = "sparse_sampled_scores" if sparse else "sampled_scores"
    colstats = "sparse_colstats" if sparse else "colstats"
    runs, launches = {}, {}
    cases = [(rule, LASSO) for rule in RULES] + [("away", ENOracle(l2=EN_L2))]
    for rule, oracle in cases:
        en = oracle is not LASSO
        cfg = dataclasses.replace(base, step_rule=rule)
        tag = f"{rule}-{'en' if en else 'lasso'}-{layout}"
        lc, run = _rule_path(torch, tag, design, y, deltas, cfg, oracle, RULE_POINTS)
        it = run["res"].total_iters
        argmax = "vertex_argmax_shifted" if en else "vertex_argmax"
        tail = "step_tail_en" if en else "step_tail"
        dtail = "dir_tail_en" if en else "dir_tail"
        quiet = ("residual_update", "dense_fused_chunk", "sparse_fused_chunk", "fused_replay",
                 "dense_fused_chunk_en", "sparse_fused_chunk_en")
        if rule in ("away", "pairwise"):
            _check_launches(tag, lc, [((scores,), 2 * it), ((argmax, dtail), it),
                                      ((colstats,), RULE_POINTS)], quiet + (tail,))
            print(f"[{tag}] {(lc[scores] + lc[argmax] + lc[dtail]) / it + 1:.3g} launches a "
                  "step (the draw, the scores, the argmax, the buffer's scores, the tail)")
        elif rule == "partan":
            _check_launches(tag, lc, [((scores, argmax, tail), it), ((colstats,), RULE_POINTS)],
                            quiet + (dtail,))
        else:
            cap = cfg.lazy_cache
            hits = sum(1 for d in run["log"].dots if d == cap + 1 + oracle.extra_dots)
            misses = it - hits
            run["hit_share"] = hits / it
            print(f"[{tag}] lazy hits {hits} of {it} steps ({100 * hits / it:.1f}%)")
            # the scores: the cache's peek every step, the draw's on a miss
            _check_launches(tag, lc, [((tail,), it), ((argmax,), misses),
                                      ((scores,), misses + it), ((colstats,), RULE_POINTS)],
                            quiet + (dtail,))
        for name in (scores, argmax, tail, dtail):
            launches[name] = launches.get(name, 0) + lc[name]
        if run["flagged"] and rule in ("away", "pairwise"):
            _replay_flagged(torch, tag, design, y, run, oracle)
        runs[tag] = run
    if sparse:
        yl = logistic_labels(torch, y)
        cfg = dataclasses.replace(base, max_iters=LOG_MAX_ITERS, tol=LOG_TOL, step_rule="away")
        ldeltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=LOG_POINTS)[:1]
        lc, run = _rule_path(torch, f"away-log-{layout}", design, yl, ldeltas, cfg, LOGISTIC, 1)
        it = run["res"].total_iters
        _check_launches(f"away-log-{layout}", lc, [((scores,), 2 * it), (("vertex_argmax",), it)],
                        ("dir_tail", "dir_tail_en", "step_tail", "colstats", "sparse_colstats"))
        runs["away-log"] = run
    return launches, runs


class RuleTieProbe:
    """Records, while a run of the plain route goes, the first step of each
    grid point where one of the rules' decisions is a near-tie (within
    RTOL_TIE of its Cauchy-Schwarz scale): the draw's top-2 |scores|, the
    buffer's top-2 leave scores, away against FW, the pairwise test, the
    drop test, PARTAN's l1 test and odometer, the lazy cache's top-2 gaps,
    its hit test and phi update. Used as a context manager around the run;
    ``sampler`` wraps a sampler so the probe sees each draw."""

    def __init__(self, torch, design):
        self.torch = torch
        self.first = {}
        self.point = 0
        self.step = 0
        self.cs = 0.0
        self.row = None
        self.zmax = _col_norm_max(torch, design, torch.arange(design.shape[0],
                                                              device=design.device)[:4096])

    def sampler(self, inner):
        probe = self

        class Seen:
            def uniform(self, kappa, p):
                probe.row = inner.uniform(kappa, p)
                return probe.row

            def skip(self):
                inner.skip()

        return Seen()

    def tie(self, margin, scale, what):
        key = self.point
        if key not in self.first and abs(float(margin)) <= RTOL_TIE * float(scale):
            self.first[key] = (self.step, what)

    def on_step(self, g, state):
        if g != self.point:
            self.point, self.step = g, 0
        self.step += 1

    def __enter__(self):
        import numpy as np

        from repro_torch.core import step_rule, vertex
        from repro_torch.kernels import step_tail

        torch = self.torch
        f = lambda t: t.detach().float().cpu().numpy() if torch.is_tensor(t) else t  # noqa: E731
        self.saved = []

        def patch(obj, name, new):
            # the attribute itself (a class's staticmethod object, not the
            # function it unwraps to), so that __exit__ puts back the same
            self.saved.append((obj, name, inspect.getattr_static(obj, name)))
            setattr(obj, name, new)

        def top2(ids, vals):
            best = {}
            for i, v in zip(ids.tolist(), vals.tolist()):
                best[i] = max(v, best.get(i, -np.inf))
            top = sorted(best.values(), reverse=True)
            return top[0] - top[1] if len(top) > 1 and np.isfinite(top[1]) else np.inf

        orig_sample = vertex.sample_vertex

        def sample_vertex(Xt, w, sampler, p, cfg, extra_fn=None):
            out = orig_sample(Xt, w, sampler, p, cfg, extra_fn)
            if self.row is not None:
                _, sel = vertex.score_indices(Xt, w, self.row, p, cfg, extra_fn)
                mags = np.abs(f(sel))
                self.cs = self.zmax * float(torch.linalg.vector_norm(w.float())) + mags.max()
                self.tie(top2(f(self.row), mags), self.cs, "the draw's top-2 |scores|")
            return out

        orig_away, orig_choice = step_tail.away_vertex, step_tail.dir_choice
        orig_apply = step_tail.apply_dir_update

        def away_vertex(sel_b, buf, beta, scale, p):
            a_b = f(scale) * f(beta[buf.clamp(0, p - 1)])
            valid = (f(buf) >= 0) & (a_b != 0)
            if valid.sum() >= 2:
                self.tie(top2(f(buf)[valid], (np.sign(a_b) * f(sel_b))[valid]), self.cs,
                         "the buffer's top-2 leave scores")
            return orig_away(sel_b, buf, beta, scale, p)

        def dir_choice(sel_f, a_f, i_f, away, delta, ga, pairwise, eps_den):
            if bool(away[4]):
                sf, sa, sig, d = f(sel_f), f(away[1]), f(away[3]), f(delta)
                if pairwise:
                    self.tie(abs(sf) + sig * sa, self.cs, "the pairwise test")
                else:
                    gg = f(ga)
                    self.tie((sig * d * sa - gg) - (gg + d * abs(sf)), abs(gg) + 2 * d * self.cs,
                             "away against FW")
            return orig_choice(sel_f, a_f, i_f, away, delta, ga, pairwise, eps_den)

        def apply_dir_update(beta, scale, maxabs, stall, ds, g, no_progress, cfg):
            if float(ds.da) != 0.0:
                self.tie(f(g) - f(ds.g_max), f(ds.g_max), "the drop test")
            return orig_apply(beta, scale, maxabs, stall, ds, g, no_progress, cfg)

        patch(vertex, "sample_vertex", sample_vertex)
        for mod in (step_tail, step_rule):
            patch(mod, "away_vertex", away_vertex)
            patch(mod, "dir_choice", dir_choice)
            patch(mod, "apply_dir_update", apply_dir_update)
        orig_mu = step_rule.PartanRule.choose_mu
        orig_odo = step_rule.PartanRule.odometer
        orig_peek, orig_phi = step_rule.LazyRule._peek, step_rule.LazyRule.phi_update

        def choose_mu(mu_opt, mu_cons, l1_try, delta):
            d = f(delta)
            self.tie(f(l1_try) - d * (1.0 + 1e-6), d, "PARTAN's l1 test")
            return orig_mu(mu_opt, mu_cons, l1_try, delta)

        def odometer(drift, mu):
            out = orig_odo(drift, mu)
            self.tie(f(out) - step_rule.PARTAN_DRIFT_LIMIT, step_rule.PARTAN_DRIFT_LIMIT,
                     "PARTAN's odometer")
            return out

        def peek(oracle, Xt, y, stats, beta, scale, co, cache, phi, delta, p, cfg):
            out = orig_peek(oracle, Xt, y, stats, beta, scale, co, cache, phi, delta, p, cfg)
            valid = f(cache) >= 0
            if valid.any():
                gap = f(out.ga) + f(delta) * np.abs(f(out.sel_c))
                sc = abs(f(out.ga)) + f(delta) * (
                    self.zmax * float(torch.linalg.vector_norm(out.w.float()))
                    + np.abs(f(out.sel_c)).max())
                self.tie(top2(f(cache)[valid], gap[valid]), sc, "the cache's top-2 gaps")
                if np.isfinite(f(phi)):
                    self.tie(gap[valid].max() - f(phi), sc, "the lazy hit test")
            return out

        def phi_update(phi, gap):
            if np.isfinite(f(phi)):
                self.tie(f(gap) - f(phi), abs(f(phi)), "the phi update")
            return orig_phi(phi, gap)

        patch(step_rule.PartanRule, "choose_mu", staticmethod(choose_mu))
        patch(step_rule.PartanRule, "odometer", staticmethod(odometer))
        patch(step_rule.LazyRule, "_peek", staticmethod(peek))
        patch(step_rule.LazyRule, "phi_update", staticmethod(phi_update))
        return self

    def __exit__(self, *exc):
        for obj, name, old in reversed(self.saved):
            setattr(obj, name, old)
        return False


class TailShadow:
    """While a run on the kernels' backend goes inside it, each direction
    tail (``vertex.dir_tail``) is replayed through ``dir_tail_plain`` on
    copies of the kernel's inputs, twice: as it is, and with the kernel's
    step size g forced into its line search. The first holds the kernel's
    decisions before g (the vertex, the away vertex) and g itself, within
    RTOL_SUM of the line search's rounding scale (|g| + (gap scale + |g| x
    the denominator's terms) / the denominator); the second the decisions
    after g (stall, the buffer, the away coordinate's zero) and the values:
    scale, maxabs and step_inf within RTOL_SUM of themselves, beta within
    RTOL_SUM of its largest entry, the residual within RTOL_SUM of its
    scale times 1 + g, and S, F and Q within RTOL_SUM of their recursions'
    terms, which carry the amplification 1 + g of an away step. A decision
    may differ only where the replay's own RuleTieProbe finds a near-tie.
    Counts the steps, those splits, the worst deviation over its tolerance
    and the steps whose g reached the 1e3 clip of g_max."""

    def __init__(self, torch, design, tail=None):
        self.torch, self.design, self.tail = torch, design, tail
        self.probe = RuleTieProbe(torch, design)
        self.steps, self.splits, self.worst, self.max_g, self.clipped = 0, 0, 0.0, 0.0, 0

    def __enter__(self):
        from repro_torch.core import vertex

        self.vertex, self.saved = vertex, vertex.dir_tail
        # the tail under check: the route's own, unless one is given
        self.orig = self.tail if self.tail is not None else self.saved
        vertex.dir_tail = self.shadow
        return self

    def __exit__(self, *exc):
        self.vertex.dir_tail = self.saved
        return False

    def summary(self):
        return (f"{self.steps} steps replayed through dir_tail_plain, {self.splits} split at "
                f"near-ties, the worst deviation {self.worst:.3g} of its tolerance, g up to "
                f"{self.max_g:.6g} ({self.clipped} steps at the 1e3 clip)")

    def shadow(self, Xt, y, beta, scale, maxabs, stall, resid, s_quad, f_lin, buf, raw_b, i_f,
               sel_f, delta, refresh, pairwise, cfg, en=None):
        from repro_torch.kernels import step_tail as st

        torch = self.torch
        beta0 = beta.clone()
        args = (scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b, i_f, sel_f, delta,
                refresh, pairwise, cfg, en)
        out_k = self.orig(Xt, y, beta, *args[:6], *args[7:])
        if not self.vertex.use_kernels(cfg):
            return out_k
        mat, rec = _ell_of(Xt), {}
        orig_ls = st.dir_ls_closed_form

        def ls(ds, s, f, vu, uu, eps_den, gap_rtol, en_=None):
            g, no_progress = orig_ls(ds, s, f, vu, uu, eps_den, gap_rtol, en_)
            rec.setdefault("free", (ds, s, f, vu, uu, en_, g))
            return rec.get("force", g), no_progress

        probe = self.probe
        probe.first = {}
        probe.cs = (probe.zmax * float(torch.linalg.vector_norm(resid.float()))
                    + abs(float(sel_f)))
        st.dir_ls_closed_form = ls
        try:
            with probe:
                out_p = st.dir_tail_plain(mat, beta0.clone(), *args)
                rec["force"] = out_k.g
                out_f = st.dir_tail_plain(mat, beta0, *args)
        finally:
            st.dir_ls_closed_form = orig_ls
        tie = probe.first.get(probe.point)
        self.steps += 1
        gk = float(out_k.g)
        self.max_g = max(self.max_g, gk)
        self.clipped += gk >= 1e3 * (1 - 1e-6)
        if (int(out_k.i_star), int(out_k.i_a)) != (int(out_p.i_star), int(out_p.i_a)):
            check(tie is not None, f"[shadow] step {self.steps}: vertices {int(out_k.i_star)}, "
                  f"{int(out_k.i_a)} (kernel) against {int(out_p.i_star)}, {int(out_p.i_a)} "
                  "(plain), with no near-tie")
            self.splits += 1
            return out_k
        # g's rounding scale: num = -(t ga + df sel_f + da sel_a) and den = t^2 S +
        # 2 t vu + uu (+ l2 ||d||^2 >= 0 on the EN, left out: a looser bound)
        ds, s0, f0, vu0, uu0, en_, g0 = rec["free"]
        t, s, f, vu, uu, gp = (float(v) for v in (ds.t, s0, f0, vu0, uu0, g0))
        q = 0.0 if en_ is None else en_.l2 * abs(float(en_.q_norm))
        gap_scale = (abs(t) * (abs(s) + abs(f) + q) + abs(float(ds.df * ds.sel_f))
                     + abs(float(ds.da * ds.sel_a)))
        den_terms = t * t * abs(s) + 2.0 * abs(t * vu) + abs(uu)
        den_lin = t * t * s + 2.0 * t * vu + uu
        tol_g = RTOL_SUM * (abs(gp) + (gap_scale + abs(gp) * den_terms)
                            / max(den_lin, cfg.eps_den))
        devs = {"g": abs(gk - gp) / max(tol_g, 1e-30)}
        after_k = (int(out_k.stall), out_k.buf.tolist(), float(out_k.beta[out_k.i_a]) == 0.0)
        after_f = (int(out_f.stall), out_f.buf.tolist(), float(out_f.beta[out_f.i_a]) == 0.0)
        if after_k != after_f or devs["g"] > 1.0:
            check(tie is not None, f"[shadow] step {self.steps}: stall, buffer, zero {after_k} "
                  f"(kernel) against {after_f} (plain, the kernel's g); g {gk!r} against "
                  f"{gp!r} (tolerance {tol_g:.3g}), with no near-tie")
            self.splits += 1
            return out_k
        # the recursions' terms: S' = (1+gt)^2 S + 2 (1+gt) g vu + g^2 uu and
        # F' = (1+gt) F + g uy (||v|| = ||X alpha||, ||u|| <= 2 delta max ||z||),
        # Q' alike in ||alpha|| and 2 delta; a refresh step's S and F are the
        # new residual's dots, at phase 2's dot scale times 1 + g
        amp = 1.0 + gk
        ids = torch.stack([i_f, out_f.i_a])
        u_scale = float(delta) * 2 * _col_norm_max(torch, self.design, ids)
        rn = float(torch.linalg.vector_norm(resid.float()))
        yn = float(torch.linalg.vector_norm(y.float()))
        vn = float(torch.linalg.vector_norm(y.float() - resid.float()))
        terms = amp * vn + gk * u_scale
        qn = 0.0 if en is None else amp * abs(float(en.q_norm)) ** 0.5 + gk * 2 * float(delta)
        dot_scale = amp * (rn + yn + u_scale) ** 2
        scales = {"S": dot_scale if refresh else terms * terms,
                  "F": dot_scale if refresh else terms * yn, "Q": qn * qn}
        for n, a, b in zip(DIR_OUT, _dir_floats(out_k), _dir_floats(out_f)):
            if n == "g" or (n == "Q" and en is None):
                continue
            scale_n = scales.get(n, abs(float(b)))
            devs[n] = abs(float(a) - float(b)) / max(RTOL_SUM * scale_n, 1e-30)
        r_scale = float(resid.float().abs().max() + y.float().abs().max()) + u_scale
        devs["resid"] = float((out_k.resid.float() - out_f.resid.float()).abs().max()) / (
            RTOL_SUM * amp * r_scale)
        devs["beta"] = float((out_k.beta.float() - out_f.beta.float()).abs().max()) / max(
            RTOL_SUM * float(out_f.beta.float().abs().max()), 1e-30)
        worst = max(devs, key=devs.get)
        check(devs[worst] <= 1.0, f"[shadow] step {self.steps}: {worst} off the plain replay by "
              f"{devs[worst]:.3g} of its tolerance (g {gk!r})")
        self.worst = max(self.worst, devs[worst])
        return out_k


def _rule_routes(torch, tag, design, y, delta, cfg_a, cfg_b, oracle):
    """The first point under a rule on route a (the kernels, each direction
    tail replayed through its plain version by ``TailShadow``) and route b
    (the plain ops, probed): every step's vertex, n_dots, stall and support
    size equal up to b's first near-tie, and each step's objective within
    RTOL_OBJ_SAME while those agree (PARTAN's up to the near-tie); the final
    objectives within RTOL_OBJ_SAME when the runs agree throughout, else
    within RTOL_OBJ_APART or the larger certified gap. Prints the steps
    each comparison covered."""
    from repro_torch.core import engine
    from repro_torch.core.path import point_seed
    from repro_torch.core.vertex import TorchSampler

    stats = engine.precompute_colstats(design, y, cfg_b) if oracle.needs_stats else None
    logs, res = {}, {}
    shadow = TailShadow(torch, design)
    for name, cfg in (("a", cfg_a), ("b", cfg_b)):
        log = []
        probe = RuleTieProbe(torch, design) if name == "b" else None
        sampler = TorchSampler(point_seed(0, 0), design.device)

        def on_step(state, probe=probe, log=log):
            log.append((state.i_star, state.n_dots, state.stall, torch.count_nonzero(state.beta),
                        oracle.objective(y, stats, state.co)))
            if probe is not None:
                probe.on_step(0, state)

        with probe if probe is not None else shadow:
            res[name] = engine.solve(oracle, design, y, cfg,
                                     probe.sampler(sampler) if probe is not None else sampler,
                                     None, delta, device=design.device, on_step=on_step)
        tie = probe.first.get(0) if probe is not None else None
        logs[name] = log
    la, lb = logs["a"], logs["b"]

    def facts(row):
        return (int(row[0]), row[1], int(row[2]), int(row[3]))

    common = min(len(la), len(lb))
    t = next((i for i in range(common) if facts(la[i]) != facts(lb[i])), None)
    if t is not None:
        check(tie is not None and t >= tie[0],
              f"[{tag}] step {t}: vertex, n_dots, stall, support size {facts(la[t])} against "
              f"{facts(lb[t])} before the plain route's first near-tie ({tie})")
    # the objectives while the facts agree; PARTAN's only up to its first
    # near-tie, where its l1 test may pick the other mu with the same vertex
    end = common if t is None else t
    if cfg_a.step_rule == "partan" and tie:
        end = min(end, tie[0])
    for i in range(end):
        oa, ob = float(la[i][4]), float(lb[i][4])
        check(abs(oa - ob) <= RTOL_OBJ_SAME * abs(ob),
              f"[{tag}] step {i}: objective {oa!r} against {ob!r}, the same facts so far")
    ra, rb = res["a"], res["b"]
    rel = abs(float(ra.objective) - float(rb.objective)) / abs(float(rb.objective))
    agree = t is None and len(la) == len(lb)
    note = (f"identical facts at all {common} steps" if agree else
            f"the same facts for {common if t is None else t} steps, the plain route's first "
            f"near-tie at step {tie[0]} ({tie[1]})" if tie else "apart")
    print(f"[compare] {tag}: iterations {ra.iterations}/{rb.iterations}, objective "
          f"{float(ra.objective)!r}/{float(rb.objective)!r} rel diff {rel:.2e}: {note}; "
          f"{end} steps compared in full (vertex, n_dots, stall, support size, objective)"
          + (f"; the kernels' route: {shadow.summary()}" if shadow.steps else ""))
    if agree or rel <= RTOL_OBJ_APART:
        check(rel <= (RTOL_OBJ_SAME if agree else RTOL_OBJ_APART), f"{tag}: objectives")
    else:
        d = torch.tensor(float(delta), device=design.device)
        gaps = [float(oracle.gap(design, y, r.alpha, d)) for r in (ra, rb)]
        check(abs(float(ra.objective) - float(rb.objective)) <= max(gaps),
              f"{tag}: objectives differ by more than either run's certified gap {gaps}")


def phase4_rule_routes(torch, design, y, coef, layout):
    """Each rule's first grid point on the kernels against the plain route
    ('torch' on the dense layout, the plain sparse ops on the sparse one),
    from the same sampler seed, up to the plain route's first near-tie."""
    from repro_torch.core import LASSO, delta_grid

    sparse = layout == "sparse"
    p = design.shape[0]
    base = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    plain = (dataclasses.replace(base, sparse_kernel=False) if sparse
             else dataclasses.replace(base, backend="torch"))
    delta = float(delta_grid(0.5 * float(coef.abs().sum()), n_points=N_POINTS)[0])
    for rule in RULES:
        _rule_routes(torch, f"{rule}-{layout} kernels vs plain", design, y, delta,
                     dataclasses.replace(base, step_rule=rule),
                     dataclasses.replace(plain, step_rule=rule), LASSO)


def phase4_rule_acceptance(torch, dev):
    """The reference's acceptance design (``tests/test_step_rules.py:42-61``,
    m = 300, p = 120, delta 40, kappa 48, max_iters 1500, tol 1e-4) on the
    card, on 'kernels' and 'sparse', one ``TorchSampler(1)`` stream recorded
    and replayed to each rule. Its bars (away and pairwise at most classic's
    iterations; away converged in under a quarter of them; each certified
    gap at most 1e-4 of its objective) are printed as a finding: on the
    port's stream they are a statistical property of the rules."""
    from repro_torch.core import LASSO, FWConfig, StreamSampler, TorchSampler, engine
    from repro_torch.sparse.matrix import SparseBlockMatrix

    g = __import__("numpy").random.default_rng(11)
    np = __import__("numpy")
    m, p, rho = 300, 120, 0.6
    Z = g.standard_normal((m, p)).astype(np.float32)
    X = np.empty_like(Z)
    X[:, 0] = Z[:, 0]
    for j in range(1, p):
        X[:, j] = rho * X[:, j - 1] + np.sqrt(1 - rho**2) * Z[:, j]
    coef = np.zeros(p, np.float32)
    coef[g.choice(p, 10, replace=False)] = g.standard_normal(10).astype(np.float32) * 50.0
    yy = X @ coef + 1.0 * g.standard_normal(m).astype(np.float32)
    Xt = torch.from_numpy(X.T.copy()).to(dev)
    y = torch.from_numpy(yy.astype(np.float32)).to(dev)
    src = TorchSampler(1, dev)
    draws = torch.stack([src.uniform(48, p) for _ in range(1500)])
    for backend in ("kernels", "sparse"):
        design = (SparseBlockMatrix.from_dense(Xt.cpu(), block_size=32).to(dev)
                  if backend == "sparse" else Xt)
        out = {}
        for rule in ("classic",) + RULES:
            cfg = FWConfig(delta=40.0, kappa=48, sampling="uniform", max_iters=1500, tol=1e-4,
                           patience=20, step_rule=rule, backend=backend)
            r = engine.solve(LASSO, design, y, cfg, StreamSampler(draws), device=dev)
            gap = float(LASSO.gap(design, y, r.alpha, torch.tensor(40.0, device=dev), cfg))
            out[rule] = (r.iterations, bool(r.converged), gap, float(r.objective))
        it_c = out["classic"][0]
        bars = {
            "away <= classic iterations": out["away"][0] <= it_c,
            "pairwise <= classic iterations": out["pairwise"][0] <= it_c,
            "away converged": out["away"][1],
            "away * 4 < classic": out["away"][0] * 4 < it_c,
            **{f"{r} gap <= 1e-4 objective": out[r][2] <= 1e-4 * out[r][3] for r in out},
        }
        print(f"[acceptance] {backend}: " + ", ".join(
            f"{r} {it} iterations{' (converged)' if c else ''} gap {gp:.4g} objective {ob!r}"
            for r, (it, c, gp, ob) in out.items()))
        print(f"[acceptance] {backend} bars (a finding, not a check): " + ", ".join(
            f"{k} {'met' if v else 'MISSED'}" for k, v in bars.items()))


def _rule_step_ms(torch, oracle, design, y, stats, cfg, delta, n_steps=200):
    """``_oracle_step_ms`` under ``cfg.step_rule``, and for the lazy rule the
    host-clock ms of its hit steps and of its miss steps (the hook reads the
    stall count, which the loop reads next anyway, so a step's wall is the
    time between two hooks)."""
    from repro_torch.core import engine
    from repro_torch.core.vertex import TorchSampler

    wall, busy, top, n_launch = _oracle_step_ms(torch, oracle, design, y, stats, cfg, delta,
                                                n_steps)
    split = None
    if cfg.step_rule == "lazy":
        c = dataclasses.replace(cfg, max_iters=n_steps, tol=0.0, patience=10**9)
        state0 = engine.init_state(oracle, design, y, None, c)
        marks, dots = [time.perf_counter()], [0]

        def hook(state):
            int(state.stall)
            marks.append(time.perf_counter())
            dots.append(state.n_dots)

        engine.run_loop(oracle, design, y, stats, state0, c, delta, 10**9,
                        TorchSampler(7, design.device), on_step=hook)
        hit_ms, miss_ms = [], []
        for t in range(1, len(marks)):
            (hit_ms if dots[t] - dots[t - 1] == cfg.lazy_cache + 1 + oracle.extra_dots
             else miss_ms).append((marks[t] - marks[t - 1]) * 1e3)
        med = lambda v: sorted(v)[len(v) // 2] if v else float("nan")  # noqa: E731
        split = (med(hit_ms), len(hit_ms), med(miss_ms), len(miss_ms))
    return wall, busy, top, n_launch, split


def phase5_rule_timing(torch, design, y, layout):
    """The direction tail (f32, lasso and EN) at the path's shapes beside its
    bound and plain version, K2 or K5 at width 1 on the buffer's 32 slots,
    and the rules' steps: wall, device busy, launches and idle share."""
    from repro_torch.core import LASSO, LOGISTIC, ENOracle, engine
    from repro_torch.kernels import step_tail as st

    sparse = layout == "sparse"
    dev = y.device
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    m = design.shape[1]
    out = {}
    for key, l2 in (("dir_tail", None), ("dir_tail_en", EN_L2)):
        beta, kw, en, _ = dir_tail_case(torch, design, y, "away", g, l2, torch.float32)
        fn = st.dir_tail if en is None else st.dir_tail_en
        extra = () if en is None else (en,)
        ell = _ell_of(design)
        cfg = _dir_cfg()
        # 100 calls: the wrapper's host work (its checks and seven outputs)
        # must stay inside the spin kernel that _time_queued queues them behind
        ms = _time_queued(torch, lambda i: fn(ell, beta, *_dir_args(kw), cfg, *extra), 100)
        plain_ms = _time_queued(torch, lambda i: st.dir_tail_plain(ell, beta, *_dir_args(kw), cfg,
                                                                     en), 20)
        n_buf = kw["buf"].numel()
        nbytes = (3 * m * 4 + 2 * design.nnz_max * 8 if sparse else 5 * m * 4) + 2 * n_buf * 4 + 64
        nbytes += 0 if en is None else 8
        bound, by = _bound(nbytes, 10 * m)
        out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
        print(f"[timing] {key} ({layout}, m={m:,}): {ms:.6f} ms, bound {bound:.6f} ms ({by}, "
              f"{nbytes:,} bytes), {100 * bound / ms:.1f}% of bound, plain {plain_ms:.6f} ms")
        safe = kw["buf"].clamp(0, design.shape[0] - 1)
        k_ms = _time_queued(torch, lambda i: _kernel_scores(torch, design, safe, kw["resid"]), 400)
        p_ms = _time_queued(torch, lambda i: _plain_scores(torch, design, safe, kw["resid"]), 100)
        if key == "dir_tail":
            print(f"[timing] {'K5' if sparse else 'K2'} at width 1 on the buffer's {n_buf} slots "
                  f"({layout}): {k_ms:.6f} ms, plain {p_ms:.6f} ms")
    cfg = (sparse_config(design.shape[0], fuse_steps=1) if sparse
           else main_config(design.shape[0], "kernels"))
    stats = engine.precompute_colstats(design, y, cfg)
    delta = torch.tensor(50.0, device=dev)
    yl = logistic_labels(torch, y)
    cases = [("away", LASSO, y, stats), ("away", ENOracle(l2=EN_L2), y, stats),
             ("classic", LASSO, y, stats), ("pairwise", LASSO, y, stats),
             ("partan", LASSO, y, stats), ("lazy", LASSO, y, stats),
             ("away", LOGISTIC, yl, None)]
    for rule, oracle, yy, sts in cases:
        scfg = dataclasses.replace(cfg, step_rule=rule)
        n = 60 if oracle is LOGISTIC else 200
        wall, busy, top, n_launch, split = _rule_step_ms(torch, oracle, design, yy, sts, scfg,
                                                         delta, n)
        name = type(oracle).__name__.replace("Oracle", "").lower()
        busy_txt = ("device busy not measured (the profiler reported no device time)"
                    if busy is None else
                    f"device busy {busy:.4f} ms ({n_launch:.1f} kernels and copies a step; "
                    f"{top}), idle {100 * (1 - busy / wall):.1f}%")
        print(f"[timing] {rule} {name} step ({layout}): wall {wall:.4f} ms; {busy_txt}")
        if split is not None:
            print(f"[timing] lazy {name} step ({layout}): a hit {split[0]:.4f} ms (median of "
                  f"{split[1]}), a miss {split[2]:.4f} ms (median of {split[3]})")
    return out if not sparse else {f"{k}_sparse": v for k, v in out.items()}


# --------------------------------------------------------------------------
# the baselines: the CD sweep kernel (phase 2), the Pyrim CD, FISTA
# and FW paths and FISTA at the paper's dense width (phase 3), their timing
# (phase 5)
# --------------------------------------------------------------------------

# Pyrim at its published size (paper Table 1: m = 74, p = 201,376, dense; a
# design the paper runs CD on), the first points of lambda_grid(n_points=100):
# 10 under cyclic CD, FISTA and FW, 3 under stochastic CD
PYRIM_POINTS, PYRIM_STOCH_POINTS = 10, 3
# table4_baselines.py's settings
CD_SWEEPS, BASELINE_TOL, FISTA_ITERS = 200, 1e-3, 500
# a sweep's residual widths: Pyrim's, Triazines', the paper's dense m, one
# staged in shared memory past the registers and one past the on-chip cap
# (57,344 floats), where R lives in device memory
CD_M_CASES, CD_M_SMEM, CD_M_PAST_CAP = (74, 186, 800), 20_000, 60_000
# a sweep chains p dots, each rounding within RTOL_SUM of its Cauchy-Schwarz
# scale in another order than the plain loop's, and a coordinate's
# difference reaches the later ones through R: alpha within TOL_CD of
# ||alpha||_inf, R within TOL_CD of ||y||, max |d| within TOL_CD of
# ||alpha||_inf; a coordinate in one support only is a near-tie (|rho| within
# rounding of lam), its |alpha_j| under TOL_CD of ||alpha||_inf on both routes
TOL_CD = 1e-4
# FISTA's iteration is timed as the difference of two solves of these
# lengths (tol 0, so each runs to its length), which cancels the power
# iteration and the final residual
FISTA_TIMED_ITERS = (50, 250)


def _cd_case(torch, g, dev, m, p, dtype, kind):
    """One phase-2 sweep's inputs: unit-norm rows in ``dtype``, a 10-sparse
    signal, the start alpha0 and its residual, lam and the order."""
    from repro_torch.kernels import colstats as cs

    X = torch.randn((p, m), generator=g, device=dev)
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    coef = torch.zeros(p, device=dev)
    coef[:10] = 5 * torch.randn(10, generator=g, device=dev)
    y = coef @ X + 0.1 * torch.randn(m, generator=g, device=dev)
    alpha0 = torch.zeros(p, device=dev)
    if kind == "zero_column":
        X[5] = 0.0
        alpha0[5] = 2.5  # the 1e-12 floor: a_new = 0, d = -2.5, R untouched
    X = X.to(dtype).contiguous()
    _, zn2 = cs.colstats(X, y)
    lam_max = float((X.float() @ y).abs().max())
    lam, order = lam_max / 5, None
    if kind == "stochastic":  # repeats inside the ring's 15-column window, and back to back
        order = torch.randint(0, p, (p,), generator=g, device=dev)
        order[0] = torch.argmax((X.float() @ y).abs())  # a row that moves, whatever the draw
        order[3:6] = order[2]
        order[20] = order[10]
    elif kind == "lam_zero":
        lam = 0.0
    elif kind == "above_lam_max":
        lam = 1.01 * lam_max
    elif kind == "warm":  # a warm start, a third of it thresholded to 0 on the way
        alpha0 = torch.randn(p, generator=g, device=dev)
        alpha0[::3] = 0.0
        lam = lam_max / 2
    R0 = y - torch.mv(X.float().t(), alpha0)
    return X, zn2, alpha0, R0, lam, order, float(torch.linalg.vector_norm(y))


def check_cd_sweep(torch, label, X, zn2, alpha0, R0, lam, order, y_norm, nothing_moves=False):
    """The kernel twice (equal bits) and the plain loop from the same inputs;
    with ``nothing_moves`` (lam above lam_max from zero) alpha stays 0, R its
    bits and max |d| 0. Returns the largest |difference| of alpha and R, the
    plain loop's seconds and the number of coordinates the kernel moved."""
    from repro_torch.kernels import cd_sweep as cds

    runs = []
    for _ in range(2):
        a, r = alpha0.clone(), R0.clone()
        md = cds.cd_sweep(X, a, r, zn2, lam, order)
        runs.append((a, r, md))
    torch.cuda.synchronize()
    check(all(_same_bits(torch, u, v) for u, v in zip(*runs)), f"{label}: two sweeps differ")
    a_k, r_k, md_k = runs[0]
    a_p, r_p = alpha0.clone(), R0.clone()
    t0 = time.perf_counter()
    md_p = cds.cd_sweep_plain(X, a_p, r_p, zn2, lam, order)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    moved = int(torch.count_nonzero(a_k != alpha0))
    a_scale = max(float(a_p.abs().max()), float(a_k.abs().max()))
    d_a, d_r = float((a_k - a_p).abs().max()), float((r_k - r_p).abs().max())
    d_md = abs(float(md_k) - float(md_p))
    only = torch.nonzero((a_k != 0) != (a_p != 0)).view(-1)
    ties = [(int(j), float(a_k[j]), float(a_p[j])) for j in only[:8].tolist()]
    print(f"[cd_sweep] {label}: alpha {d_a:.3g} ({d_a / max(a_scale, 1e-30):.3g} of "
          f"||alpha||_inf {a_scale:.4g}), R {d_r:.3g} ({d_r / y_norm:.3g} of ||y||), max|d| "
          f"{float(md_k)!r} vs {float(md_p)!r}, active {int(torch.count_nonzero(a_k))} vs "
          f"{int(torch.count_nonzero(a_p))}, {moved} coordinates moved, near-ties in one "
          f"support only: {only.numel()} {ties}; twice: equal bits")
    check(d_a <= TOL_CD * a_scale and d_r <= TOL_CD * y_norm and d_md <= TOL_CD * a_scale,
          f"{label}: kernel and plain sweep differ past TOL_CD")
    check(bool(torch.all((a_k[only].abs() <= TOL_CD * a_scale)
                         & (a_p[only].abs() <= TOL_CD * a_scale))),
          f"{label}: a support difference that is not a near-tie: {ties}")
    if nothing_moves:
        check(not bool(torch.any(a_k != 0)) and _same_bits(torch, r_k, R0)
              and float(md_k) == 0.0, f"{label}: something moved above lam_max")
    return max(d_a, d_r), plain_s, moved


def phase2_cd_sweep(torch, dev):
    """``cd_sweep`` against ``cd_sweep_plain`` on the card: cyclic and
    stochastic orders (repeats inside the ring's window and back to back), m
    = 74, 186, 800, 20,000 (R in shared memory) and 60,000 (past the on-chip
    cap), lam = 0, lam > lam_max, a warm start, a zero column, f32 and bf16."""
    from repro_torch.kernels import cd_sweep as cds

    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    err = 0.0
    cases = [(m, dt, kind) for m in CD_M_CASES for dt in (torch.float32, torch.bfloat16)
             for kind in ("cyclic", "stochastic")]
    cases += [(800, torch.float32, kind) for kind in ("lam_zero", "above_lam_max", "warm",
                                                      "zero_column")]
    cases += [(74, torch.bfloat16, "warm"), (CD_M_SMEM, torch.float32, "stochastic"),
              (CD_M_PAST_CAP, torch.float32, "cyclic"), (CD_M_PAST_CAP, torch.bfloat16,
                                                         "stochastic")]
    for m, dt, kind in cases:
        p = 1000 if m <= 800 else 300
        X, zn2, alpha0, R0, lam, order, y_norm = _cd_case(torch, g, dev, m, p, dt, kind)
        pl = cds.sweep_plan(m, dt)
        label = (f"m={m} p={p} {str(dt).replace('torch.', '')} {kind} ({pl.route}, "
                 f"{pl.threads} threads, {pl.slots} stages, R "
                 f"{'on chip' if pl.residual_on_chip else 'in device memory'})")
        err = max(err, check_cd_sweep(torch, label, X, zn2, alpha0, R0, lam, order, y_norm,
                                      nothing_moves=kind == "above_lam_max")[0])
    print(f"[cd_sweep] phase 2: {len(cases)} cases in {time.perf_counter() - t0:.1f} s")
    return {"cd_sweep": err}


def _penalized(pt):
    return pt.objective + pt.reg * pt.l1


def _print_baseline_points(tag, res, unit):
    for g, pt in enumerate(res.points):
        print(f"[{tag}] point {g:2d} reg={pt.reg:.6g} {unit}={pt.iterations} n_dots={pt.n_dots} "
              f"objective={pt.objective!r} l1={pt.l1:.6g} active={pt.active} "
              f"seconds={pt.seconds:.4f}")
        check(math.isfinite(pt.objective) and math.isfinite(pt.l1),
              f"{tag} point {g}: objective not finite")
    print(f"[{tag}] path: {len(res.points)} points, {res.total_iters} {unit}, "
          f"{res.total_dots:,} dots, {res.total_seconds:.3f} s, mean active "
          f"{res.mean_active:.1f}")


def phase3_baselines(torch, dev, launches, errs):
    """The paper's comparison on the card, on Pyrim at its published size:
    cyclic CD on the first PYRIM_POINTS points of a 100-point lambda grid,
    stochastic CD on the first PYRIM_STOCH_POINTS, penalized FISTA on the
    same points as cyclic CD, and the FW path at the CD points' l1 norms
    (paper §2.1); one warm sweep at full p through the kernel and the plain
    loop; then (phase 5) the sweep's and a FISTA iteration's times. Returns
    the sweep's timing row; the warm sweep's error joins ``errs``."""
    from repro_torch import kernels
    from repro_torch.core import (CDConfig, FISTAConfig, baselines, cd_path, fista_path,
                                  fw_path, lambda_grid)
    from repro_torch.data import PROXY_SPECS, make_proxy
    from repro_torch.kernels import cd_sweep as cds
    from repro_torch.kernels import colstats as cs

    t_phase = time.perf_counter()
    spec = PROXY_SPECS["pyrim"]
    t0 = time.perf_counter()
    ds = make_proxy("pyrim", scale=1.0, seed=0)
    Xt = torch.from_numpy(ds.X.T.copy()).to(dev)
    y = torch.from_numpy(ds.y).to(dev)
    p, m = Xt.shape
    check((m, p) == (spec.m, spec.p), "the Pyrim proxy's size")
    print(f"[pyrim] make_proxy('pyrim', scale=1.0): m={m} p={p:,} dense f32 Xt "
          f"{Xt.numel() * 4 / 1e6:.1f} MB, built on the host in {time.perf_counter() - t0:.1f} s")
    lams = lambda_grid(Xt, y, n_points=100)
    pl = cds.sweep_plan(m, Xt.dtype)
    print(f"[pyrim] lambda_grid(n_points=100): lam_max {lams[0]:.6g}; points 0-"
          f"{PYRIM_POINTS - 1} down to {lams[PYRIM_POINTS - 1]:.6g}; cd_sweep route {pl.route}, "
          f"{pl.threads} threads, {pl.slots} stages")

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    cd = cd_path(Xt, y, lams[:PYRIM_POINTS], CDConfig(lam=0.0, max_sweeps=CD_SWEEPS,
                                                       tol=BASELINE_TOL), seed=0)
    n_cyc = kernels.launch_counts()["cd_sweep"]
    _print_baseline_points("cd", cd, "sweeps")
    check(n_cyc == cd.total_iters, f"cd_sweep launches {n_cyc} != sweeps {cd.total_iters}")
    kernels.reset_launch_counts()
    scd = cd_path(Xt, y, lams[:PYRIM_STOCH_POINTS],
                  CDConfig(lam=0.0, max_sweeps=CD_SWEEPS, tol=BASELINE_TOL, stochastic=True),
                  seed=0)
    n_sto = kernels.launch_counts()["cd_sweep"]
    _print_baseline_points("scd", scd, "sweeps")
    check(n_sto == scd.total_iters, f"cd_sweep launches {n_sto} != sweeps {scd.total_iters}")
    launches["cd_sweep"] = n_cyc + n_sto
    print(f"[cd] cd_sweep launches: {n_cyc} cyclic + {n_sto} stochastic = sweeps; CD paths "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fi = fista_path(Xt, y, lams[:PYRIM_POINTS], FISTAConfig(max_iters=FISTA_ITERS,
                                                            tol=BASELINE_TOL), seed=0)
    _print_baseline_points("fista", fi, "iterations")
    for g, (a, b) in enumerate(zip(cd.points, fi.points)):
        rel = abs(_penalized(a) - _penalized(b)) / abs(_penalized(b))
        hit = b.iterations >= FISTA_ITERS
        print(f"[cd-vs-fista] point {g}: penalized CD {_penalized(a)!r} FISTA {_penalized(b)!r} "
              f"rel {rel:.3g}" + (" (FISTA hit max_iters)" if hit else ""))
        check(rel <= 1e-3, f"point {g}: CD and FISTA apart by {rel:.3g}")

    fw_cfg = main_config(p, "kernels")
    fw = fw_path(Xt, y, [pt.l1 for pt in cd.points], fw_cfg, seed=0, device=dev)
    _print_points("pyrim-fw", fw, fw_cfg)
    for g, (a, b) in enumerate(zip(cd.points, fw.points)):
        print(f"[cd-vs-fw] point {g}: delta = CD's l1 {a.l1:.6g}: objective CD {a.objective!r} "
              f"FW {b.objective!r} (ratio {b.objective / a.objective:.6f}); seconds CD "
              f"{a.seconds:.4f} FW {b.seconds:.4f}; dots CD {a.n_dots:,} FW {b.n_dots:,}")
    print(f"[pyrim] paths: CD {cd.total_seconds:.3f} s ({cd.total_iters} sweeps, "
          f"{cd.total_dots:,} dots, mean active {cd.mean_active:.1f}); stochastic CD "
          f"{scd.total_seconds:.3f} s ({scd.total_iters} sweeps, 3 points); FISTA "
          f"{fi.total_seconds:.3f} s ({fi.total_iters} iterations, {fi.total_dots:,} dots, mean "
          f"active {fi.mean_active:.1f}); FW {fw.total_seconds:.3f} s ({fw.total_iters} "
          f"iterations, kappa {fw_cfg.kappa}, {fw.total_dots:,} dots, mean active "
          f"{fw.mean_active:.1f}); FISTA and FW {time.perf_counter() - t0:.1f} s")

    # one warm sweep at full p, the kernel against the plain loop on the card:
    # from the last point but one's alpha and residual at the last point's lam,
    # where coordinates move (at lams[0] = lam_max none can); the plain loop's
    # time is the sweep's plain_ms
    _, zn2 = cs.colstats(Xt, y)
    lam = float(lams[PYRIM_POINTS - 1])
    warm = _alpha_from_point(torch, cd.points[-2], p, dev)
    err, plain_s, moved = check_cd_sweep(
        torch, f"Pyrim m={m} p={p:,} f32 cyclic, warm from point {PYRIM_POINTS - 2} at point "
        f"{PYRIM_POINTS - 1}'s lam ({pl.route})", Xt, zn2, warm, y - torch.mv(Xt.t(), warm), lam,
        None, float(torch.linalg.vector_norm(y)))
    check(moved > 0, "the warm Pyrim sweep moved no coordinate")
    errs["cd_sweep"] = max(errs["cd_sweep"], err)
    plain_ms = 1e3 * plain_s

    # phase 5: a sweep's time on Pyrim, L2 flushed; its bound and floor
    flush = torch.empty(64 * 2**20, device=dev)
    alpha, resid = torch.zeros(p, device=dev), y.clone()
    ms = _time_cold(torch, lambda: cds.cd_sweep(Xt, alpha, resid, zn2, lam), 5, flush)
    order = torch.randint(0, p, (p,), device=dev)
    ms_sto = _time_cold(torch, lambda: cds.cd_sweep(Xt, alpha, resid, zn2, lam, order), 3, flush)
    floor_ms = _time_cold(torch, lambda: cds.chain_floor(p, dev), 3, flush)
    nbytes = cds.sweep_bytes(p, m, Xt.dtype, ordered=False)
    bound_ms, bound_by = _bound(nbytes, 4 * p * m)
    print(f"[timing] cd_sweep (Pyrim, m={m}, p={p:,}, cyclic, L2 flushed): {ms:.6f} ms a "
          f"sweep, bound {bound_ms:.6f} ms ({bound_by}, {nbytes:,} bytes, "
          f"{100 * bound_ms / ms:.2f}% of bound); stochastic {ms_sto:.6f} ms; the chain's "
          f"floor, {p:,} dependent warp sums: {floor_ms:.6f} ms ({100 * floor_ms / ms:.1f}% of "
          f"the sweep); plain {plain_ms:.6f} ms (the warm sweep above, one plain sweep of all "
          f"{p:,} rows on the host's clock); library none; {1e6 * ms / p:.1f} ns a coordinate")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)

    # a FISTA iteration: the difference of two solves that run to their
    # lengths, so the power iteration and the final residual cancel; each
    # length twice, the faster kept
    walls = {n: float("inf") for n in FISTA_TIMED_ITERS}
    for n in FISTA_TIMED_ITERS * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = baselines.fista_solve(Xt, y, FISTAConfig(lam=lam, max_iters=n, tol=0.0), seed=0)
        float(res.objective)
        walls[n] = min(walls[n], time.perf_counter() - t0)
        check(res.iterations == n, f"the timed FISTA solve stopped at {res.iterations} of {n}")
    n0, n1 = FISTA_TIMED_ITERS
    wall = 1e3 * (walls[n1] - walls[n0]) / (n1 - n0)
    v = torch.randn(p, device=dev)
    mv_ms = _time_queued(torch, lambda i: torch.mv(Xt, torch.mv(Xt.t(), v)), 200)
    print(f"[timing] FISTA iteration (Pyrim, penalized, lam {lam:.6g}, default power "
          f"iterations): wall {wall:.4f} ms ({n0} and {n1} iterations in {1e3 * walls[n0]:.3f} "
          f"and {1e3 * walls[n1]:.3f} ms, each run to its length), the two torch.mv calls "
          f"alone {mv_ms:.4f} ms ({100 * mv_ms / wall:.1f}% of the iteration)")
    print(f"[pyrim] baselines phases {time.perf_counter() - t_phase:.1f} s")
    return {"cd_sweep": row}


def phase3_fista_paper_width(torch, Xt, y, main):
    """Constrained FISTA at the main path's densest delta (the point whose
    certified gap phase 3 checks): a feasible FISTA point cannot lie below
    the optimum, so f_FW - f_FISTA <= gap_FW, however far FISTA is from
    converged."""
    from repro_torch.core import LASSO, FISTAConfig, baselines

    t_phase = time.perf_counter()
    p = Xt.shape[0]
    last = main["res"].points[-1]
    delta = last.reg
    alpha = _alpha_from_point(torch, last, p, Xt.device)
    gap = float(LASSO.gap(Xt, y, alpha, torch.tensor(delta, device=Xt.device)))
    r = y - torch.mv(Xt.t(), alpha)
    f_fw = 0.5 * float(r @ r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = baselines.fista_solve(Xt, y, FISTAConfig(delta=delta, constrained=True,
                                                   max_iters=FISTA_ITERS, tol=BASELINE_TOL),
                                seed=0)
    f_fi = float(res.objective)
    dt = time.perf_counter() - t0
    l1 = float(res.alpha.abs().sum())
    slack = RTOL_SUM * 0.5 * float(y @ y)
    print(f"[fista-4m] constrained FISTA p={p:,} m={Xt.shape[1]} delta={delta:.6g}: "
          f"{res.iterations} iterations ({'converged' if res.converged else 'max_iters'}), "
          f"{res.n_dots:,} dots, objective {f_fi!r}, l1 {l1:.6g}, active {res.active}, "
          f"{dt:.3f} s ({1e3 * dt / max(res.iterations, 1):.3f} ms an iteration); FW's "
          f"objective {f_fw!r}, certified gap {gap!r}: f_FW - f_FISTA = {f_fw - f_fi!r} "
          f"<= gap + {slack:.4g}")
    check(l1 <= delta * (1 + 1e-4), "FISTA's iterate outside the l1 ball")
    check(math.isfinite(f_fi) and f_fw - f_fi <= gap + slack,
          "FW's certified gap does not cover FISTA's feasible objective")
    print(f"[fista-4m] phase {time.perf_counter() - t_phase:.1f} s")

# --------------------------------------------------------------------------
# observability: the telemetry ring's kernels (the TEL instantiations of the
# step tail and the replay), a traced, metered, recorded path, and their times
# --------------------------------------------------------------------------

TEL_CAP = 256  # the ring's slots in phases 2 and 3
TEL_KERNELS = ("step_tail_tel", "step_tail_en_tel", "step_tail_lanes_tel",
               "step_tail_en_lanes_tel", "fused_replay_tel")
TEL_POINTS = 3  # the first grid points phase 3 runs with everything on
TEL_LANES = 13  # the lanes of phase 3's batched chunk
TEL_LANE_STEPS = 300  # its max_iters
TEL_RECORD_BYTES = 40  # a record's bytes: 4 int32, 4 float32, 1 int64


def _tel_rings(torch, dev, n, lanes=None, cursors=None):
    """``n`` empty rings of TEL_CAP slots (lane rings with these cursors)."""
    from repro_torch.obs import telemetry as tl

    rings = []
    for _ in range(n):
        r = tl.init_ring(tl.TelemetrySpec(capacity=TEL_CAP), dev, lanes)
        if cursors is not None:
            r = r._replace(cursor=list(cursors),
                           dev_cursor=torch.tensor(cursors, dtype=torch.int64, device=dev))
        rings.append(r)
    return rings


def _tel_tail_case(torch, st, label, mat, beta, args, cfg, en, objective, yty):
    """Two chained steps of the TEL tail (``step_tail`` or ``step_tail_en``
    with a record) against the plain tail and record: the first writes the
    ring's last slot, the second (from the first's outputs) slot 0, the
    wrap. Every output and every ring word bit for bit; a second kernel run
    bitwise the first."""
    from repro_torch.kernels.step_tail import TailRecord

    dev = beta.device
    rings = _tel_rings(torch, dev, 3)
    fn = st.step_tail_en if en is not None else st.step_tail
    outs = []
    for r, route in zip(rings, ("kernel", "kernel", "plain")):
        b, a, e = beta.clone(), args, en
        for slot, k, n in ((TEL_CAP - 1, TEL_CAP - 1, 10**9 + 7), (0, TEL_CAP, 10**9 + 9)):
            rec = TailRecord(r.buf, TEL_CAP, slot, k, n, objective, yty)
            if route == "plain":
                got = st.step_tail_plain(mat, b, *a, cfg, e, rec)
            elif e is not None:
                got = fn(mat, b, *a, cfg, e, tel=rec)
            else:
                got = fn(mat, b, *a, cfg, tel=rec)
            # the next step from this one's outputs (the winner and score kept)
            a = (got[1], got[2], got[4], got[5], got[6], got[7]) + a[6:]
            if e is not None:
                e = e._replace(q_norm=got[8])
        outs.append((got, r))
    (k1, r1), (k2, r2), (pl, rp) = outs
    differ = [n for n, a, b in zip(TAIL_OUT + ("Q",), k1, pl) if not _same_bits(torch, a, b)]
    check(not differ, f"{label}: {differ} differ from the plain tail")
    check(torch.equal(r1.buf, rp.buf), f"{label}: the ring's words differ from the plain record")
    check(torch.equal(r1.buf, r2.buf) and all(_same_bits(torch, a, b) for a, b in zip(k1, k2)),
          f"{label}: two launches differ")
    ks = r1.k.tolist()
    check(ks[TEL_CAP - 1] == TEL_CAP - 1 and ks[0] == TEL_CAP and ks[1] == -1,
          f"{label}: the records are not at the ring's last slot and then slot 0")
    nan = torch.isnan(r1.objective[[0, TEL_CAP - 1]])
    check(bool(nan.all()) != objective and int(r1.n_dots[0]) == 10**9 + 9,
          f"{label}: the objective or n_dots fields are wrong")


def _tel_lane_case(torch, st, label, mat, beta, args, L, cfg, en, yty):
    """The lane TEL tail with lane 1 frozen, lane 0's cursor at the ring's
    last slot: outputs, every lane's ring words and the device cursors
    bitwise the plain version's; the frozen lane records nothing and keeps
    its cursor."""
    from repro_torch.kernels.step_tail import TailRecord

    dev = beta.device
    run = [lane for lane in range(L) if lane != 1]
    ids = torch.tensor(run, dtype=torch.int32, device=dev)
    cursors = [TEL_CAP - 1] + [3 * lane for lane in range(1, L)]
    outs = []
    for route in ("kernel", "plain"):
        (r,) = _tel_rings(torch, dev, 1, L, cursors)
        rec = TailRecord(r.buf, TEL_CAP, 0, 0, 42_723, True, yty, list(cursors), r.dev_cursor)
        b = beta.clone()
        if route == "kernel":
            got = (st.step_tail_en_lanes(mat, b, *args, ids, cfg, en, tel=rec) if en is not None
                   else st.step_tail_lanes(mat, b, *args, ids, cfg, tel=rec))
        else:
            got = st.step_tail_lanes_plain(mat, b, *args, ids, cfg, en, rec)
        outs.append((got, r))
    (kg, kr), (pg, pr) = outs
    differ = [n for n, a, b in zip(TAIL_OUT + ("Q",), kg, pg) if not _same_bits(torch, a, b)]
    check(not differ, f"{label} L={L}: {differ} differ from the plain tail")
    check(torch.equal(kr.buf, pr.buf) and torch.equal(kr.dev_cursor, pr.dev_cursor),
          f"{label} L={L}: the lane rings or cursors differ from the plain records")
    want = [c + (lane != 1) for lane, c in enumerate(cursors)]
    check(kr.dev_cursor.tolist() == want, f"{label} L={L}: device cursors {kr.dev_cursor.tolist()}")
    check(int((kr.buf[1] != _tel_rings(torch, dev, 1, L)[0].buf[1]).sum()) == 0,
          f"{label} L={L}: the frozen lane's ring was written")
    check(int(kr.k[0, 0]) == -1 and int(kr.k[0, TEL_CAP - 1]) == TEL_CAP - 1,
          f"{label} L={L}: lane 0's record is not at its cursor's slot")


def phase2_tel_kernels(torch, design, y, layout):
    """The TEL instantiations against their plain versions, bit for bit: the
    tail (f32 at the path's shapes, bf16 on a 20,000-feature design; lasso
    and EN; the objective on and off; two chained steps across the wrap
    from the ring's last slot to 0; a renorm), the lane tail at L = 3 and 13
    (a frozen lane, lane 0 wrapping), the replay at K = 8 (a renorm at the
    first record, one coordinate winning twice, a masked tail, the ring
    wrapping inside the chunk); two launches bitwise equal. Returns each
    kernel's max |kernel - plain| (0: bit for bit)."""
    from repro_torch.core import FWConfig
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import step_tail as st
    from repro_torch.kernels.step_tail import ENTail

    t0 = time.perf_counter()
    dev = y.device
    sparse = layout == "sparse"
    p, m = design.shape
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    cfg = FWConfig(delta=5.0)
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.float32:
            mat, pp = ((design.values, design.rows) if sparse else design), p
            win = int(torch.randint(0, p, (1,), generator=g, device=dev))
        else:
            pp, win = (4_000 if sparse else 20_000), 5
            mat = (_tail_ell(torch, g, pp, m, 13, dtype, win, [17, 0, 400]) if sparse
                   else torch.randn((pp, m), generator=g, device=dev).to(dtype))
        yty = torch.tensor(float(torch.dot(y.float(), y.float())), device=dev).to(dtype)
        for en_on in (False, True):
            for objective in (True, False):
                for scale in (1.0, 1.01e-6):  # the second renormalizes
                    beta, args = _tail_args(torch, g, pp, m, dtype, win, scale=scale)
                    en = (ENTail(torch.tensor(-3.25, device=dev), torch.tensor(0.7, device=dev)
                                 .to(dtype), 1.0) if en_on else None)
                    label = (f"TEL tail {layout} {str(dtype)[6:]} {'EN' if en_on else 'lasso'} "
                             f"objective={objective} scale={scale}")
                    _tel_tail_case(torch, st, label, mat, beta, args, cfg, en, objective, yty)
                    n_cases += 1
    mat = (design.values, design.rows) if sparse else design
    yty = torch.dot(y, y)
    for L in (3, TEL_LANES):
        beta, args = _lane_tail_state(torch, g, p, m, torch.float32, L)
        for en_on in (False, True):
            en = (ENTail(torch.randn(L, generator=g, device=dev) * 5,
                         torch.rand(L, generator=g, device=dev) + 0.5, 1.0) if en_on else None)
            _tel_lane_case(torch, st, f"TEL lane tail {layout} {'EN' if en_on else 'lasso'}",
                           mat, beta, args, L, cfg, en, yty)
            n_cases += 1
        del beta, args
    if not sparse:
        _tel_replay_cases(torch, fs, g)
        n_cases += 2
    print(f"[tel] phase 2 {layout}: {n_cases} cases of the TEL kernels bit for bit their plain "
          f"versions, ring words and cursors included, in {time.perf_counter() - t0:.1f} s")
    return {f"{name}{'_sparse' if sparse else ''}": 0.0 for name in TEL_KERNELS}


def _tel_replay_cases(torch, fs, g):
    """The TEL replay at K = 8 against its plain version: a renorm at the
    first record and a coordinate that wins twice, the ring's slots
    TEL_CAP - 3 .. 4 (a wrap inside the chunk); the same records with the
    last 3 masked (k0 near max_iters: no record written for them)."""
    from repro_torch.core import FWConfig
    from repro_torch.kernels.fused_step import ReplayRecord

    dev = g.device
    cfg = FWConfig(delta=50.0, max_iters=1000)
    p = 100_000
    beta0 = torch.randn(p, generator=g, device=dev)
    start = (torch.tensor(3e-6, device=dev), torch.tensor(0.4, device=dev),
             torch.tensor(0.1, device=dev), torch.tensor(2, dtype=torch.int32, device=dev))
    i_stars = torch.randint(0, p, (FUSE,), generator=g, device=dev)
    i_stars[5] = i_stars[2]
    lams = 0.05 + 0.1 * torch.rand(FUSE, generator=g, device=dev)
    lams[0] = 0.75  # 3e-6 * 0.25 < renorm_threshold
    dts = torch.where(torch.rand(FUSE, generator=g, device=dev) < 0.5, -50.0, 50.0)
    nps = torch.rand(FUSE, generator=g, device=dev) < 0.3
    for k0, live in ((10, FUSE), (cfg.max_iters - 5, 5)):
        outs = []
        for route in ("kernel", "kernel", "plain"):
            (r,) = _tel_rings(torch, dev, 1)
            rec = ReplayRecord(r.buf, TEL_CAP, TEL_CAP - 3, 5_000_000, 42_723)
            fn = fs.fused_replay if route == "kernel" else fs.fused_replay_plain
            got = fn(beta0.clone(), *start, i_stars, lams, dts, nps, k0, cfg, rec)
            outs.append((got, r))
        (a, ra), (b, rb), (c, rc) = outs
        same = all(torch.equal(x.reshape(-1), y_.reshape(-1)) for x, y_ in zip(a, c))
        check(same and torch.equal(ra.buf, rc.buf),
              f"TEL replay k0={k0}: outputs or ring words differ from the plain replay")
        check(all(torch.equal(x.reshape(-1), y_.reshape(-1)) for x, y_ in zip(a, b))
              and torch.equal(ra.buf, rb.buf), f"TEL replay k0={k0}: two launches differ")
        written = int((ra.k != -1).sum())
        check(written == live and int(ra.k[TEL_CAP - 3]) == k0 and bool(torch.isnan(
            ra.objective[TEL_CAP - 3])), f"TEL replay k0={k0}: {written} records, {live} live")
        check(int(ra.n_dots[(TEL_CAP - 3 + live - 1) % TEL_CAP]) == 5_000_000 + live * 42_723,
              f"TEL replay k0={k0}: n_dots of the last record")
    print("[tel] replay K=8: a renorm at the first record, a coordinate winning twice, the ring "
          "wrapping inside the chunk, a masked tail of 3 records: bit for bit its plain version")


def _tel_path_points(torch, design, y, deltas, cfg, on_step=None):
    from repro_torch.core import fw_path

    return fw_path(design, y, deltas, cfg, seed=0, device=design.device, on_step=on_step)


def phase3_obs(torch, design, y, coef, layout):
    """The first TEL_POINTS points of the path's grid with telemetry,
    tracing and metrics on, against the same points with all of it off.
    Dense: unfused on 'kernels' with a ring of TEL_CAP streaming to a sink
    (the trajectory bit for bit the off one, the kernels' launches those of
    the off run with the TEL tail in the plain tail's place, every record
    once and in order at the sink, each point's last objective its
    result's, a valid Chrome trace with a point span each, the registry's
    totals the path's), then the elastic-net's first point unfused and a
    chunk of 3 EN lanes (the EN TEL tails), then one batched chunk of
    TEL_LANES lasso lanes, each lane's ring bitwise its sequential solve's
    ring on the rows it drew. Both layouts: the same points fused at K = 8
    with record_objective=False (the TEL replay: one record a live step,
    NaN objectives, the cursor the iteration count). Returns the TEL
    kernels' launches."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import LASSO, ENOracle, LaneSampler, StreamSampler, delta_grid, engine
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.obs import (MetricsRegistry, TelemetrySpec, Tracer, register_sink,
                                 ring_to_records, unregister_sink, use_registry, use_tracer,
                                 validate_chrome_trace)

    t0 = time.perf_counter()
    p = design.shape[0]
    sparse = layout == "sparse"
    deltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=N_POINTS)[:TEL_POINTS]
    launches = {name: 0 for name in TEL_KERNELS}

    def add_launches():
        for name in TEL_KERNELS:
            launches[name] += kernels.launch_counts()[name]

    if not sparse:
        cfg = main_config(p, "kernels")
        off_rec = Recorder(TEL_POINTS)
        kernels.reset_launch_counts()
        off = _tel_path_points(torch, design, y, deltas, cfg, off_rec)
        off_launches = kernels.launch_counts()
        spec = TelemetrySpec(capacity=TEL_CAP, stream_to="chip-smoke-sink")
        batches, last = [], {}
        on_rec = Recorder(TEL_POINTS)

        def hook(g, state):
            on_rec(g, state)
            last[g] = state

        tr, reg = Tracer("chip_smoke"), MetricsRegistry()
        register_sink("chip-smoke-sink", batches.append)
        kernels.reset_launch_counts()
        try:
            with use_tracer(tr), use_registry(reg):
                on = _tel_path_points(torch, design, y, deltas,
                                      dataclasses.replace(cfg, telemetry=spec), hook)
        finally:
            unregister_sink("chip-smoke-sink")
        on_launches = kernels.launch_counts()
        add_launches()
        for g, (a, b) in enumerate(zip(off.points, on.points)):
            check((a.iterations, a.n_dots) == (b.iterations, b.n_dots)
                  and torch.equal(off_rec.sequence(g), on_rec.sequence(g))
                  and list(a.alpha_nnz_idx) == list(b.alpha_nnz_idx)
                  and a.alpha_nnz_val.tobytes() == b.alpha_nnz_val.tobytes(),
                  f"[obs] point {g}: the telemetry-on trajectory differs from the off one")
        it = on.total_iters
        want = dict(off_launches, step_tail=0, step_tail_tel=it)
        check(on_launches == want, f"[obs] launches with telemetry on {on_launches}, want {want}")
        check(off_launches["step_tail"] == it and off_launches["step_tail_tel"] == 0,
              "[obs] the telemetry-off run launched a TEL kernel")
        idx = np.concatenate([b_["record_index"] for b_ in batches])
        ks = np.concatenate([b_["k"] for b_ in batches])
        want_idx = np.concatenate([np.arange(pt.iterations) for pt in on.points])
        check(np.array_equal(idx, want_idx) and np.array_equal(ks, want_idx),
              "[obs] the sink did not receive every record once, in order")
        n_flush = sum(len(b_["k"]) == TEL_CAP for b_ in batches)
        # a full ring is flushed every TEL_CAP records, and each point's rest once
        want_batches = sum(pt.iterations // TEL_CAP + (pt.iterations % TEL_CAP > 0)
                           for pt in on.points)
        check(n_flush == sum(pt.iterations // TEL_CAP for pt in on.points)
              and len(batches) == want_batches,
              f"[obs] {len(batches)} sink batches ({n_flush} full), want {want_batches}")
        for g, pt in enumerate(on.points):
            rec = ring_to_records(last[g].tel)
            check(float(rec["objective"][-1]) == pt.objective,
                  f"[obs] point {g}: the last record's objective {rec['objective'][-1]!r} is not "
                  f"the result's {pt.objective!r}")
            check(rec["n_dots"][-1] == pt.n_dots, f"[obs] point {g}: the last record's n_dots")
        check(validate_chrome_trace(tr.to_chrome()) == [], "[obs] invalid Chrome trace")
        spans = tr.span_table()
        check(spans["fw_path/point"]["count"] == TEL_POINTS and spans["fw_path"]["count"] == 1,
              f"[obs] spans {sorted(spans)}")
        lbl = dict(entry="solve", backend="kernels", step_rule="classic")
        check(reg.get("fw_iterations").value(**lbl) == it
              and reg.get("fw_n_dots").value(**lbl) == on.total_dots
              and reg.get("fw_path_point_seconds").snapshot(
                  driver="sequential", backend="kernels")["count"] == TEL_POINTS,
              "[obs] the registry's totals are not the path's")
        print(f"[obs] dense first {TEL_POINTS} points unfused, ring {TEL_CAP} streaming, traced "
              f"and metered: {it} iterations, bit for bit the telemetry-off run; launches "
              f"sampled_scores {on_launches['sampled_scores']}, vertex_argmax "
              f"{on_launches['vertex_argmax']}, step_tail_tel {on_launches['step_tail_tel']} "
              f"(4 a step with the draw); {len(batches)} sink batches ({n_flush} full-ring "
              f"flushes), records in order; point spans {spans['fw_path/point']['count']}, "
              f"point seconds {[round(pt.seconds, 4) for pt in on.points]}")

        # the elastic-net's TEL tails: its first point unfused, then 3 lanes
        en, en_cfg = ENOracle(1.0), dataclasses.replace(cfg, max_iters=TEL_LANE_STEPS)
        runs = []
        for tel in (None, TelemetrySpec(capacity=TEL_CAP)):
            kernels.reset_launch_counts()
            runs.append(engine.solve(en, design, y, dataclasses.replace(en_cfg, telemetry=tel),
                                     TorchSampler(5, design.device), None, float(deltas[0]),
                                     device=design.device))
            if tel is not None:
                add_launches()
        check(_same_bits(torch, runs[0].alpha, runs[1].alpha)
              and runs[1].telemetry.cursor == runs[1].iterations,
              "[obs] the EN point with telemetry differs from the off one")
        for tel in (None, TelemetrySpec(capacity=TEL_CAP)):
            kernels.reset_launch_counts()
            res, _ = engine.solve_batched(en, design, y, dataclasses.replace(en_cfg, telemetry=tel),
                                          LaneSampler(6, 3, design.device), None, deltas,
                                          device=design.device)
            runs.append(res)
            if tel is not None:
                add_launches()
        check(_same_bits(torch, runs[2].alpha, runs[3].alpha)
              and runs[3].telemetry.cursor == runs[3].iterations,
              "[obs] the EN lanes with telemetry differ from the off ones")
        print(f"[obs] EN first point ({runs[1].iterations} steps) and 3 EN lanes "
              f"({runs[3].iterations}): bit for bit telemetry off, cursors = iterations")

        # one batched chunk of TEL_LANES lasso lanes, each lane's ring its
        # sequential solve's on the rows it drew
        lcfg = dataclasses.replace(cfg, max_iters=TEL_LANE_STEPS,
                                   telemetry=TelemetrySpec(capacity=TEL_CAP))
        ldeltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=N_POINTS)[:TEL_LANES]
        rec = LaneRecorder(LaneSampler(8, TEL_LANES, design.device), TEL_LANES)
        kernels.reset_launch_counts()
        res, _ = engine.solve_batched(LASSO, design, y, lcfg, rec, None, ldeltas,
                                      device=design.device)
        add_launches()
        for lane, d in enumerate(ldeltas):
            one = engine.solve(LASSO, design, y, lcfg, StreamSampler(torch.stack(rec.rows[lane])),
                               None, float(d), device=design.device)
            check(one.iterations == res.iterations[lane]
                  and torch.equal(one.telemetry.buf, res.telemetry.buf[lane]),
                  f"[obs] lane {lane}: its ring differs from its sequential solve's")
        print(f"[obs] {TEL_LANES} lanes, iterations {res.iterations}: each lane's ring bitwise "
              "its sequential solve's")

    # the fused route with record_objective off: the TEL replay
    cfg = (sparse_config(p) if sparse else main_config(p, "kernels", fuse_steps=FUSE))
    fspec = TelemetrySpec(capacity=TEL_CAP, record_objective=False)
    last = {}
    kernels.reset_launch_counts()
    fused = _tel_path_points(torch, design, y, deltas, dataclasses.replace(cfg, telemetry=fspec),
                             lambda g, s: last.__setitem__(g, s))
    fl = kernels.launch_counts()
    add_launches()
    chunk = "sparse_fused_chunk" if sparse else "dense_fused_chunk"
    check(fl["fused_replay_tel"] == fl[chunk] and fl["fused_replay"] == 0,
          f"[obs] fused launches {fl}")
    for g, pt in enumerate(fused.points):
        ring = last[g].tel
        rec = ring_to_records(ring)
        check(ring.cursor == pt.iterations and bool(np.all(np.isnan(rec["objective"])))
              and np.array_equal(rec["k"], np.arange(pt.iterations - len(rec["k"]),
                                                     pt.iterations)),
              f"[obs] fused point {g}: cursor {ring.cursor}, iterations {pt.iterations}")
    print(f"[obs] {layout} first {TEL_POINTS} points fused K={FUSE} with record_objective=False: "
          f"{fused.total_iters} records (one a live step), NaN objectives, {fl[chunk]} chunks, "
          f"fused_replay_tel {fl['fused_replay_tel']}; phase 3 {layout} took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase5_tel_timing(torch, design, y, layout):
    """The TEL tail and the TEL replay beside their plain instantiations,
    back to back on the same inputs with CUDA events, and (dense) the lane
    TEL tails at TEL_LANES lanes; then the dense unfused step's wall and
    device time with the ring on and off, alternated (off, on, three times).
    Returns the TEL kernels' timing rows (dense; sparse prints its tail)."""
    from repro_torch.core import FWConfig, engine
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import step_tail as st
    from repro_torch.kernels.fused_step import ReplayRecord
    from repro_torch.kernels.step_tail import ENTail, TailRecord
    from repro_torch.obs import TelemetrySpec

    t0 = time.perf_counter()
    dev = y.device
    sparse = layout == "sparse"
    p, m = design.shape
    mat = (design.values, design.rows) if sparse else design
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    tcfg = FWConfig(delta=5.0)
    win = int(torch.randint(0, p, (1,), generator=gen, device=dev))
    beta, targs = _tail_args(torch, gen, p, m, torch.float32, win)
    yty = torch.dot(y, y)
    (ring,) = _tel_rings(torch, dev, 1)
    rec = TailRecord(ring.buf, TEL_CAP, 7, 7, 1000, True, yty)
    out = {}
    nbytes_tail = (3 * m * 4 + (design.nnz_max * 8 if sparse else m * 4)) + 64

    def row(name, ms, plain_ms, nbytes, flops, note=""):
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by)
        print(f"[timing] {name} {layout}: {ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.6f} ms, library null{note}")

    # the instantiations back to back, each twice, in turns
    t_tel, t_off = [], []
    for _ in range(2):
        t_off.append(_time_queued(torch, lambda i: st.step_tail(mat, beta, *targs, tcfg), 400))
        t_tel.append(_time_queued(torch, lambda i: st.step_tail(mat, beta, *targs, tcfg, tel=rec),
                                  400))
    plain_tel = _time_queued(torch, lambda i: st.step_tail_plain(mat, beta, *targs, tcfg, None,
                                                                 rec), 8)
    print(f"[timing] step_tail {layout} without / with the record, in turns: "
          f"{[round(t, 6) for t in t_off]} / {[round(t, 6) for t in t_tel]} ms")
    row("step_tail_tel", min(t_tel), plain_tel, nbytes_tail + TEL_RECORD_BYTES, 5 * m + 16,
        note=f" [{layout}; the tail's bytes + a {TEL_RECORD_BYTES}-byte record; plain: the "
             "plain tail and record]")
    en = ENTail(torch.tensor(-3.25, device=dev), torch.tensor(0.7, device=dev), 1.0)
    t_en = _time_queued(torch, lambda i: st.step_tail_en(mat, beta, *targs, tcfg, en, tel=rec),
                        400)
    t_en_off = _time_queued(torch, lambda i: st.step_tail_en(mat, beta, *targs, tcfg, en), 400)
    row("step_tail_en_tel", t_en,
        _time_queued(torch, lambda i: st.step_tail_plain(mat, beta, *targs, tcfg, en, rec), 8),
        nbytes_tail + 8 + TEL_RECORD_BYTES, 5 * m + 24,
        note=f" [{layout}; step_tail_en without the record {t_en_off:.6f} ms]")
    if not sparse:
        L = TEL_LANES
        lbeta, largs = _lane_tail_state(torch, gen, p, m, torch.float32, L)
        # no lane renormalizes (lane 0's scale above the threshold's reach), so
        # the times are the steady step's, not a renorm's pass over beta
        largs = (torch.full_like(largs[0], 0.9),) + largs[1:]
        ids = torch.arange(L, dtype=torch.int32, device=dev)
        (lring,) = _tel_rings(torch, dev, 1, L)
        lrec = TailRecord(lring.buf, TEL_CAP, 0, 0, 1000, True, yty, [0] * L, lring.dev_cursor)
        t_l = _time_queued(torch, lambda i: st.step_tail_lanes(mat, lbeta, *largs, ids, tcfg,
                                                               tel=lrec), 200)
        t_l_off = _time_queued(torch, lambda i: st.step_tail_lanes(mat, lbeta, *largs, ids, tcfg),
                               200)
        row("step_tail_lanes_tel", t_l,
            _time_queued(torch, lambda i: st.step_tail_lanes_plain(
                mat, lbeta, *largs, ids, tcfg, None, lrec._replace(cursors=[0] * L)), 1),
            L * (4 * m * 4 + 64 + TEL_RECORD_BYTES), L * 5 * m,
            note=f" [dense, {L} lanes; step_tail_lanes without the records {t_l_off:.6f} ms]")
        len_ = ENTail(torch.randn(L, generator=gen, device=dev),
                      torch.rand(L, generator=gen, device=dev) + 0.5, 1.0)
        t_le = _time_queued(torch, lambda i: st.step_tail_en_lanes(mat, lbeta, *largs, ids, tcfg,
                                                                   len_, tel=lrec), 200)
        row("step_tail_en_lanes_tel", t_le,
            _time_queued(torch, lambda i: st.step_tail_lanes_plain(
                mat, lbeta, *largs, ids, tcfg, len_, lrec._replace(cursors=[0] * L)), 1),
            L * (4 * m * 4 + 72 + TEL_RECORD_BYTES), L * 5 * m, note=f" [dense, {L} lanes]")
        del lbeta, largs
        # the replay at K = 8, with and without its records, in turns
        rcfg = FWConfig(delta=50.0, max_iters=10**9)
        rbeta = torch.randn(p, generator=gen, device=dev)
        start = (torch.tensor(1.0, device=dev), torch.tensor(0.4, device=dev),
                 torch.tensor(0.1, device=dev), torch.tensor(2, dtype=torch.int32, device=dev))
        recs = (torch.randint(0, p, (FUSE,), generator=gen, device=dev),
                torch.full((FUSE,), 0.01, device=dev), torch.full((FUSE,), -50.0, device=dev),
                torch.zeros(FUSE, dtype=torch.bool, device=dev))
        rrec = ReplayRecord(ring.buf, TEL_CAP, 0, 0, 1000)
        r_tel, r_off = [], []
        for _ in range(2):
            r_off.append(_time_queued(torch, lambda i: fs.fused_replay(rbeta, *start, *recs, 0,
                                                                       rcfg), 400))
            r_tel.append(_time_queued(torch, lambda i: fs.fused_replay(rbeta, *start, *recs, 0,
                                                                       rcfg, rrec), 400))
        print(f"[timing] fused_replay K={FUSE} without / with the records, in turns: "
              f"{[round(t, 6) for t in r_off]} / {[round(t, 6) for t in r_tel]} ms")
        row("fused_replay_tel", min(r_tel),
            _time_queued(torch, lambda i: fs.fused_replay_plain(rbeta, *start, *recs, 0, rcfg,
                                                                rrec), 4),
            FUSE * (8 + 4 + 4 + 1 + 2 * 4 + TEL_RECORD_BYTES) + 16, FUSE * 12,
            note=f" [K={FUSE}, no renorm; bytes: the records, beta at the winners, "
                 f"{TEL_RECORD_BYTES} bytes a ring record]")
        del rbeta
        # the dense unfused step, ring off and on, alternated
        cfg = main_config(p, "kernels")
        stats = engine.precompute_colstats(design, y, cfg)
        delta = torch.tensor(50.0, device=dev)
        on_cfg = dataclasses.replace(cfg, telemetry=TelemetrySpec(capacity=TEL_CAP))
        walls = {"off": [], "on": []}
        for tag, c in (("off", cfg), ("on", on_cfg)) * 3:
            walls[tag].append(unfused_step_wall_ms(torch, design, y, stats, c, delta))
        busy = {tag: _device_busy_ms(torch, design, y, stats, dataclasses.replace(
            c, tol=0.0, patience=10**9), delta, 200) for tag, c in (("off", cfg), ("on", on_cfg))}
        mean = {tag: sum(v) / len(v) for tag, v in walls.items()}
        print(f"[timing] dense unfused step wall, ring off / on, alternated: {walls['off']} / "
              f"{walls['on']} ms, means {mean['off']!r} / {mean['on']!r} (on/off "
              f"{mean['on'] / mean['off']:.4f}); device busy off {busy['off']} / on {busy['on']} "
              "ms a step")
    print(f"[tel] phase 5 {layout} took {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# resilience: the health check kernel, the guarded solve and its ladder,
# path checkpoint/resume, and the coo-npz-v1 shards at E2006-log1p's size
# --------------------------------------------------------------------------

HEALTH_RAGGED = (37, 803)  # a ragged small (p, m) beside each path's own
RES_POINTS = 3  # the first grid points the guarded and checkpointed paths run
RES_FAULT_AT = 2  # the fault's occurrence: the path's third guard chunk
RES_BATCH_POINTS = 2 * LANE_WIDTH  # the batched checkpoint: 13 lanes, 2 chunks


def _health_state(torch, g, p, m, dtype):
    """beta, scale, and a lasso co-state (residual, S, F) on the card."""
    dev = torch.device("cuda")
    beta = torch.randn(p, generator=g, device=dev).to(dtype)
    co = [torch.randn(m, generator=g, device=dev).to(dtype),
          torch.tensor(30.0, device=dev).to(dtype), torch.tensor(10.0, device=dev).to(dtype)]
    return beta, torch.tensor(0.5, device=dev).to(dtype), co


def phase2_health(torch, sizes, label):
    """``health_flags`` against its plain version at each (p, m) of
    ``sizes``, f32 and bf16: a clean state, and NaN, +Inf and -Inf at the
    first, a middle and the last element of beta and of the residual and in
    each scalar (scale, S, F); equal flags, twice each, with equal bits."""
    from repro_torch.kernels import health

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(31)
    stall = torch.tensor(6, dtype=torch.int32, device="cuda")
    n_cases = 0
    for p, m in sizes:
        for dtype in (torch.float32, torch.bfloat16):
            beta, scale, co = _health_state(torch, g, p, m, dtype)
            tensors = [beta, scale] + co
            cases = [(None, None, 0.0)]
            for t, arr in enumerate(tensors):
                places = (0, arr.numel() // 2, arr.numel() - 1) if arr.dim() else (None,)
                cases += [(t, i, v) for i in places
                          for v in (float("nan"), float("inf"), float("-inf"))]
            for t, i, v in cases:
                old = None
                if t is not None:
                    arr = tensors[t]
                    old = arr.clone() if i is None else arr[i].clone()
                    if i is None:
                        arr.fill_(v)
                    else:
                        arr[i] = v
                args = (tensors[0], tensors[1], tensors[2:], stall)
                want = health.health_flags_plain(*args)
                got = [health.health_flags(*args) for _ in range(2)]
                torch.cuda.synchronize()
                check(_same_bits(torch, got[0], want) and _same_bits(torch, got[1], want),
                      f"health_flags {label} p={p} m={m} {dtype} case {(t, i, v)}: "
                      f"{got[0].tolist()}/{got[1].tolist()} against plain {want.tolist()}")
                if t is not None:
                    if i is None:
                        tensors[t].copy_(old)
                    else:
                        tensors[t][i] = old
                n_cases += 1
            del beta, tensors
    print(f"[health] {label}: health_flags equal to its plain version (twice each, equal "
          f"bits) on {n_cases} cases at (p, m) = {sizes}, f32 and bf16 "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"health_flags" if label == "dense" else "health_flags_sparse": 0.0}


def _guard_path(torch, Xt, y, deltas, cfg, rec, plan=None):
    """``fw_path`` through the guarded solve (GuardSpec defaults), recording
    each point's kept turns; with ``plan`` under that fault plan. Returns the
    path, the registry's guard counters and the launches."""
    import functools

    from repro_torch import kernels
    from repro_torch.core import fw_path
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.resilience import faults, guards

    calls = [0]

    def solve(oracle, X, yv, c, sampler, a0, d):
        g = calls[0]
        calls[0] += 1
        return guards.solve_resilient(oracle, X, yv, c, sampler, a0, d, device=X.device,
                                      on_step=functools.partial(rec, g))

    reg = obs_metrics.MetricsRegistry()
    kernels.reset_launch_counts()
    with obs_metrics.use_registry(reg):
        if plan is None:
            res = fw_path(Xt, y, deltas, cfg, seed=0, device=Xt.device, solve_fn=solve)
        else:
            with faults.inject(plan):
                res = fw_path(Xt, y, deltas, cfg, seed=0, device=Xt.device, solve_fn=solve)
    launches = kernels.launch_counts()
    counters = {}
    for name in ("fw_guard_checks", "fw_guard_trips", "fw_guard_recoveries",
                 "fw_guard_unrecovered"):
        fam = reg.get(name)
        counters[name] = {} if fam is None else {
            ",".join(f"{k}={v}" for k, v in key): val for key, val in fam.series()}
    return res, counters, launches


def _points_equal(torch, a, b, n):
    """The first ``n`` points of two paths: support, values' bits,
    iterations, n_dots and the objective equal."""
    import numpy as np

    for g in range(n):
        pa, pb = a.points[g], b.points[g]
        if not (np.array_equal(pa.alpha_nnz_idx, pb.alpha_nnz_idx)
                and pa.alpha_nnz_val.tobytes() == pb.alpha_nnz_val.tobytes()
                and (pa.iterations, pa.n_dots, pa.objective)
                == (pb.iterations, pb.n_dots, pb.objective)):
            return False
    return True


def _sequences_equal(torch, ra, rb, n):
    return all(torch.equal(ra.sequence(g), rb.sequence(g)) for g in range(n))


def phase3_guarded(torch, Xt, y, main, fused):
    """The guarded solve (``resilience.guards.resilient_solve_fn``,
    GuardSpec defaults: a check every 8 turns) on the dense path's first
    RES_POINTS points, fused (K = 8) and unfused: with no fault, bit for bit
    the unguarded path (vertices, alpha bits, iterations), one health_flags
    launch a check, no trip; then co_nan at the RES_FAULT_AT-th guard chunk
    healed at rung 1 (the co-state rebuilt from X @ alpha: the unguarded
    run to rounding) and beta_nan there healed at rung 2 (the chunk again
    from the snapshot, K unfused steps on the same kernels) bit for bit the
    unguarded run, fused also at guard chunk 1, which holds point 0's first
    S/F refresh (the retried chunk sums it with cuBLAS where K4 sums in its
    fixed order; on this data the two round alike). Rung 3 never fires;
    forced (the retry patched to come back NaN), it raises
    UnrecoverableFaultError on the card, counted as unrecovered, and no
    plain version runs. Returns the no-fault fused run's launches."""
    from repro_torch.core import LASSO
    from repro_torch.core.path import point_seed
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.resilience import faults, guards

    t0 = time.perf_counter()
    n = RES_POINTS
    deltas = main["deltas"][:n]
    out = {}
    for tag, ref, cfg in (("fused", fused, fused["cfg"]), ("unfused", main, main["cfg"])):
        rec = Recorder(n)
        res, counters, launches = _guard_path(torch, Xt, y, deltas, cfg, rec)
        checks = sum(counters["fw_guard_checks"].values())
        print(f"[guard] {tag} no fault: iterations {[pt.iterations for pt in res.points]}, "
              f"counters {counters}, health_flags launches {launches['health_flags']}, "
              f"{res.total_seconds:.3f} s")
        check(_points_equal(torch, res, ref["res"], n) and _sequences_equal(torch, rec, ref["rec"],
                                                                           n),
              f"guard {tag}: the guarded path is not the unguarded one bit for bit")
        check(launches["health_flags"] == checks > 0,
              f"guard {tag}: health_flags launches {launches['health_flags']} != checks {checks}")
        check(not counters["fw_guard_trips"] and not counters["fw_guard_recoveries"],
              f"guard {tag}: a trip or a recovery without a fault: {counters}")
        if tag == "fused":
            out = launches
        faults_run = [("co_nan", "rebuild_co", RES_FAULT_AT),
                      ("beta_nan", "retry_chunk", RES_FAULT_AT)]
        if tag == "fused":
            # guard chunk 1 holds k = 64..127 of point 0: the S/F refresh at
            # k = 127 runs in the retried chunk's unfused steps
            faults_run.append(("beta_nan", "retry_chunk", 1))
        for kind, rung, at in faults_run:
            plan = faults.FaultPlan([faults.FaultSpec(kind=kind, at=at)], seed=7)
            frec = Recorder(n)
            fres, fcounters, _ = _guard_path(torch, Xt, y, deltas, cfg, frec, plan)
            reason = "nonfinite_co" if kind == "co_nan" else "nonfinite_beta"
            print(f"[guard] {tag} {kind} at guard chunk {at}: fired {plan.fired()}, "
                  f"counters {fcounters}")
            check(len(plan.fired(kind)) == 1, f"guard {tag}: {kind} did not fire once")
            check(fcounters["fw_guard_trips"] == {f"backend=kernels,reason={reason}": 1.0}
                  and fcounters["fw_guard_recoveries"] == {f"backend=kernels,rung={rung}": 1.0},
                  f"guard {tag} {kind}: healed otherwise than at {rung}: {fcounters}")
            bits = _points_equal(torch, fres, ref["res"], n) and _sequences_equal(
                torch, frec, ref["rec"], n)
            print(f"[guard] {tag} {kind} healed at {rung}; backend_fallback 0; bit for bit the "
                  f"unguarded path: {bits}")
            if kind == "beta_nan":
                check(bits, f"guard {tag} beta_nan at guard chunk {at}: the retried chunk is "
                            "not the unguarded run bit for bit")
            elif not bits:
                # against the unfused path, which recorded every step's
                # residual: the same trajectory up to a near-tie
                _compare_paths(torch, Xt, y, deltas, cfg.kappa,
                               dict(label=f"guarded {tag} {kind}", res=fres, rec=frec),
                               dict(label="unfused", res=main["res"], rec=main["rec"]),
                               max_overshoot=FUSE - 1 if tag == "fused" else 0)

    def poisoned_retry(oracle, X, yv, stats, state, c, d, n_turns, sampler, turns=None):
        out = guards._advance(oracle, X, yv, stats, state, c, d, n_turns, sampler, True, turns)
        return out._replace(beta=torch.full_like(out.beta, float("nan")))

    reg = obs_metrics.MetricsRegistry()
    plan = faults.FaultPlan([faults.FaultSpec(kind="beta_nan", at=1)], seed=7)
    retry, guards._retry_chunk = guards._retry_chunk, poisoned_retry
    raised = None
    try:
        with obs_metrics.use_registry(reg), faults.inject(plan):
            guards.solve_resilient(LASSO, Xt, y, fused["cfg"],
                                   TorchSampler(point_seed(0, 0), Xt.device), None,
                                   float(deltas[0]), device=Xt.device)
    except guards.UnrecoverableFaultError as err:
        raised = str(err)
    finally:
        guards._retry_chunk = retry
    recov = reg.get("fw_guard_recoveries")
    unrec = reg.get("fw_guard_unrecovered")
    print(f"[guard] rung 3 forced on the card (the retry patched to NaN): raised {raised!r}")
    check(raised is not None and "backend: kernels" in raised and "nonfinite_beta" in raised,
          f"guard: a forced rung 3 on the card did not raise naming the backend: {raised!r}")
    check(unrec is not None and unrec.value(backend="kernels") == 1.0
          and (recov is None or not recov.series()),
          "guard: a forced rung 3 was not counted as unrecovered, or something recovered")
    print(f"[guard] phase 3 took {time.perf_counter() - t0:.1f} s")
    return out


def _killed(fn):
    """Run ``fn`` under its kill plan; it must stop with InjectedKill."""
    from repro_torch.resilience import faults

    try:
        fn()
    except faults.InjectedKill as err:
        print(f"[ckpt] {err}")
        return
    check(False, "the kill plan did not stop the path")


def phase3_checkpoints(torch, Xt, y, main, fused, batched):
    """Kill and resume on the card: ``fw_path`` (fused K = 8) over the first
    RES_POINTS points killed at point 1, then resumed from its checkpoint:
    bit for bit the uninterrupted path's points; ``fw_path_batched`` in
    lanes of 13 over 2 chunks killed at chunk 1 and resumed, f32 (against
    the batched path's first 26 points) and bf16 (against its own
    uninterrupted run): bit for bit, saved_iters and totals included."""
    import shutil
    import tempfile

    from repro_torch.core import fw_path, fw_path_batched
    from repro_torch.resilience import faults

    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="repro_ckpt_"))
    try:
        deltas = main["deltas"][:RES_POINTS]
        cfg = fused["cfg"]
        ck = str(root / "fw_path")

        def killed_path():
            plan = faults.FaultPlan([faults.FaultSpec(kind="kill", at=1)], seed=0)
            with faults.inject(plan):
                fw_path(Xt, y, deltas, cfg, seed=0, device=Xt.device, checkpoint_dir=ck)

        _killed(killed_path)
        res = fw_path(Xt, y, deltas, cfg, seed=0, device=Xt.device, checkpoint_dir=ck,
                      resume_from=ck)
        check(_points_equal(torch, res, fused["res"], RES_POINTS),
              "fw_path resumed after a kill at point 1 is not the uninterrupted path")
        print(f"[ckpt] fw_path fused K={FUSE}: killed at point 1, resumed; points 0-"
              f"{RES_POINTS - 1} bit for bit the uninterrupted path "
              f"({[pt.iterations for pt in res.points]} iterations)")

        bdeltas = main["deltas"][:RES_BATCH_POINTS]
        bcfg = main["cfg"]
        for dtype in (torch.float32, torch.bfloat16):
            X, yv = (Xt, y) if dtype == torch.float32 else (Xt.to(dtype), y.to(dtype))
            ckb = str(root / f"batched-{dtype}")
            if dtype == torch.float32:
                clean = batched["res"]
            else:
                clean = fw_path_batched(X, yv, bdeltas, bcfg, seed=0, lane_width=LANE_WIDTH,
                                        device=X.device)

            def killed_batched():
                plan = faults.FaultPlan([faults.FaultSpec(kind="kill", at=1)], seed=0)
                with faults.inject(plan):
                    fw_path_batched(X, yv, bdeltas, bcfg, seed=0, lane_width=LANE_WIDTH,
                                    device=X.device, checkpoint_dir=ckb)

            _killed(killed_batched)
            res = fw_path_batched(X, yv, bdeltas, bcfg, seed=0, lane_width=LANE_WIDTH,
                                  device=X.device, checkpoint_dir=ckb, resume_from=ckb)
            check(_points_equal(torch, res, clean, RES_BATCH_POINTS),
                  f"fw_path_batched {dtype} resumed after a kill at chunk 1 is not the "
                  "uninterrupted path")
            if dtype != torch.float32:
                check((res.saved_iters, res.total_dots, res.total_iters)
                      == (clean.saved_iters, clean.total_dots, clean.total_iters),
                      f"fw_path_batched {dtype}: resumed totals differ")
            print(f"[ckpt] fw_path_batched {dtype} lanes of {LANE_WIDTH}, 2 chunks: killed at "
                  f"chunk 1, resumed; {RES_BATCH_POINTS} points bit for bit the uninterrupted "
                  f"run ({res.total_iters} lane-iterations, saved_iters {res.saved_iters})")
            del X, yv
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[ckpt] phase 3 took {time.perf_counter() - t0:.1f} s")


def _digest(torch, *tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _slot_sets(torch, mat):
    """Each stored nonzero as (feature * m + row, value), sorted by key:
    the matrix's (row, value) sets column for column, whatever the slot
    order."""
    vals = mat.values.reshape(-1)
    keep = vals != 0
    feat = torch.arange(mat.p_padded, device=vals.device).repeat_interleave(mat.nnz_max)[keep]
    key = feat * mat.m + mat.rows.reshape(-1)[keep].long()
    key, order = torch.sort(key)
    return key, vals[keep][order]


def phase3_shards(torch, mat, y, fused):
    """The E2006-log1p proxy's triplets (all of them) written as coo-npz-v1
    shards to a temporary directory, read back through
    ``load_shards_as_matrix(device='cuda')`` (pass 1 counts on the host,
    pass 2 fills the block-ELL slots on the card): the loaded matrix holds
    the proxy's (row, value) sets column for column and the proxy's bits
    wherever the slot orders agree (digests printed); the first fused
    point on it is bit for bit the in-memory one's; one shard_corrupt heals
    through the retry (fw_shard_retries 1). Each pass's seconds and GB/s
    are printed; the directory is removed."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import fw_path
    from repro_torch.obs import Tracer, use_tracer
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.resilience import faults
    from repro_torch.sparse import io as sio

    t0 = time.perf_counter()
    dev = mat.device
    nnz = int(torch.count_nonzero(mat.values))
    need = nnz * (4 + 8 + 4) + mat.m * 4  # rows int32, cols int64, vals f32, y
    root = tempfile.mkdtemp(prefix="repro_shards_")
    try:
        free = shutil.disk_usage(root).free
        check(free >= 2 * need, f"the shard phase needs {2 * need:,} bytes free in {root} "
                                f"(twice the {need:,} bytes of shards), has {free:,}")
        vals = mat.values.reshape(-1)
        keep = vals != 0
        feat = torch.arange(mat.p_padded, device=dev).repeat_interleave(mat.nnz_max)[keep]
        rows = mat.rows.reshape(-1)[keep].long()
        order = torch.argsort(rows * mat.p + feat)  # (row, feature) order: unique keys
        coo = sio.COOData(rows[order].cpu().numpy(), feat[order].cpu().numpy(),
                          vals[keep][order].cpu().numpy(), y.cpu().numpy(), (mat.m, mat.p))
        del feat, rows, order, keep
        t1 = time.perf_counter()
        sio.write_shards(root, coo)
        t_write = time.perf_counter() - t1
        del coo
        manifest = sio.read_manifest(root)
        nbytes = sum(os.path.getsize(os.path.join(root, f)) for f in manifest["shards"])
        print(f"[shards] {nnz:,} triplets of the E2006-log1p proxy in {len(manifest['shards'])} "
              f"shards of {manifest['rows_per_shard']} rows, {nbytes:,} bytes; extracted in "
              f"{t1 - t0:.2f} s; written (sha256 included) in {t_write:.2f} s, "
              f"{nbytes / t_write / 1e9:.3f} GB/s; {free:,} bytes were free")
        tracer = Tracer("shards")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with use_tracer(tracer):
            loaded, y2 = sio.load_shards_as_matrix(root, block_size=mat.block_size, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t1
        spans = tracer.span_table()
        t_count = spans["sparse_io/count_pass"]["total_s"]
        t_fill = t_load - t_count
        print(f"[shards] load_shards_as_matrix(device='cuda'): {t_load:.2f} s; pass 1 (host "
              f"bincount) {t_count:.2f} s, {nbytes / t_count / 1e9:.3f} GB/s; pass 2 (device "
              f"fill) {t_fill:.2f} s, {nbytes / t_fill / 1e9:.3f} GB/s; nnz_max "
              f"{loaded.nnz_max} (proxy {mat.nnz_max})")
        check((loaded.p, loaded.m, loaded.block_size) == (mat.p, mat.m, mat.block_size),
              "the loaded matrix's geometry differs")
        check(_same_bits(torch, y2, y), "the loaded y differs from the proxy's")
        ka, va = _slot_sets(torch, mat)
        kb, vb = _slot_sets(torch, loaded)
        check(torch.equal(ka, kb) and _same_bits(torch, va, vb),
              "the loaded matrix's (row, value) sets differ from the proxy's")
        del ka, va, kb, vb
        same_geom = loaded.nnz_max == mat.nnz_max
        in_place = same_geom and torch.equal(loaded.rows, mat.rows)
        if same_geom:
            agree = loaded.rows == mat.rows
            check(torch.equal(loaded.values[agree], mat.values[agree]),
                  "values differ where the slot orders agree")
            share = float(agree.float().mean())
            del agree
        else:
            share = 0.0
        print(f"[shards] the loaded matrix holds the proxy's (row, value) sets column for "
              f"column; slot orders agree on {100 * share:.4f}% of slots (the same arrays: "
              f"{in_place}); digests values+rows: proxy {_digest(torch, mat.values, mat.rows)}, "
              f"loaded {_digest(torch, loaded.values, loaded.rows)}")
        res = fw_path(loaded, y2, fused["deltas"][:1], fused["cfg"], seed=0, device=dev)
        check(_points_equal(torch, res, fused["res"], 1),
              "the fused point on the loaded matrix is not the in-memory one")
        print(f"[shards] fused point 0 on the loaded matrix: bit for bit the in-memory one "
              f"({res.points[0].iterations} iterations, objective {res.points[0].objective!r})")
        del loaded
        first = manifest["shards"][0]
        clean = next(sio.iter_shards_for_rows(root, 0, 1))[0]
        reg = obs_metrics.MetricsRegistry()
        plan = faults.FaultPlan([faults.FaultSpec(kind="shard_corrupt", site=first)], seed=5)
        with obs_metrics.use_registry(reg), faults.inject(plan):
            healed = next(sio.iter_shards_for_rows(root, 0, 1))[0]
        retries = reg.get("fw_shard_retries").value(shard=first)
        failures = reg.get("fw_shard_checksum_failures").value(shard=first)
        check(retries == 1.0 and failures == 1.0 and all(
            np.array_equal(a, b) for a, b in zip(clean[:4], healed[:4])),
            f"shard_corrupt on {first}: retries {retries}, failures {failures}")
        print(f"[shards] shard_corrupt on {first}: checksum failures {failures:g}, "
              f"fw_shard_retries {retries:g}, the healed read equals the clean one")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[shards] phase 3 took {time.perf_counter() - t0:.1f} s")


def phase5_resilience_timing(torch, Xt, y, main, fused):
    """``health_flags`` beside its plain version and its byte bound at the
    dense path's width (CUDA events, queued); the snapshot's copy time;
    and the dense fused first point unguarded, guarded, and guarded with
    the check patched to its plain version, alternated three times (wall,
    synchronized)."""
    from repro_torch.core import LASSO, engine
    from repro_torch.core.path import point_seed
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import health
    from repro_torch.resilience import guards

    t0 = time.perf_counter()
    p, m = Xt.shape
    dev = Xt.device
    g = torch.Generator(device=dev)
    g.manual_seed(37)
    beta, scale, co = _health_state(torch, g, p, m, torch.float32)
    stall = torch.tensor(0, dtype=torch.int32, device=dev)
    args = (beta, scale, co, stall)
    ms = min(_time_queued(torch, lambda i: health.health_flags(*args), 400) for _ in range(2))
    plain_ms = _time_queued(torch, lambda i: health.health_flags_plain(*args), 40)
    nbytes = p * 4 + 4 + m * 4 + 8 + 4 + 12
    bound_ms, bound_by = _bound(nbytes, p + m + 3)
    print(f"[timing] health_flags dense p={p:,} m={m}: {ms:.6f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}, {100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.6f} ms, "
          "library null")
    state = engine.init_state(LASSO, Xt, y, None, fused["cfg"])
    snap = guards._Snapshot()
    snap_ms = _time_queued(torch, lambda i: snap.take(state), 200)
    print(f"[timing] the guard's snapshot of a dense state (beta {p:,} f32, the residual and "
          f"7 scalars): {snap_ms:.6f} ms a chunk, {2 * (p + m) * 4 / snap_ms / 1e6:.1f} GB/s")
    del beta, co, state, snap
    cfg = fused["cfg"]
    d = float(main["deltas"][0])
    # "guarded_plain": the guard with its check patched to the plain
    # version, to weigh the kernel's share of the guard's cost
    walls = {"unguarded": [], "guarded": [], "guarded_plain": []}
    kernel_check = health.health_flags
    for tag in ("unguarded", "guarded", "guarded_plain") * 3:
        sampler = TorchSampler(point_seed(0, 0), dev)
        health.health_flags = health.health_flags_plain if tag == "guarded_plain" else kernel_check
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if tag == "unguarded":
                res = engine.solve(LASSO, Xt, y, cfg, sampler, None, d, device=dev)
            else:
                res = guards.solve_resilient(LASSO, Xt, y, cfg, sampler, None, d, device=dev)
            float(res.objective)
            torch.cuda.synchronize()
        finally:
            health.health_flags = kernel_check
        walls[tag].append(time.perf_counter() - t1)
    mean = {tag: sum(v) / len(v) for tag, v in walls.items()}
    print(f"[timing] dense fused point 0 ({res.iterations} iterations, K={FUSE}), unguarded / "
          f"guarded / guarded with the plain check, alternated: {walls['unguarded']} / "
          f"{walls['guarded']} / {walls['guarded_plain']} s, means {mean['unguarded']!r} / "
          f"{mean['guarded']!r} / {mean['guarded_plain']!r} (guarded/unguarded "
          f"{mean['guarded'] / mean['unguarded']:.4f}, plain check/unguarded "
          f"{mean['guarded_plain'] / mean['unguarded']:.4f})")
    print(f"[timing] resilience phase 5 took {time.perf_counter() - t0:.1f} s")
    return {"health_flags": dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                                 bound_by=bound_by)}


if __name__ == "__main__":
    sys.exit(main())
