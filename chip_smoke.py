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
   argmax launches equal, the lane argmax's routes (one cluster of 16
   CTAs a lane, and the grid-wide ticket route) bitwise equal, the
   renorm in one lane only, bf16 and K5's warp-per-feature route at L = 3;
   the elastic-net's instantiations at each path's shapes: K2's argmax
   with the score shift (n = kappa with f32 and bf16 beta, n = p, a shift
   that turns the winner, raw scores all zero, a padded index whose
   shifted score would win; L = 1, 3, 13, each lane bitwise its one-lane
   launch, on the cluster route with no support bitmap, an exact one and a
   strict superset, each bitmap updated with its winners, on the ticket
   route with none (a bitmap refused there); at 13 lanes -0.0 raw
   scores and beta, an infinite and a NaN scale, every index masked,
   'full' sampling's shared ids and bf16 beta), bit for bit; the EN tail
   in f32 and bf16 (a renorm, lam near 1, the same coordinate twice; 13
   lanes), bit for bit; K4 or K7 with
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
   the baselines' CD sweep (dense path only): the screened sweep (the
   score pass ``cd_score``, then the walker ``cd_walk``) against the
   unscreened kernel ``cd_sweep_unscreened`` bit for bit (alpha up to a
   zero's sign, R and max |d| bitwise) and against the plain versions
   (the screened plain sweep bit for bit the plain loop): cyclic and
   stochastic orders (a row repeated inside the ring's window and back to
   back), m = 74, 186, 800 (the residual in registers), 20,000 (in shared
   memory) and 60,000 (past the on-chip cap, in device memory), lam = 0,
   lam above lam_max (nothing moves: R keeps its bits), a warm start
   thresholded on the way, a zero column, near-ties (rows within ulps of
   lam before and after the moves), f32 and bf16, a re-base after every
   idle survivor; alpha and R within TOL_CD of the plain versions, the
   support up to named near-ties, two runs bitwise equal;
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
     one-lane kernels never; after the timed path, its first chunk solved
     again bit for bit the path's, and its 13 lanes each bit for bit a
     sequential solve on the rows it drew (this and the elastic-net's);
   - the extension oracles (paper §6, the reference's family section): the
     elastic-net (``ENOracle(l2=1.0)``) over the first 50 points of the
     same grid on each layout, fused at K = 8 (K4 or K7 with the ledger, once a chunk),
     its first 3 points one step per dispatch (the shifted argmax and the
     EN tail once a step) and batched in lanes of 13 (each batched solve's
     last state kept, and after the path the lanes' support bitmap checked
     to cover beta: its set bits printed beside the nonzeros); the logistic
     oracle
     (labels sign(y) + (y == 0), max_iters 2000, tol 1e-4) over a 10-point
     grid, its first 2 points sequential and in one chunk of 2 lanes on the
     sparse layout, the first 3 on the dense one; each path's launches, l1 <= delta and
     its densest point's certified gap with the oracle's own gradient;
   - the baselines (dense path): constrained FISTA (500 iterations, tol
     1e-3) at the main path's densest delta, whose FW objective minus
     FISTA's must lie within FW's certified gap; cyclic CD at the dense
     width (200 sweeps, tol 1e-3) down its 100-point lambda grid, 3 to 10
     points as its budget allows, each certified by its duality gap
     (within 1e-3), penalized FISTA (300 iterations) within 1e-3 of it and
     the FW path at CD's l1 norms beside it, and the walker bit for bit
     the unscreened kernel on the design's first 201,376 rows; and on
     Pyrim at its published size (m = 74, p = 201,376, built by
     ``make_proxy``) the first 10 points of a 100-point lambda grid under
     cyclic CD, the first 3 under stochastic CD, the 10 under penalized
     FISTA (500 iterations) and the FW path at the CD points' l1 norms
     (paper §2.1): walker launches = sweeps + re-bases (a score pass each,
     the unscreened kernel never), finite objectives, CD's penalized
     objective within rtol 1e-3 of FISTA's at every point (the points
     where FISTA hit max_iters named), the CD path's first 3 points bit
     for bit an unscreened run, and one warm sweep at full p (point 8's
     alpha at point 9's lam, where coordinates move) through the walker
     and the unscreened kernel, bit for bit;
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
   early) on both layouts, the lasso unfused and fused and the
   elastic-net unfused from warm starts with renorms forced, each lane's
   alpha and objective bits, iterations, n_dots and vertex sequence equal
   to a sequential solve replaying the rows it drew, the elastic-net's
   support bitmap covering beta after every batched step; the elastic-net's fused path against its
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
   lanes and at 1 on each path (the lane argmax on both routes; the
   shifted one with and without the support bitmap, and the bitmap's
   build); the elastic-net's instantiations and the
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

The distributed backend (``repro_torch.distributed``): phase 2 holds its
instantiations at each path's shapes (K2's and K5's owned scores on 4
feature tiles, their lane form, ``owned_column[_lanes]``, the tails with
the column given and the direction tail with its columns given) bit for
bit against the single-device kernels and within rounding of their plain
versions; "mesh, world 1" runs a (1, 1) NCCL mesh in this process on each
design already on the card (no copy): the grid's first 3 points bit for
bit the unfused path, on the sparse design an elastic-net and an away
point bit for bit their single-device points, the 3 points in lanes of 3
bit for bit the single-device batched path, the certified gap equal, a
mesh step against the single-device step and each collective timed;
"mesh, 4 ranks" spawns 4 processes sharing the card over gloo with CUDA
tensors (they load phase 1's kernels and print nothing) on a sparse proxy
(p = 262,144, m = 4,096): (1, 4) bit for bit the single-device run, on
(2, 2) the three oracles and the away rule within 1e-4 of their
single-device runs, the no-fault guarded solve bit for bit ``solve`` and
3 batched lanes bit for bit their sequential mesh solves. Runs on several
cards are not measured (one card in the box).

The rules under lanes: phase 2 holds the lane direction tails
(``dir_tail[_en]_lanes`` and their GIVEN forms) at 13 lanes at each path's
shapes and at 3 on a small design in f32 and bf16, away and pairwise: every
running lane bit for bit a one-lane launch, the GIVEN form (one launch and
two around an identity completion) bit for bit the matrix form, frozen
lanes untouched, within rounding of ``dir_tail_lanes_plain``; phase 3 runs
the grid's first 3 points in one chunk of 3 lanes under away, pairwise,
PARTAN and lazy and the elastic-net under away, each lane bit for bit a
sequential solve on the rows it drew, each point within the larger
certified gap of the sequential rule path's, the walls and the lazy hit
share printed, and the away chunks again on the (1, 1) NCCL mesh, bit for
bit; phase 5 times each lane form at 3 and 13 lanes beside its bound and a
batched rule step's wall and device time. The port's seven examples and
CI scripts run as child processes on the card (``[entry]`` lines), each
required to exit 0: the telemetry smoke's five gates first, right after
the build; last the quickstart, the 4,272,227-variable sparse path batched
and the dense one at p = 500,000, the solver family, the report with its
4-rank mesh, the chaos matrix and the profiler capture.

LM serving (``repro_torch.models``, ``configs``, ``training``,
``launch.serve``; no kernel of its own): every architecture at its
published widths (deepseek-7b, mamba2, hymba and seamless at their full
depth, the rest cut to 1-2 layers, ``SERVE_DEPTH``), each in bf16 and in
f32, prefilling 4 prompts of 128 tokens and decoding 3 more against
``forward`` over all 131 (f32 at rtol 2e-2, atol 2e-3; bf16 within
``SERVE_BF16_ATOL`` of the logits' scale, ``SERVE_DTYPES`` says why, and
past it with RoPE's table planted in bf16 in the decode steps,
``SERVE_FAULTS``; a decoded token that the forward routed past an
expert's capacity, and its row's later tokens, left out and counted),
then two greedy decodes of 16 tokens from one prefill bit for bit equal;
deepseek-7b's bf16 prefill, decode step, tok/s, the profiler's busy share
and launches a step beside their bounds, and the head's three f32-logit
routes (``[serve-time]`` lines); the ten reduced configs in f32 and bf16,
the card against the CPU (``[serve-cpu]``, bf16 within
``SERVE_CPU_BF16_ATOL`` and past it with the planted fault); the serve
launcher at deepseek-7b's full config and the serving example join the
last turn of entry points.

LM training (``repro_torch.training``, ``runtime``, ``data.lm_pipeline``;
no kernel of its own, the products are cuBLAS's): deepseek-7b at its
published widths in its recipe (bf16, AdamW with the f32 master, remat),
cut to ``TRAIN_DEPTH`` layers, and mamba2-130m whole, each at the
reference's train_4k shape (16 x 4,096 tokens in its microbatches): 3
steps on one batch, finite and falling losses, the step's seconds,
tokens/s, model FLOPs and their share of 989 TFLOP/s, the peak memory and,
under the profiler, launches and the busy share a step (``[train-time]``);
the ten reduced configs in f32 and bf16, a 2-microbatch step on the card
against the CPU within ``TRAIN_CPU_LIMITS`` (``[train-cpu]``); a child with
deterministic kernels that crashes mamba2-130m's training at step 4 and
resumes it, bit for bit the uninterrupted run (``[train-resume]``); the
train launcher, the training, feature-selection (its K1, K2, argmax and
tail launches) and compressed data-parallel examples join the last turn.

About 15 minutes on an H100, the builds included, and up to 19 on a
slow host (aim: 900 s, limit 1200 s); the training phases take about
150 s of it, the baselines' about 110 (the plain warm sweep 60 of them).
``--kernels-only`` stops each path after its phase 2 (and prints no JSON
lines).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
import statistics
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


PHASE_SECONDS = []  # (phase function, seconds) in the order they ran


def _time_phases():
    """Wrap each phase function of this module so that its seconds are kept
    in PHASE_SECONDS (printed at the end: the script's budget by phase)."""
    g = globals()
    for name, fn in list(g.items()):
        if name.startswith("phase") and inspect.isfunction(fn):
            def timed(*args, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    PHASE_SECONDS.append((_name, time.perf_counter() - t0))
            g[name] = timed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true", help="phases 1-2 only")
    ap.add_argument("--train-resume-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--train-child", nargs=2, metavar=("ARCH", "DIR"), help=argparse.SUPPRESS)
    ap.add_argument("--mesh-lm-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout that holds src/repro_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.train_resume_child:
        train_resume_child(args.train_resume_child)
        return 0
    if args.train_child:
        train_child(*args.train_child)
        return 0
    if args.mesh_lm_child:
        mesh_lm_child(args.mesh_lm_child)
        return 0
    if args.dryrun_child:
        dryrun_child(args.dryrun_child)
        return 0

    t_start = time.perf_counter()
    _time_phases()
    card = phase1_device_and_build(torch)
    if not args.kernels_only:
        phase_entry_points(torch, ENTRY_GATES)
    dev = torch.device("cuda")
    errs, launches, timing = {}, {}, {}
    for name, path in (("dense", dense_path), ("sparse", sparse_path)):
        t0 = time.perf_counter()
        path(torch, dev, args.kernels_only, errs, launches, timing)
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    if args.kernels_only:
        print(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s")
        return 0
    if _NCCL["up"]:
        import torch.distributed as tdist

        tdist.destroy_process_group()
    phase3_mesh_ranks(torch)
    serve_out = phase_serve(torch)
    phase_serve_card_vs_cpu(torch)
    train_out = phase_train(torch)
    phase_train_card_vs_cpu(torch)
    # the dry run's CPU work beside the mesh child and the entry points' last
    # turn, which time no gate
    dry = dryrun_start()
    try:
        phase_mesh_lm(torch)
        resume = train_resume_start()
        try:
            phase_entry_points(torch)
        finally:
            phase_train_resume(torch, resume)
        phase_dryrun(dry, train_out, serve_out)
    finally:
        _child_stop(dry)

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
            **{k: t[k] for k in ("timed_on", "bound_ms_all_beta") if k in t},
        })
    print(f"[entry] {', '.join(f'{k} {v:.1f} s' for k, v in ENTRY_SECONDS.items())}")
    print(f"[phases] {', '.join(f'{k} {v:.1f}' for k, v in PHASE_SECONDS)} (s)")
    mesh_total = sum(MESH_SECONDS.values())
    print(f"[mesh] the mesh phases: {', '.join(f'{k} {v:.1f} s' for k, v in MESH_SECONDS.items())}"
          f"; {mesh_total:.1f} s together")
    print(f"[serve] the serving runs: {', '.join(f'{k} {v:.1f} s' for k, v in SERVE_SECONDS.items())}")
    print(f"[train] the training phases: "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in TRAIN_SECONDS.items())}; "
          f"{sum(TRAIN_SECONDS.values()):.1f} s together")
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
    errs.update(phase2_rule_lane_kernels(torch, Xt, y, "dense"))
    errs.update(phase2_cd_sweep(torch, dev))
    errs.update(phase2_tel_kernels(torch, Xt, y, "dense"))
    errs.update(phase2_health(torch, [(P_PAPER, M_PAPER), HEALTH_RAGGED], "dense"))
    errs.update(phase2_mesh_kernels(torch, Xt, y, "dense"))
    golden_check(torch, dev)
    bf16_solves(torch, dev, "kernels")
    if not kernels_only:
        main_launches, main_run = phase3_main_path(torch, Xt, y, coef)
        phase3_fista_paper_width(torch, Xt, y, main_run)
        launches.update(phase3_cd_paper_width(torch, Xt, y))
        fused_launches, fused_run = phase3_fused_path(torch, Xt, y, main_run)
        phase3_full_point(torch, Xt, y, main_run)
        launches.update(main_launches)
        for name in ("dense_fused_chunk", "fused_replay"):
            launches[name] = fused_launches[name]
        batched_launches, batched_run = phase3_batched_path(torch, Xt, y, coef, "dense")
        for name in ("sampled_scores_lanes", "vertex_argmax_lanes", "step_tail_lanes"):
            launches[name] = batched_launches[name]
        mesh_launches, mesh_timing = phase3_mesh_world1(torch, Xt, y, main_run, "dense")
        launches.update(mesh_launches)
        timing.update(mesh_timing)
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
        rule_launches, rule_runs = phase3_rule_paths(torch, Xt, y, coef, "dense")
        for name in ("dir_tail", "dir_tail_en"):
            launches[name] = rule_launches[name]
        lane_launches, lane_runs = phase3_rule_lanes(torch, Xt, y, coef, "dense", rule_runs)
        launches.update(lane_launches)
        launches.update(phase3_mesh_rule_lanes(torch, Xt, y, lane_runs, "dense"))
        phase4_rule_routes(torch, Xt, y, coef, "dense")
        phase4_rule_acceptance(torch, dev)
        timing.update(phase5_rule_timing(torch, Xt, y, "dense"))
        timing.update(phase5_rule_lane_timing(torch, Xt, y, "dense"))
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
    errs.update(phase2_rule_lane_kernels(torch, mat, y, "sparse"))
    errs.update(phase2_tel_kernels(torch, mat, y, "sparse"))
    errs.update(phase2_health(torch, [(mat.p, mat.m)], "sparse"))
    errs.update(phase2_mesh_kernels(torch, mat, y, "sparse"))
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
    mesh_launches, mesh_timing = phase3_mesh_world1(
        torch, mat, y, dict(unfused_run, deltas=fused_run["deltas"]), "sparse")
    for name, n in mesh_launches.items():  # the column and the tails: both paths
        launches[name] = launches.get(name, 0) + n
    for name, row in mesh_timing.items():  # the dense path's rows stand for both layouts
        timing[name if name not in timing else f"{name}_sparse"] = row
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
    rule_launches, rule_runs = phase3_rule_paths(torch, mat, y, coef, "sparse")
    for name in ("dir_tail", "dir_tail_en"):
        launches[name] += rule_launches[name]
    lane_launches, lane_runs = phase3_rule_lanes(torch, mat, y, coef, "sparse", rule_runs)
    lane_launches.update(phase3_mesh_rule_lanes(torch, mat, y, lane_runs, "sparse"))
    for name, n in lane_launches.items():  # both paths
        launches[name] = launches.get(name, 0) + n
    phase4_rule_routes(torch, mat, y, coef, "sparse")
    timing.update(phase5_rule_timing(torch, mat, y, "sparse"))
    timing.update(phase5_rule_lane_timing(torch, mat, y, "sparse"))
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
    # a sweep of the baselines' coordinate descent: the port's own kernels
    # for the reference's XLA fori_loop of coord_update (no pallas_call): the
    # screened sweep's score pass and walker (the path's), and the unscreened
    # one-launch sweep (the card's yardstick, on no path)
    "cd_walk": dict(source="src/repro_torch/kernels/csrc/cd_sweep.cu",
                    replaces="src/repro/core/baselines.py:70"),
    "cd_score": dict(source="src/repro_torch/kernels/csrc/cd_sweep.cu",
                     replaces="src/repro/core/baselines.py:70"),
    "cd_sweep_unscreened": dict(source="src/repro_torch/kernels/csrc/cd_sweep.cu",
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
    # the distributed backend's instantiations: K2's and K5's scores on a
    # rank's tile with +0.0 where it owns no feature (the reference masks
    # its partial scores in XLA, src/repro/distributed/backend.py:78-130),
    # the winner's column on its owner (_owned_column, backend.py:177) and
    # the tails with that column given (dist_column_update, backend.py:197)
    "sampled_scores_owned": dict(source="src/repro_torch/kernels/csrc/fw_grad.cu",
                                 replaces="src/repro/kernels/fw_grad/fw_grad.py:79"),
    "sparse_sampled_scores_owned": dict(
        source="src/repro_torch/kernels/csrc/sparse_grad.cu",
        replaces="src/repro/kernels/sparse_grad/sparse_grad.py:87"),
    "sampled_scores_lanes_owned": dict(source="src/repro_torch/kernels/csrc/fw_grad.cu",
                                       replaces="src/repro/kernels/fw_grad/fw_grad.py:79"),
    "sparse_sampled_scores_lanes_owned": dict(
        source="src/repro_torch/kernels/csrc/sparse_grad.cu",
        replaces="src/repro/kernels/sparse_grad/sparse_grad.py:87"),
    "owned_column": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                         replaces="src/repro/distributed/backend.py:177"),
    "owned_column_lanes": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                               replaces="src/repro/distributed/backend.py:177"),
    "step_tail_given": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                            replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_en_given": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_lanes_given": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_en_lanes_given": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_given_tel": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_en_given_tel": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_lanes_given_tel": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "step_tail_en_lanes_given_tel": dict(
        source="src/repro_torch/kernels/csrc/step_tail.cu",
        replaces="src/repro/kernels/residual_update/residual_update.py:45"),
    "dir_tail_given": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                           replaces="src/repro/core/step_rule.py:117"),
    "dir_tail_en_given": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                              replaces="src/repro/core/step_rule.py:117"),
    # the rules under lanes: the direction tail with a lane axis, for the
    # reference's XLA ops of rule_step vmapped over its lanes
    # (src/repro/core/engine.py:736); the GIVEN forms on the mesh
    "dir_tail_lanes": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                           replaces="src/repro/core/step_rule.py:117"),
    "dir_tail_en_lanes": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                              replaces="src/repro/core/step_rule.py:117"),
    "dir_tail_lanes_given": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                                 replaces="src/repro/core/step_rule.py:117"),
    "dir_tail_en_lanes_given": dict(source="src/repro_torch/kernels/csrc/step_tail.cu",
                                    replaces="src/repro/core/step_rule.py:117"),
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


ARGMAX_ROUTES = ("cluster", "ticket")


def _lane_scores_check(torch, fw, label, lanes_fn, one_fn, plain_fn, blk, bs, p, L, scale):
    """A lane scores kernel (``lanes_fn(ids)``) and K2's lane argmax on its
    scores, for each set of running lanes: every running lane's scores and
    winner bitwise the one-lane launches' on its own inputs (``one_fn``), a
    frozen lane's winner (-1, 0), two argmax launches bitwise equal, each
    route (the cluster and the ticket route) bitwise the default route's,
    the winners bitwise the plain argmax's on the same scores, the scores
    within RTOL_SUM * scale of the plain version's. Returns max |kernel -
    plain| over the scores."""
    dev = blk.device
    err = 0.0
    for run in _lane_sets(L):
        ids = torch.tensor(run, dtype=torch.int32, device=dev)
        got = lanes_fn(ids)
        i1, g1 = fw.vertex_argmax_lanes(got, blk, bs, p, ids)
        i2, g2 = fw.vertex_argmax_lanes(got, blk, bs, p, ids)
        check(_same_bits(torch, i1, i2) and _same_bits(torch, g1, g2),
              f"{label} L={L} lanes {run}: two argmax launches differ")
        for route in ARGMAX_ROUTES:
            ir, gr = fw.vertex_argmax_lanes(got, blk, bs, p, ids, route=route)
            check(_same_bits(torch, i1, ir) and _same_bits(torch, g1, gr),
                  f"{label} L={L} lanes {run}: the {route} route differs")
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
          f"winner), frozen lanes (-1, 0), two argmax launches equal, the argmax's routes "
          f"(default {fw.lane_route(blk.shape[-1] * bs)}) equal; max |kernel - plain| {err:.3e}")
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
    from repro_torch.core import LASSO, delta_grid, fw_path_batched

    sparse = layout == "sparse"
    p = design.shape[0]
    cfg = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    delta_max = 0.5 * float(coef.abs().sum())
    deltas = delta_grid(delta_max, n_points=N_POINTS)
    tag = f"batched-{layout}"
    first = FirstChunk(0, LANE_WIDTH, design.device)
    steps = [0]

    print(f"[{tag}] fw_path_batched backend={cfg.backend} lane_width={LANE_WIDTH} p={p:,} "
          f"kappa={cfg.kappa:,} sampling=uniform max_iters={cfg.max_iters} tol={cfg.tol} "
          f"points={N_POINTS} delta_max={delta_max:.6g}")
    kernels.reset_launch_counts()
    res = fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=LANE_WIDTH,
                          device=design.device, solve_batched_fn=first.solve_fn)
    launches = kernels.launch_counts()
    steps[0] = first.steps
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
    first.replay(torch, tag, LASSO, design, y, cfg, deltas)
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


class FirstChunk:
    """A ``fw_path_batched`` run kept for checks made after it, so that its
    wall is the path's own: ``solve_fn`` wraps
    ``engine.solve_batched_prepared``, counts the batched steps of every
    chunk, keeps the first chunk's arguments and result and, with
    ``keep_states``, each solve's last state (``states``), and records
    nothing else. ``replay`` then solves the first chunk again with its
    draws recorded (the path's own sampler for chunk 0,
    ``LaneSampler(point_seed(seed, 0), ...)``) and holds each lane against
    a sequential solve."""

    def __init__(self, seed, lanes, dev, keep_states=False):
        self.seed, self.lanes, self.dev, self.keep_states = seed, lanes, dev, keep_states
        self.args, self.res, self.states, self.steps = None, None, [], 0

    def solve_fn(self, *args):
        from repro_torch.core import engine

        last = {}

        def on_step(state, active):
            self.steps += 1
            last["state"] = state

        res, saved = engine.solve_batched_prepared(*args, on_step=on_step)
        if self.args is None:
            self.args, self.res = args, res
        if self.keep_states:
            self.states.append(last.get("state"))
        return res, saved

    def replay(self, torch, tag, oracle, design, y, cfg, deltas):
        """The first chunk solved again with its rows and vertices recorded,
        bit for bit the path's chunk (iterations, n_dots, alpha, objective);
        then each lane against a sequential solve replaying its rows from
        its warm start: iterations, n_dots, the vertex sequence, alpha and
        the objective, bit for bit."""
        from repro_torch.core import LaneSampler, StreamSampler, engine
        from repro_torch.core.path import point_seed

        t0 = time.perf_counter()
        rec = LaneRecorder(LaneSampler(point_seed(self.seed, 0), self.lanes, self.dev),
                           self.lanes)
        trace = []
        args = list(self.args)
        args[4] = rec  # (oracle, Xt, y, cfg, sampler, alpha0s, deltas)
        res, _ = engine.solve_batched_prepared(
            *args, on_step=lambda st, act: trace.append((st.i_star.clone(), act)))
        check(res.iterations == self.res.iterations and res.n_dots == self.res.n_dots
              and _same_bits(torch, res.alpha, self.res.alpha)
              and _same_bits(torch, res.objective, self.res.objective),
              f"{tag}: the first chunk solved again differs from the path's")
        for lane in range(self.lanes):
            seq = []
            one = engine.solve(oracle, design, y, cfg, StreamSampler(torch.stack(rec.rows[lane])),
                               args[5][lane], float(deltas[lane]), device=design.device,
                               per_step=lambda st: seq.append(st.i_star))
            lane_seq = torch.stack([i[lane] for i, act in trace if act[lane]]).cpu()
            check(one.iterations == res.iterations[lane] and one.n_dots == res.n_dots[lane],
                  f"{tag} lane {lane}: iterations/n_dots differ from its sequential solve")
            check(torch.equal(torch.stack(seq).cpu(), lane_seq),
                  f"{tag} lane {lane}: the vertex sequence differs from its sequential solve")
            check(_same_bits(torch, one.alpha, res.alpha[lane])
                  and _same_bits(torch, one.objective, res.objective[lane]),
                  f"{tag} lane {lane}: alpha or objective bits differ from its sequential solve")
        print(f"[{tag}] the first chunk solved again bit for bit the path's; its "
              f"{self.lanes} lanes (iterations {list(res.iterations)}) each bit for bit its "
              f"sequential solve on the rows it drew: iterations, n_dots, vertices, alpha, "
              f"objective ({time.perf_counter() - t0:.1f} s, after the path)")


def support_report(torch, fw, tag, state):
    """After a batched elastic-net solve on the card: the lanes carry a
    support bitmap, and every nonzero of each lane's beta has its fine and
    summary bits; prints the set fine bits beside the nonzeros. Returns
    (set fine bits, nonzeros)."""
    sup, beta = state.support, state.beta
    check(sup is not None, f"{tag}: the elastic-net lanes carry no support bitmap")
    L, p = beta.shape
    fine_w = fw.support_fine_words(p)

    def bits(words, n):
        b = (words.contiguous().view(torch.uint8).view(L, -1, 1)
             >> torch.arange(8, dtype=torch.uint8, device=words.device)) & 1
        return b.reshape(L, -1)[:, :n].bool()

    fine = bits(sup[:, :fine_w], p)
    summary = bits(sup[:, fine_w:], -(-p // fw.SUMMARY_SPAN))
    nz = beta != 0
    covered = fine & summary.repeat_interleave(fw.SUMMARY_SPAN, dim=1)[:, :p]
    check(bool(torch.all(covered | ~nz)), f"{tag}: a nonzero of beta has no bit in the bitmap")
    n_bits, n_nz = int(fine.sum()), int(nz.sum())
    del fine, summary, covered, nz
    return n_bits, n_nz


def phase4_lanes_vs_sequential(torch, dev):
    """One chunk of 4 lanes at p = 200,000, m = 800, kappa = 1% of p and 400
    steps on both layouts, the lasso unfused and with fuse_steps = 8, the
    elastic-net unfused from warm starts (lane 0 from zero; a -0.0 among
    lane 2's) with renorms forced (renorm_threshold 0.5), the first lane's
    delta small enough that it freezes early: each lane's alpha bits,
    objective bits, iterations, n_dots and vertex sequence equal a
    sequential solve replaying the rows that lane drew (with fuse_steps =
    8, the sequential chunk of K unfused steps, run_loop's per_step route);
    the elastic-net lanes' support bitmap covers beta after every batched
    step."""
    from repro_torch.core import (LASSO, ENOracle, FWConfig, LaneSampler, StreamSampler,
                                  TorchSampler, engine)
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.data import make_sparse_wide_problem, make_wide_problem
    from repro_torch.kernels import fw_grad as fw

    kappa = kappa_fraction(P_LANES, 0.01)
    en = ENOracle(l2=EN_L2)
    for layout in ("dense", "sparse"):
        if layout == "dense":
            X, y, coef = make_wide_problem(P_LANES, M_PAPER, N_REL, seed=1, device=dev)
        else:
            X, y, coef = make_sparse_wide_problem(M_PAPER, P_LANES, 0.02, N_REL, seed=1,
                                                  device=dev, block_size=SPARSE_BLOCK)
        delta_max = 0.5 * float(coef.abs().sum())
        deltas = [delta_max / 1000, delta_max / 30, delta_max / 3, delta_max]
        backend = "sparse" if layout == "sparse" else "kernels"
        # the elastic-net's warm starts: 100 steps at the third delta, rescaled
        warm_cfg = FWConfig(delta=1.0, kappa=kappa, max_iters=100, tol=0.0, backend=backend)
        warm = engine.solve(en, X, y, warm_cfg, TorchSampler(9, dev), None, deltas[2],
                            device=dev).alpha
        for oracle, fuse in ((LASSO, 1), (LASSO, FUSE), (en, 1)):
            name = "lasso" if oracle is LASSO else "elastic-net"
            cfg = FWConfig(delta=1.0, kappa=kappa, max_iters=400, tol=1e-3, fuse_steps=fuse,
                           backend=backend, renorm_threshold=0.5 if oracle is en else 1e-6)
            alpha0s = None
            if oracle is en:
                scale = torch.tensor(deltas, device=dev) / warm.abs().sum()
                alpha0s = warm[None, :] * scale[:, None]
                alpha0s[0] = 0.0
                alpha0s[2, torch.nonzero(warm)[:3, 0]] = -0.0
            rec = LaneRecorder(LaneSampler(4, len(deltas), dev), len(deltas))
            trace, covered = [], []

            def on_step(state, active):
                trace.append((state.i_star.clone(), active))
                if state.support is not None:
                    covered.append(support_report(torch, fw, "lanes", state))

            res, saved = engine.solve_batched(oracle, X, y, cfg, rec, alpha0s, deltas,
                                              device=dev, on_step=on_step)
            iters = res.iterations
            tag = f"lanes {layout} {name} fuse={fuse}"
            check(min(iters) < max(iters) and saved > 0, f"{tag}: no lane froze early ({iters})")
            check(bool(covered) == (oracle is en), f"{tag}: the support bitmap is "
                                                   f"{'missing' if covered else 'not expected'}")
            for lane, d in enumerate(deltas):
                seq = []
                one = engine.solve(oracle, X, y, cfg, StreamSampler(torch.stack(rec.rows[lane])),
                                   None if alpha0s is None else alpha0s[lane], d, device=dev,
                                   per_step=lambda s: seq.append(s.i_star))
                lane_seq = torch.stack([i[lane] for i, act in trace if act[lane]]).cpu()
                check(one.iterations == iters[lane] and one.n_dots == res.n_dots[lane],
                      f"{tag} lane {lane}: iterations/n_dots")
                check(torch.equal(torch.stack(seq).cpu(), lane_seq),
                      f"{tag} lane {lane}: vertex sequences differ")
                check(_same_bits(torch, one.alpha, res.alpha[lane])
                      and _same_bits(torch, one.objective, res.objective[lane]),
                      f"{tag} lane {lane}: alpha or objective bits differ")
            bits = f"; the bitmap covered beta after all {len(covered)} batched steps, " \
                   f"{covered[-1][0]} fine bits set for {covered[-1][1]} nonzeros at the " \
                   f"end" if covered else ""
            print(f"[{tag}] 4 lanes, iterations {iters}, saved {saved}: each lane's alpha and "
                  f"objective bits, iterations, n_dots and vertex sequence equal its sequential "
                  f"replay{bits}")
        del X, y, coef
        torch.cuda.empty_cache()


def _batched_run(torch, design, y, stats, cfg, L, n_steps, seed, oracle=None):
    from repro_torch.core import LASSO, LaneSampler, engine

    oracle = LASSO if oracle is None else oracle
    bcfg = dataclasses.replace(cfg, max_iters=n_steps, tol=0.0, patience=10**9)
    states0 = engine.stack_states([engine.init_state(oracle, design, y, None, bcfg)
                                   for _ in range(L)])
    deltas = torch.full((L,), 50.0, device=design.device)
    return lambda: engine.batched_loop(oracle, design, y, stats, states0, bcfg, deltas, 10**9,
                                       LaneSampler(seed, L, design.device))


def batched_step_ms(torch, design, y, stats, cfg, L, n_steps=200, oracle=None):
    """The batched step's host-clock ms (a fixed run of ``n_steps`` batched
    steps of L lanes after a warm-up, each run ending in a device sync) and
    its device busy ms per step (``torch.profiler`` over 50 more), under
    ``cfg.step_rule`` and ``oracle`` (the lasso by default)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for seed in (3, 5):
        run = _batched_run(torch, design, y, stats, cfg, L, n_steps, seed, oracle)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_steps
    run = _batched_run(torch, design, y, stats, cfg, L, 50, 9, oracle)
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
    ticket_ms = _time_queued(torch, lambda i: fw.vertex_argmax_lanes(
        scores, draws[0], 1, p, ids, route="ticket"), 400)
    row("vertex_argmax_lanes" if not sparse else "vertex_argmax_lanes_sparse",
        _time_queued(torch, lambda i: fw.vertex_argmax_lanes(scores, draws[0], 1, p, ids), 400),
        _time_queued(torch, lambda i: fw.argmax_lanes_plain(scores, draws[0], 1, p, ids), 5),
        None, L * (kappa * 4 + kappa * 8 + 12), 3 * L * kappa,
        note=f" [n = kappa = {kappa} a lane, route {fw.lane_route(kappa)} (clusters of "
             f"{fw.LANE_CLUSTER}); the ticket route {ticket_ms:.6f} ms in the same run; "
             "library: none]")
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
# with max_iters 2000 and tol 1e-4 (LOG_POINTS_SPARSE, LOG_LANES below)
EN_L2 = 1.0
EN_UNFUSED = 3  # the EN path's first points, also one step per dispatch
# the EN paths run the lasso grid's first EN_POINTS points, cut from all
# N_POINTS for the script's time: the grid's last 50 points took 85% of the
# fused paths' seconds on an H100 (24.3 of 28.8 s dense, 15.7 of 16.5
# sparse)
EN_POINTS = 50
LEDGER_K = 72  # phase 2's long EN chunk, a ledger of 72 slots
LOG_MAX_ITERS, LOG_TOL = 2000, 1e-4
# the logistic grid has 10 points; the sparse path runs its first
# LOG_POINTS_SPARSE (one chunk of LOG_LANES lanes), the dense its first
# LOG_POINTS_DENSE: cut from all 10 sparse (to 2: a third point's 2,000
# steps take ~10 s on an H100, and ~13 s more in lanes) to keep the script
# in its time
LOG_POINTS, LOG_LANES, LOG_POINTS_DENSE, LOG_POINTS_SPARSE = 10, 2, 3, 2
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


def _bitmap_cases(torch, fw, beta, g):
    """(label, support) pairs for a lane-stacked beta: none, the exact
    bitmap, a strict superset (a fifth of the bits set besides)."""
    exact = fw.pack_support(beta)
    noise = torch.rand(beta.shape, generator=g, device=beta.device) < 0.2
    return [("no bitmap", None), ("exact bitmap", exact),
            ("superset bitmap", exact | fw.pack_support(noise))]


def _check_shifted_lanes(torch, fw, label, scores, blk, bs, p, ids, shift, want, g):
    """The shifted lane argmax on the cluster route with no bitmap, an
    exact one and a strict superset, and on the ticket route with none:
    bitwise ``want`` (the plain version's), two launches equal, and each
    bitmap afterwards its input with the winners' bits set; the ticket
    route refuses a bitmap."""
    for blabel, support in _bitmap_cases(torch, fw, shift.beta, g):
        for route in ARGMAX_ROUTES:
            sup = None if support is None else support.clone()
            sh = fw.ScoreShift(shift.beta, shift.scale, shift.l2, sup)
            if route == "ticket" and sup is not None:
                try:
                    fw.vertex_argmax_shifted_lanes(scores, blk, bs, p, ids, sh, route=route)
                except ValueError:
                    continue
                check(False, f"{label} {blabel}: the ticket route took a bitmap")
            got = fw.vertex_argmax_shifted_lanes(scores, blk, bs, p, ids, sh, route=route)
            again = fw.vertex_argmax_shifted_lanes(scores, blk, bs, p, ids, sh, route=route)
            for other, what in ((want, "its plain version"), (again, "a second launch")):
                check(all(_same_bits(torch, a, b) for a, b in zip(got, other)),
                      f"{label} {blabel} {route}: differs from {what}")
            if sup is not None:
                expect = support.clone()
                fw.mark_support(expect, got[0], p)
                check(torch.equal(sup, expect), f"{label} {blabel} {route}: the bitmap after "
                                                "the launch is not its input with the winners")
    return got


def shifted_lanes_check(torch, fw, label, scores_fn, blk, p, g, L):
    """K2's lane argmax with the shift, for each set of running lanes: on
    both routes, the cluster route with and without the support bitmap
    (``_check_shifted_lanes``),
    bitwise its plain version; each running lane bitwise its one-lane
    shifted launch, a frozen lane (-1, 0, 0)."""
    dev = blk.device
    beta = torch.zeros((L, p), device=dev)
    beta.scatter_(1, torch.randint(0, p, (L, 2000), generator=g, device=dev),
                  torch.randn((L, 2000), generator=g, device=dev))
    beta[:, blk[0, :40]] = 3.0  # shifts at sampled coordinates, some turning winners
    shift = fw.ScoreShift(beta, torch.rand(L, generator=g, device=dev) + 0.5, EN_L2)
    for run in _lane_sets(L):
        ids = torch.tensor(run, dtype=torch.int32, device=dev)
        scores = scores_fn(ids)
        want = fw.argmax_shifted_lanes_plain(scores, blk, 1, p, ids, shift)
        got = _check_shifted_lanes(torch, fw, f"{label} L={L} lanes {run}", scores, blk, 1, p,
                                   ids, shift, want, g)
        for lane in range(L):
            if lane not in run:
                check(int(got[0][lane]) == -1 and float(got[2][lane]) == 0.0,
                      f"{label}: frozen lane {lane}")
                continue
            one = fw.vertex_argmax_shifted(scores[lane].contiguous(), fw.lane_blk(blk, lane), 1,
                                           p, shift.lane(lane))
            check(all(_same_bits(torch, a[lane], b) for a, b in zip(got, one)),
                  f"{label} L={L}: lane {lane} differs from a one-lane launch")
    print(f"[en] {label} L={L}: bit for bit its plain version and each lane's one-lane launch on "
          "both routes, the cluster route with no bitmap, an exact one and a strict superset "
          "(each updated with its winners), frozen lanes (-1, 0, 0)")


def shifted_lanes_edge_cases(torch, fw, p, g, L=LANE_WIDTH):
    """The shifted lane argmax's edge cases at 13 lanes, p the path's: raw
    scores -0.0 beside beta's -0.0; a lane of infinite scale and one of NaN
    scale (their zero shifts NaN, which must win, the bitmap not read);
    every index masked (blocks past p); 'full' sampling's shared ids (n =
    p, blocks of 128, the ticket route by default); bf16 beta; each on the
    cluster route with and without bitmaps and on the ticket route without
    (``_check_shifted_lanes``) against the plain version and each lane's
    one-lane launch, all lanes listed."""
    dev = g.device
    ids = torch.arange(L, dtype=torch.int32, device=dev)
    n = 4001
    for case in ("minus zero", "scale inf nan", "all masked", "full", "bf16 beta"):
        bs, pv = 1, p
        if case == "full":
            bs = 128
            blk = torch.arange(-(-p // bs), device=dev)
            n = blk.numel() * bs
        elif case == "all masked":
            bs, pv = 64, p - p % 64  # the last whole block's indices all lie past pv
            blk = torch.full((3,), pv // 64, dtype=torch.int64, device=dev)
            n = 3 * 64
        else:
            n = 4001
            blk = torch.randint(0, p, (L, n), generator=g, device=dev)
        scores = torch.empty((L, -(-n // 4) * 4), device=dev)[:, :n]
        scores.copy_(torch.randn((L, n), generator=g, device=dev))
        beta = torch.zeros((L, pv), device=dev)
        beta.scatter_(1, torch.randint(0, pv, (L, 300), generator=g, device=dev),
                      torch.randn((L, 300), generator=g, device=dev) * 4)
        scale = torch.rand(L, generator=g, device=dev) + 0.5
        if case == "minus zero":
            beta[beta == 0] = -0.0
            scores[:, ::3] = -0.0
        if case == "scale inf nan":
            scale[1], scale[2] = float("inf"), float("nan")
        if case == "bf16 beta":
            beta, scale = beta.bfloat16(), scale.bfloat16()
        shift = fw.ScoreShift(beta, scale, EN_L2)
        want = fw.argmax_shifted_lanes_plain(scores, blk, bs, pv, ids, shift)
        got = _check_shifted_lanes(torch, fw, f"shifted lanes {case}", scores, blk, bs, pv, ids,
                                   shift, want, g)
        for lane in range(L):
            one = fw.vertex_argmax_shifted(scores[lane].contiguous(), fw.lane_blk(blk, lane), bs,
                                           pv, shift.lane(lane))
            check(all(_same_bits(torch, a[lane], b) for a, b in zip(got, one)),
                  f"shifted lanes {case}: lane {lane} differs from a one-lane launch")
        if case == "scale inf nan":
            check(bool(torch.isnan(got[2][1])) and bool(torch.isnan(got[2][2])),
                  "shifted lanes: a non-finite scale's NaN did not win")
        print(f"[en] vertex_argmax_shifted_lanes {case} (n={n:,} a lane, p={pv:,}): bit for bit "
              f"its plain version and the one-lane launches on both routes, the cluster route "
              f"with and without bitmaps (default route {fw.lane_route(n)})")
    del scores, beta


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
    if not sparse:  # the argmax reads only scores and ids: one layout's scores do
        shifted_lanes_edge_cases(torch, fw, p, g)

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


def _point_objective(torch, oracle, design, y, pt):
    """A path point's objective from its alpha (the co-state rebuilt from
    one matvec), not from the recursions the solve carried."""
    from repro_torch.core.engine import ColStats
    from repro_torch.core.vertex import matvec

    alpha = _alpha_from_point(torch, pt, design.shape[0], design.device)
    co = oracle.init_co(y, matvec(design, alpha), alpha, alpha.dtype)
    return float(oracle.objective(y, ColStats(zty=None, znorm2=None, yty=torch.dot(y, y)), co))


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


def _ext_path(torch, tag, design, y, deltas, cfg, oracle, n_rec, batched=0, keep_states=False):
    """One path through ``fw_path`` (or, with ``batched`` lanes,
    ``fw_path_batched``, its chunks kept by ``FirstChunk``, with
    ``keep_states`` each solve's last state), its points
    printed and checked, the launches counted; returns (launches, run).
    The densest point's certified gap, with the oracle's own gradient, must
    be finite."""
    from repro_torch import kernels
    from repro_torch.core import fw_path, fw_path_batched

    rec = StarRecorder(n_rec)
    steps = [0]
    first = FirstChunk(0, batched, design.device, keep_states) if batched else None

    kernels.reset_launch_counts()
    if batched:
        res = fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=batched, oracle=oracle,
                              device=design.device, solve_batched_fn=first.solve_fn)
        steps[0] = first.steps
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
                          label=tag, first=first)


def phase3_en_paths(torch, design, y, coef, layout):
    """The elastic-net path (ENOracle(l2=1.0)) at full width over the first
    EN_POINTS points of the lasso path's 100-point grid: fused at K = 8 (K4
    or K7 with the ledger and the replay once a chunk; K1 or K6 once a
    point), its first 3 points one step per dispatch (the scores, the
    shifted argmax and the EN tail once a step), and through ``fw_path_batched`` in lanes of 13 (the lane scores,
    the shifted lane argmax and the EN lane tail once a batched step)."""
    from repro_torch.core import ENOracle, delta_grid

    sparse = layout == "sparse"
    p = design.shape[0]
    oracle = ENOracle(l2=EN_L2)
    fused_cfg = sparse_config(p) if sparse else main_config(p, "kernels", FUSE)
    cfg1 = dataclasses.replace(fused_cfg, fuse_steps=1)
    deltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=N_POINTS)[:EN_POINTS]
    print(f"[en-{layout}] ENOracle(l2={EN_L2}) p={p:,} kappa={fused_cfg.kappa:,} "
          f"max_iters={fused_cfg.max_iters} tol={fused_cfg.tol} points={len(deltas)} of a "
          f"{N_POINTS}-point grid to {float(deltas[-1]):.6g}")
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
                                               ((colstats,), len(deltas))],
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

    from repro_torch.kernels import fw_grad as fw

    tag_b = f"en-{layout}-batched"
    l_b, batched = _ext_path(torch, tag_b, design, y, deltas, cfg1, oracle, 0,
                             batched=LANE_WIDTH, keep_states=True)
    first = batched["first"]
    n_bits = n_nz = 0
    for c, state in enumerate(first.states):  # each batched solve's last state: the invariant
        bits, nz = support_report(torch, fw, f"{tag_b} chunk {c}", state)
        print(f"[{tag_b}] chunk {c}: the support bitmap covers beta, {bits} fine bits set for "
              f"{nz} nonzeros")
        n_bits, n_nz = n_bits + bits, n_nz + nz
    print(f"[{tag_b}] after each of its {len(first.states)} batched solves the bitmap covered "
          f"beta: {n_bits} fine bits set for {n_nz} nonzeros in all (checked after the path)")
    first.states.clear()
    first.replay(torch, tag_b, oracle, design, y, cfg1, deltas)
    lane_scores = "sparse_sampled_scores_lanes" if sparse else "sampled_scores_lanes"
    _check_launches(f"en-{layout}-batched", l_b,
                    [((lane_scores, "vertex_argmax_shifted_lanes", "step_tail_en_lanes"),
                      batched["steps"]), ((colstats,), -(-len(deltas) // LANE_WIDTH))],
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
    the sparse layout its first LOG_POINTS_SPARSE, sequential and in one
    chunk of LOG_LANES lanes (the reference family's batched logistic path);
    on the dense one its first LOG_POINTS_DENSE. Per step the scores (K2 or K5) and the lasso's argmax on the card,
    the bisection tail in plain PyTorch (no tail kernel, no column
    statistics)."""
    from repro_torch.core import LOGISTIC, delta_grid

    sparse = layout == "sparse"
    p = design.shape[0]
    yl = logistic_labels(torch, y)
    base = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    cfg = dataclasses.replace(base, max_iters=LOG_MAX_ITERS, tol=LOG_TOL)
    deltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=LOG_POINTS)
    deltas = deltas[:LOG_POINTS_SPARSE if sparse else LOG_POINTS_DENSE]
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


def _bitmap_lane_bytes(torch, fw, blk, support, p, itemsize):
    """Bytes the shifted lane argmax with the support bitmap moves besides
    the scores, ids, scale and outputs, at width 1 on ``blk (L, n)``: each
    lane's summary words (read whole), the distinct fine words under a set
    summary bit at its sampled indices, beta (``itemsize`` bytes) at the
    distinct sampled indices whose two bits are set, and the two words it
    writes."""
    L, fine_w = blk.shape[0], fw.support_fine_words(p)
    idx = blk.long()
    grp = idx >> 6
    s_set = ((torch.gather(support, 1, fine_w + (grp >> 5)) >> (grp & 31)) & 1).bool()
    f_set = ((torch.gather(support, 1, idx >> 5) >> (idx & 31)) & 1).bool() & s_set
    total = L * ((support.shape[1] - fine_w) * 4 + 8)
    for lane in range(L):
        total += 4 * torch.unique((idx[lane] >> 5)[s_set[lane]]).numel()
        total += itemsize * torch.unique(idx[lane][f_set[lane]]).numel()
    return total


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
    lmap = fw.ScoreShift(lshift.beta, lshift.scale, lshift.l2, fw.pack_support(lshift.beta))
    others = {}
    for label, sh, route in (("cluster route, no bitmap", lshift, None),
                             ("ticket route, no bitmap", lshift, "ticket")):
        others[label] = _time_queued(torch, lambda i, sh=sh, route=route: (
            fw.vertex_argmax_shifted_lanes(lscores, blk, 1, p, ids, sh, route=route)), 400)
    name = "vertex_argmax_shifted_lanes" + suffix
    t_map = _time_queued(torch, lambda i: fw.vertex_argmax_shifted_lanes(lscores, blk, 1, p, ids,
                                                                         lmap), 400)
    # the bound of what the bitmap launch must move, counted on the bitmap as
    # the timed launches saw it (the winners' bits set by the first one)
    map_bytes = _bitmap_lane_bytes(torch, fw, blk, lmap.support, p, 4)
    old_ms, _ = _bound(L * (kappa * 16 + 4 + 16), 5 * L * kappa)
    row(name, t_map,
        _time_queued(torch, lambda i: fw.argmax_shifted_lanes_plain(lscores, blk, 1, p, ids,
                                                                    lshift), 2),
        L * (kappa * 12 + 4 + 16) + map_bytes, 5 * L * kappa,
        note=f" [{L} lanes, n = kappa a lane, the cluster route with the support bitmap ("
             f"{nzi.numel()} nonzeros a lane); bytes: the scores, ids, scale and outputs, and "
             f"{map_bytes:,} of bitmap words and beta under set bits; the bound reading beta at "
             f"every score {old_ms:.6f} ms ({100 * old_ms / t_map:.1f}%); in the same run: "
             + ", ".join(f"{k} {v:.6f} ms" for k, v in others.items()) + "]")
    out[name]["bound_ms_all_beta"] = old_ms
    build_ms = _time_queued(torch, lambda i: fw.pack_support(lshift.beta), 20)
    print(f"[timing] the lanes' support bitmap ({layout}): built in {build_ms:.6f} ms from beta "
          f"({L}, {p:,}) once a batched solve ({fw.support_words(p) * 4 * L:,} bytes)")
    del lshift, lmap

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
    err, rd = _dir_close(torch, name, label, mat, kw, out_k, out_p)
    moved = "kept" if torch.equal(out_k.buf, kw["buf"]) else "moved"
    print(f"[kernels] {name} {label}: i* {int(out_k.i_star)} (i_a {int(out_k.i_a)}), g "
          f"{float(out_k.g)!r}, stall {int(out_k.stall)}, buffer {moved}: as the plain version "
          f"(scalars within {err:.2e}, residual {rd:.2e}), two launches equal")
    return max(err, rd)


def _dir_close(torch, name, label, mat, kw, out_k, out_p):
    """One lane's direction tail ``out_k`` against the plain version's
    ``out_p`` from the state ``kw``: the vertices, stall, the buffer and a
    drop's zero exact; beta, the residual and the scalars within RTOL_SUM
    of their scale (the three dots sum in another order). Returns ``(max
    |diff| over the scalars, over the residual)``."""
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
    return err, rd


# DIR_CASES in the lanes' order: at 3 lanes a refresh, an away step and a renorm
DIR_LANE_CASES = ("refresh", "away", "renorm", "pairwise", "drop", "same", "empty",
                  "zero weights", "full")
DIR_LANE_COUNTS = (3, 13)  # the lane direction tails' lane counts in phases 2 and 5
DIR_TIMING_CASES = ("away", "refresh", "drop")  # phase 5's lanes: away directions, no renorm
DIR_LANE_FORMS = ("dir_tail_lanes", "dir_tail_en_lanes", "dir_tail_lanes_given",
                  "dir_tail_en_lanes_given")


def dir_lane_state(torch, mat, y_noise, g, L, en_l2=None, dtype=None, cases=DIR_LANE_CASES):
    """A lane-stacked state of the direction tail: lane l from the case
    ``cases[l % len(cases)]`` (``dir_tail_case``), every lane on lane 0's y, its
    residual, S, F (and Q), its buffer's and its FW vertex's scores
    recomputed against it, and a step_inf of its own. Returns ``(beta (L,
    p), the lane-stacked kwargs of dir_tail_lanes, en or None)``, the
    kwargs' ``refresh`` one bool a lane (the refresh cases')."""
    from repro_torch.core.vertex import matvec
    from repro_torch.kernels import step_tail as st

    p = mat.shape[0]
    states = [dir_tail_case(torch, mat, y_noise, cases[lane % len(cases)], g, en_l2, dtype)
              for lane in range(L)]
    y = states[0][1]["y"]
    dtype = y.dtype
    yf = y.float()
    lanes = []
    for beta, kw, en, _ in states:
        a = kw["scale"].float() * beta.float()
        v = matvec(mat, a.to(dtype)).float()
        resid = (yf - v).to(dtype)
        sel_f = _plain_scores(torch, mat, kw["i_f"].view(1), resid).view(())
        if en_l2 is not None:
            sel_f = sel_f + en_l2 * a[kw["i_f"]]
        lanes.append(dict(kw, resid=resid, raw_b=_plain_scores(torch, mat, kw["buf"].clamp(
            0, p - 1), resid), sel_f=sel_f.float(), s_quad=(v @ v).to(dtype),
            f_lin=(v @ yf).to(dtype), q=(a @ a).to(dtype),
            step_inf=torch.rand((), generator=g, device=y.device).to(dtype)))
    kw = {k: torch.stack([lane[k] for lane in lanes]) for k in (
        "scale", "maxabs", "step_inf", "stall", "resid", "s_quad", "f_lin", "buf", "raw_b", "i_f",
        "sel_f", "delta")}
    kw["y"], kw["refresh"] = y, [lane["refresh"] for lane in lanes]
    en = None if en_l2 is None else st.DirEN(en_l2, torch.stack([lane["q"] for lane in lanes]))
    return torch.stack([b for b, *_ in states]), kw, en


def _dir_lane_args(kw, refresh):
    return (kw["scale"], kw["maxabs"], kw["step_inf"], kw["stall"], kw["resid"], kw["s_quad"],
            kw["f_lin"], kw["y"], kw["buf"], kw["raw_b"], kw["i_f"], kw["sel_f"], kw["delta"],
            refresh)


def _dir_lane(out, lane):
    """Lane ``lane``'s one-lane ``DirTailOut`` of a lane-stacked one."""
    return type(out)(*(None if t is None else t[lane] for t in out))


def _dir_zcols(torch, mat, kw, m):
    """Each lane's ``dir_column_ids`` columns, ``(L, n_buf + 2, m)``."""
    from repro_torch.kernels import step_tail as st

    p = mat.shape[0]
    return torch.stack([st.dense_columns(_ell_of(mat), st.dir_column_ids(i, b, p), m)
                        for i, b in zip(kw["i_f"], kw["buf"])])


def check_dir_tail_lanes(torch, label, mat, beta, kw, en, pairwise):
    """The lane direction tail (``dir_tail_lanes`` or, with ``en``,
    ``dir_tail_en_lanes``) and its GIVEN form for each set of running
    lanes: every running lane bitwise a one-lane launch on its operands
    (beta's row and every output) and within ``_dir_close``'s tolerance of
    ``dir_tail_lanes_plain``; the GIVEN form, in one launch and in two
    around an identity completion (no refresh), bitwise the matrix form;
    a frozen lane's outputs its inputs, its vertices -1, its beta row
    untouched; two launches bitwise equal. Returns ``{form: max |kernel -
    plain|}``."""
    from repro_torch.kernels import step_tail as st

    cfg = _dir_cfg()
    L, m = beta.shape[0], kw["y"].shape[0]
    ell = _ell_of(mat)
    extra = () if en is None else (en,)
    fn, one_fn = ((st.dir_tail_lanes, st.dir_tail) if en is None
                  else (st.dir_tail_en_lanes, st.dir_tail_en))
    given_fn = st.dir_tail_lanes_given if en is None else st.dir_tail_en_lanes_given
    zcols = _dir_zcols(torch, mat, kw, m)
    err = 0.0
    for run in _lane_sets(L):
        ids = torch.tensor(run, dtype=torch.int32, device=beta.device)
        refresh = [r and lane in run for lane, r in enumerate(kw["refresh"])]
        args = _dir_lane_args(kw, refresh)
        b_k, b_2, b_p, b_g = beta.clone(), beta.clone(), beta.clone(), beta.clone()
        got = fn(ell, b_k, *args, ids, pairwise, cfg, *extra)
        again = fn(ell, b_2, *args, ids, pairwise, cfg, *extra)
        want = st.dir_tail_lanes_plain(ell, b_p, *args, ids, pairwise, cfg, en)
        given = given_fn(zcols, b_g, *args, ids, pairwise, cfg, *extra)
        for name, out in (("two launches", again), ("the GIVEN form", given)):
            check(all(a is None or _same_bits(torch, a, b) for a, b in zip(got, out)),
                  f"{fn.__name__} {label} lanes {run}: {name} differ")
        no_ref = [False] * L
        b_1, b_s = beta.clone(), beta.clone()
        one_launch = given_fn(zcols, b_1, *_dir_lane_args(kw, no_ref), ids, pairwise, cfg, *extra)
        split = given_fn(zcols, b_s, *_dir_lane_args(kw, no_ref), ids, pairwise, cfg, *extra,
                         complete=lambda t: t)
        check(all(a is None or _same_bits(torch, a, b) for a, b in zip(one_launch, split)),
              f"{given_fn.__name__} {label} lanes {run}: the two-launch form differs")
        for lane in range(L):
            if lane not in run:
                check(_same_bits(torch, b_k[lane], beta[lane]), f"{label}: frozen beta moved")
                for f, inp in (("scale", kw["scale"]), ("maxabs", kw["maxabs"]),
                               ("step_inf", kw["step_inf"]), ("stall", kw["stall"]),
                               ("resid", kw["resid"]), ("s_quad", kw["s_quad"]),
                               ("f_lin", kw["f_lin"]), ("buf", kw["buf"])):
                    check(_same_bits(torch, getattr(got, f)[lane], inp[lane]),
                          f"{fn.__name__} {label}: frozen lane {lane}'s {f} changed")
                check(int(got.i_star[lane]) == int(got.i_a[lane]) == -1,
                      f"{fn.__name__} {label}: frozen lane {lane}'s vertices")
                continue
            b1 = beta[lane].clone()
            one = one_fn(ell, b1, kw["scale"][lane].clone(), kw["maxabs"][lane].clone(),
                         kw["stall"][lane].clone(), kw["resid"][lane].clone(),
                         kw["s_quad"][lane].clone(), kw["f_lin"][lane].clone(), kw["y"],
                         kw["buf"][lane].clone(), kw["raw_b"][lane].clone(),
                         kw["i_f"][lane].clone(), kw["sel_f"][lane].clone(),
                         kw["delta"][lane].clone(), refresh[lane], pairwise, cfg,
                         *(() if en is None else (type(en)(en.l2, en.q_norm[lane].clone()),)))
            mine = _dir_lane(got, lane)
            differ = [f for f in one._fields if getattr(one, f) is not None
                      and not _same_bits(torch, getattr(mine, f), getattr(one, f))]
            check(not differ and _same_bits(torch, b_k[lane], b1),
                  f"{fn.__name__} {label}: lane {lane} differs from a one-lane launch in {differ}")
            kw_l = {k: (v[lane] if isinstance(v, torch.Tensor) and k != "y" else v)
                    for k, v in kw.items()}
            e, rd = _dir_close(torch, fn.__name__, f"{label} lane {lane}", mat, kw_l, mine,
                               _dir_lane(want, lane))
            err = max(err, e, rd)
    print(f"[kernels] {fn.__name__} {label} L={L} {'pairwise' if pairwise else 'away'}: every "
          f"running lane bitwise its one-lane launch and within {err:.2e} of the plain version, "
          "the GIVEN form (one launch and two) bitwise the same, frozen lanes untouched, two "
          "launches equal")
    return {fn.__name__: err, given_fn.__name__: err}


def phase2_rule_lane_kernels(torch, design, y, layout):
    """The lane direction tails at 13 lanes at the path's shapes in f32, and
    at 3 lanes on a small design (m = 9,000, three blocks of the grid a
    lane) in f32 and bf16, away and pairwise, the lasso's and the
    elastic-net's (``check_dir_tail_lanes``)."""
    dev = y.device
    g = torch.Generator(device=dev)
    g.manual_seed(27)
    errs = dict.fromkeys(DIR_LANE_FORMS, 0.0)
    small_m = 9_000
    if layout == "sparse":
        from repro_torch.data import make_sparse_wide_problem

        small, _, _ = make_sparse_wide_problem(small_m, 20_000, 0.01, 50, seed=1, device=dev,
                                               block_size=SPARSE_BLOCK)
        small_b = small.astype(torch.bfloat16)
    else:
        small = torch.randn((20_000, small_m), generator=g, device=dev)
        small /= torch.linalg.vector_norm(small, dim=1, keepdim=True)
        small_b = small.to(torch.bfloat16)
    ys = torch.randn(small_m, generator=g, device=dev)
    cases = [(f"{layout} f32 at the path's shapes", design, y, DIR_LANE_COUNTS[-1]),
             (f"{layout} f32 m={small_m}", small, ys, 3),
              (f"{layout} bf16 m={small_m}", small_b, ys.to(torch.bfloat16), 3)]
    for label, mat, yy, L in cases:
        for en_l2 in (None, EN_L2):
            beta, kw, en = dir_lane_state(torch, mat, yy, g, L, en_l2, yy.dtype)
            for pairwise in (False, True):
                for k, v in check_dir_tail_lanes(torch, label, mat, beta, kw, en,
                                                 pairwise).items():
                    errs[k] = max(errs[k], v)
            del beta, kw
    torch.cuda.synchronize()
    return errs if layout == "dense" else {f"{k}_sparse": v for k, v in errs.items()}


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


RULE_LANES = 3  # the rule lanes' width: the grid's first RULE_POINTS points, one chunk


def _lane_streams(torch, trace, seed, L, kappa, p, dev):
    """Each lane's replay stream of a rule chunk run on ``LaneSampler(seed,
    L)``, rebuilt from ``trace`` (each batched step's active and hit lanes,
    host facts the run kept): the sampler's draws made again in order (one
    ``(L, kappa)`` draw a step on which an active lane missed), a lane's
    row of each draw it took, a row of zeros each step it hit (which its
    sequential replay passes over)."""
    from repro_torch.core import LaneSampler

    sampler = LaneSampler(seed, L, dev)
    zero = torch.zeros(kappa, dtype=torch.int64, device=dev)
    rows = [[] for _ in range(L)]
    for active, hits in trace:
        drew = [a and not h for a, h in zip(active, hits)]
        draw = sampler.uniform_lanes(kappa, p, drew) if any(drew) else None
        for lane, a in enumerate(active):
            if a:
                rows[lane].append(zero if hits[lane] else draw[lane])
    return [torch.stack(r) for r in rows]


def phase3_rule_lanes(torch, design, y, coef, layout, seq_runs):
    """The rules in lanes at the paper's size: the first RULE_POINTS points
    of the lasso grid in one chunk of RULE_LANES lanes through
    ``fw_path_batched`` (its default lane sampler) for away, pairwise,
    PARTAN and lazy, and the elastic-net under away: the launches a batched
    step checked (away and pairwise the lane scores twice, the argmax and
    the lane direction tail once; PARTAN the classic lane kernels; lazy the
    lane tail, the caches' lane scores every turn, the draw's on a miss);
    each lane bit for bit a sequential solve replaying the rows it drew
    (``_lane_streams``, a row of zeros a lazy hit); each point's objective
    within the larger certified gap of it and the sequential rule path's
    point (``phase3_rule_paths``, whose warm starts differ: the chunk's
    lanes all start from zero); the batched and sequential walls and the
    lazy hit share printed. Returns ``(launches, runs)``."""
    from repro_torch import kernels
    from repro_torch.core import LASSO, ENOracle, StreamSampler, delta_grid, engine
    from repro_torch.core import fw_path_batched
    from repro_torch.core.path import point_seed

    sparse = layout == "sparse"
    dev = y.device
    p = design.shape[0]
    base = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    deltas = delta_grid(0.5 * float(coef.abs().sum()), n_points=N_POINTS)[:RULE_POINTS]
    scores = "sparse_sampled_scores_lanes" if sparse else "sampled_scores_lanes"
    launches, runs = {}, {}
    cases = [(rule, LASSO) for rule in RULES] + [("away", ENOracle(l2=EN_L2))]
    for rule, oracle in cases:
        en = oracle is not LASSO
        cfg = dataclasses.replace(base, step_rule=rule)
        tag = f"{rule}-{'en' if en else 'lasso'}-{layout}"
        calls, trace = [], []
        hit_dots = cfg.lazy_cache + 1 + oracle.extra_dots

        def solve_batched_fn(oracle_, Xt_, y_, cfg_, sampler, alpha0s, d_arr):
            calls.append((alpha0s, d_arr))
            last = [0] * RULE_LANES

            def on_step(state, active):  # host ints only: no read of the card
                hits = [rule == "lazy" and a and n - b == hit_dots
                        for a, n, b in zip(active, state.n_dots, last)]
                trace.append((list(active), hits))
                last[:] = state.n_dots

            return engine.solve_batched_prepared(oracle_, Xt_, y_, cfg_, sampler, alpha0s, d_arr,
                                                 on_step)

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=RULE_LANES,
                              oracle=oracle, device=dev, solve_batched_fn=solve_batched_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lc = kernels.launch_counts()
        check(len(calls) == 1, f"rule lanes {tag}: one chunk expected, {len(calls)} ran")
        n = len(trace)
        hits = sum(sum(h) for _, h in trace)
        argmax = "vertex_argmax_shifted_lanes" if en else "vertex_argmax_lanes"
        tail = "step_tail_en_lanes" if en else "step_tail_lanes"
        dtail = "dir_tail_en_lanes" if en else "dir_tail_lanes"
        quiet = ("dir_tail", "dir_tail_en", "step_tail", "step_tail_en", "sampled_scores",
                 "sparse_sampled_scores", "vertex_argmax", "vertex_argmax_shifted")
        if rule in ("away", "pairwise"):
            _check_launches(tag, lc, [((scores,), 2 * n), ((argmax, dtail), n)], quiet + (tail,))
        elif rule == "partan":
            _check_launches(tag, lc, [((scores, argmax, tail), n)], quiet + (dtail,))
        else:
            # the caches' peek every turn (the last one's, which finds every
            # lane stopped, included: one a chunk), the draw's on a miss
            draws = sum(1 for a, h in trace if any(x and not y_ for x, y_ in zip(a, h)))
            _check_launches(tag, lc, [((tail,), n), ((argmax,), draws),
                                      ((scores,), n + draws + len(calls))], quiet + (dtail,))
        launches[dtail] = launches.get(dtail, 0) + lc[dtail]
        # each lane bit for bit its sequential replay on the rows it drew
        alpha0s, d_arr = calls[0]
        streams = _lane_streams(torch, trace, point_seed(0, 0), RULE_LANES, cfg.kappa, p, dev)
        for lane in range(RULE_LANES):
            one = engine.solve(oracle, design, y, cfg, StreamSampler(streams[lane]),
                               None if alpha0s is None else alpha0s[lane], float(d_arr[lane]),
                               device=dev)
            pt = res.points[lane]
            check(one.iterations == pt.iterations and one.n_dots == pt.n_dots,
                  f"rule lanes {tag} lane {lane}: iterations/n_dots {one.iterations}/{one.n_dots}"
                  f" vs the lane's {pt.iterations}/{pt.n_dots}")
            check(torch.equal(one.alpha, _alpha_from_point(torch, pt, p, dev)),
                  f"rule lanes {tag} lane {lane}: alpha differs from its sequential replay")
        del streams
        # against the sequential rule path: the same problems, other warm
        # starts; each point's objective from its alpha (the away rules'
        # recursions may drift from the iterate, ROADMAP.md R5: flagged, as
        # the sequential path flags them)
        seq = seq_runs[tag]
        worst = 0.0
        for g, (got, want) in enumerate(zip(res.points, seq["res"].points)):
            gaps = [_ext_gap(torch, oracle, design, y, pt) for pt in (got, want)]
            objs = [_point_objective(torch, oracle, design, y, pt) for pt in (got, want)]
            if abs(got.objective - objs[0]) > max(gaps[0], RTOL_OBJ_SAME * abs(objs[0])):
                print(f"[flag] rule lanes {tag} point {g}: the recursions' objective "
                      f"{got.objective!r} is off alpha's {objs[0]!r} past its certified gap "
                      f"{gaps[0]!r} (ROADMAP.md R5)")
            diff = abs(objs[0] - objs[1])
            check(diff <= max(max(gaps), RTOL_OBJ_SAME * abs(objs[1])),
                  f"rule lanes {tag} point {g}: objective {objs[0]!r} (from alpha) vs the "
                  f"sequential path's {objs[1]!r}, past the larger certified gap {max(gaps)!r}")
            worst = max(worst, diff / max(max(gaps), 1e-30))
        share = (f"; lazy hits {hits} of {res.total_iters} lane-steps "
                 f"({100 * hits / res.total_iters:.1f}%)" if rule == "lazy" else "")
        print(f"[rule-lanes] {tag}: {RULE_POINTS} points in lanes of {RULE_LANES}, {n} batched "
              f"steps ({res.total_iters} lane-steps against the sequential path's "
              f"{seq['res'].total_iters} steps), batched {wall:.3f} s "
              f"({1e3 * wall / n:.3f} ms a batched step) vs sequential {seq['seconds']:.3f} s; "
              f"each lane bit for bit its sequential replay; objectives within {worst:.3f} of "
              f"the larger certified gap of the sequential path's{share}; launches "
              f"{_nonzero(lc)}")
        runs[tag] = dict(res=res, cfg=cfg, deltas=deltas, seconds=wall, steps=n)
    return launches, runs


def phase3_mesh_rule_lanes(torch, design, y, lane_runs, layout):
    """The rule lanes on the (1, 1) NCCL mesh: the away lasso and
    elastic-net chunks of ``phase3_rule_lanes`` through
    ``distributed.fw_path_batched`` (the same lane streams), bit for bit
    the single-device lanes, the lane direction tail's GIVEN form once a
    batched step (as many as the single device's lane tail) and no
    single-device lane tail. Returns the launches."""
    from repro_torch import distributed as D
    from repro_torch import kernels
    from repro_torch.core import LASSO, ENOracle

    _nccl_world1(torch)
    mesh = D.fw_mesh(1, 1)
    sparse = _is_sparse(design)
    op = (D.shard_sparse if sparse else D.shard_dense)(design, y, mesh, device=y.device)
    launches = {}
    for oracle, tag, given, single in ((LASSO, f"away-lasso-{layout}", "dir_tail_lanes_given",
                                        "dir_tail_lanes"),
                                       (ENOracle(l2=EN_L2), f"away-en-{layout}",
                                        "dir_tail_en_lanes_given", "dir_tail_en_lanes")):
        run = lane_runs[tag]
        kernels.reset_launch_counts()
        res = D.fw_path_batched(op, run["deltas"], run["cfg"], seed=0, lane_width=RULE_LANES,
                                oracle=oracle, report_gap=False)
        lc = kernels.launch_counts()
        check(_points_bits(res, run["res"]), f"mesh rule lanes {tag}: the points differ from the "
                                             "single-device lanes")
        check(lc[given] == run["steps"] and lc[single] == 0,
              f"mesh rule lanes {tag}: {given} {lc[given]} launches for {run['steps']} batched "
              f"steps, {single} {lc[single]}")
        launches[given] = lc[given]
        print(f"[mesh-{layout}] rule lanes {tag}: {RULE_POINTS} points in lanes of {RULE_LANES} "
              f"bit for bit the single-device lanes; {given} once a batched step "
              f"({lc[given]})")
    return launches


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


# phase 4's rule points: their first 50 steps, on both routes (cut from 100
# for the script's time)
RULE_ROUTE_STEPS = 50


def phase4_rule_routes(torch, design, y, coef, layout):
    """Each rule's first grid point on the kernels against the plain route
    ('torch' on the dense layout, the plain sparse ops on the sparse one),
    from the same sampler seed, over its first RULE_ROUTE_STEPS steps (cut
    from the point's end to keep the script in its time), up to the plain
    route's first near-tie."""
    from repro_torch.core import LASSO, delta_grid

    sparse = layout == "sparse"
    p = design.shape[0]
    base = sparse_config(p, fuse_steps=1) if sparse else main_config(p, "kernels")
    plain = (dataclasses.replace(base, sparse_kernel=False) if sparse
             else dataclasses.replace(base, backend="torch"))
    delta = float(delta_grid(0.5 * float(coef.abs().sum()), n_points=N_POINTS)[0])
    for rule in RULES:
        _rule_routes(torch, f"{rule}-{layout} kernels vs plain", design, y, delta,
                     dataclasses.replace(base, step_rule=rule, max_iters=RULE_ROUTE_STEPS),
                     dataclasses.replace(plain, step_rule=rule, max_iters=RULE_ROUTE_STEPS),
                     LASSO)


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


def phase5_rule_lane_timing(torch, design, y, layout):
    """The lane direction tails (f32, lasso and EN, the matrix and the
    GIVEN forms) at DIR_LANE_COUNTS lanes, every lane stepping, at the
    path's shapes, beside their bound (L times the one-lane direction
    tail's bytes, ``phase5_rule_timing``'s) and, at RULE_LANES lanes, plain
    version (L one-lane plain tails), on away steps with the renorm off; no
    single PyTorch call computes the function. Then a
    batched rule step's wall and device busy ms at RULE_LANES lanes (each
    rule on the lasso, away on the elastic-net). Returns the forms' rows at
    RULE_LANES lanes (the path's width)."""
    from repro_torch.core import engine
    from repro_torch.kernels import step_tail as st

    sparse = layout == "sparse"
    dev = y.device
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    m = design.shape[1]
    ell = _ell_of(design)
    # the renorm off: the calls update beta in place, which may send a
    # lane's scale under the threshold, and a renorm is beta's O(p) pass (a
    # block's a lane), the rare step the bound leaves out
    cfg = dataclasses.replace(_dir_cfg(), renorm_threshold=0.0)
    out = {}
    # the states of the most lanes, their first L lanes for each lane count
    states = {l2: dir_lane_state(torch, design, y, g, max(DIR_LANE_COUNTS), l2, torch.float32,
                                 DIR_TIMING_CASES) for l2 in (None, EN_L2)}
    for L in DIR_LANE_COUNTS:
        for l2 in (None, EN_L2):
            beta13, kw13, en13 = states[l2]
            beta = beta13[:L].clone()
            kw = {k: (v if k == "y" else v[:L]) for k, v in kw13.items()}
            en = None if en13 is None else type(en13)(en13.l2, en13.q_norm[:L])
            args = _dir_lane_args(kw, [False] * L)
            ids = torch.arange(L, dtype=torch.int32, device=dev)
            extra = () if en is None else (en,)
            zcols = _dir_zcols(torch, design, kw, m)
            n_buf = kw["buf"].shape[1]
            one = ((3 * m * 4 + 2 * design.nnz_max * 8 if sparse else 5 * m * 4) + 2 * n_buf * 4
                   + 64 + (0 if en is None else 8))
            one_given = 5 * m * 4 + 2 * n_buf * 4 + 64 + (0 if en is None else 8)
            plain_ms = (_time_queued(torch, lambda i: st.dir_tail_lanes_plain(
                ell, beta, *args, ids, False, cfg, en), 3) if L == RULE_LANES else None)
            for fn, mat, nbytes in (
                    ((st.dir_tail_lanes if en is None else st.dir_tail_en_lanes), ell, one),
                    ((st.dir_tail_lanes_given if en is None else st.dir_tail_en_lanes_given),
                     zcols, one_given)):
                ms = _time_queued(torch, lambda i: fn(mat, beta, *args, ids, False, cfg, *extra),
                                  100)
                bound, by = _bound(L * nbytes, L * 10 * m)
                plain = ("not timed" if plain_ms is None
                         else f"{plain_ms:.6f} ms (L one-lane plain tails)")
                print(f"[timing] {fn.__name__} ({layout}, L={L}, m={m:,}): {ms:.6f} ms, bound "
                      f"{bound:.6f} ms ({by}, {L * nbytes:,} bytes), {100 * bound / ms:.1f}% of "
                      f"bound, plain {plain}; library: none")
                if L == RULE_LANES:
                    out[fn.__name__] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                            library_ms=None)
            del beta, kw, zcols
    del states
    from repro_torch.core import LASSO, ENOracle

    base = (sparse_config(design.shape[0], fuse_steps=1) if sparse
            else main_config(design.shape[0], "kernels"))
    stats = engine.precompute_colstats(design, y, base)
    for rule, oracle in [(r, LASSO) for r in RULES] + [("away", ENOracle(l2=EN_L2))]:
        cfg_r = dataclasses.replace(base, step_rule=rule)
        wall, busy, top = batched_step_ms(torch, design, y, stats, cfg_r, RULE_LANES, 100,
                                          oracle)
        name = "lasso" if oracle is LASSO else "en"
        busy_txt = ("device busy not measured (the profiler reported no device time)"
                    if busy is None else
                    f"device busy {busy:.4f} ms ({top}), idle {100 * (1 - busy / wall):.1f}%")
        print(f"[timing] batched {rule} {name} step ({layout}, {RULE_LANES} lanes): wall "
              f"{wall:.4f} ms; {busy_txt}")
    return out if not sparse else {f"{k}_sparse": v for k, v in out.items()}


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
        n = 20 if oracle is LOGISTIC else 50  # cut from 60 and 200 for the script's time
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
# the screened Pyrim path held bit for bit against an unscreened run of its
# first points; H and its plain loop timed on Pyrim's first rows (the plain
# loop at full p takes ~32 s)
CD_BIT_POINTS, CD_PLAIN_ROWS = 3, 2_000
# CD at the paper's dense width: the first points of lambda_grid(n_points=100)
# while the CD points' seconds stay under the budget (at least 3, at most
# 4, cut from 10 for the script's time), FISTA and FW on the same
# points; the walker against H on the design's first rows (Pyrim's p).
# FISTA's time there (300 iterations a point, ~11 ms an iteration: ~3.3 s a
# point) sets the phase's time
CD_4M_BUDGET_S, CD_4M_MIN_POINTS, CD_4M_MAX_POINTS, CD_4M_SLICE = 15.0, 3, 4, 201_376
# FISTA there runs a fixed number of iterations (tol 0): at this width its
# step 1/L is so small that the table's tol 1e-3 on ||alpha_{t+1} -
# alpha_t||_inf stops it after one iteration, at alpha ~ 0, and 100
# iterations leave it 1.2e-3 above CD at the fifth point
CD_4M_FISTA_ITERS = 300
# the re-base thresholds phase 5 times a sweep at, as multiples of the cost
# model's (0: never re-base; Pyrim only: at the dense width that sweep takes
# seconds)
REBASE_SCAN_FACTORS = (0.125, 0.25, 0.5, 1, 2, 4, 0)
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


def _cd_tie_case(torch, g, dev, m, p, dtype, stochastic):
    """A sweep whose rows tie with lam: |z_j . R| within a few ulps of lam
    before and after earlier moves. The movers (rows 10-14, |z . y| far
    above lam) and the general rows lie on the first half of the
    coordinates, the tie rows (0-9 and every other row from 15 to 61) on
    the second: exactly orthogonal, so no move of the first half changes a
    tie row's dot by a bit. f32: each tie row scaled in f64 so z_j . y =
    +-lam (1 + k 2^-24), k from -64 to 64, then rounded to f32; bf16: the
    tie rows are +-copies of one row and lam its |z . y| rounded to f32.
    Returns what ``_cd_case`` returns."""
    from repro_torch.kernels import colstats as cs

    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    h = m // 2
    X = torch.randn((p, m), **f64)
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    ties = torch.tensor(list(range(10)) + list(range(15, min(p, 62), 2)), device=dev)
    first = torch.ones(p, dtype=torch.bool, device=dev)
    first[ties] = False
    X[first, h:] = 0.0
    X[ties, :h] = 0.0
    y = 0.1 * torch.randn(m, **f64)
    y[:h] += 3.0 * X[10:15, :h].sum(0)
    target = 0.3 * float((X[10:15] @ y).abs().max())
    if dtype == torch.float32:
        k = torch.randint(-64, 65, (ties.numel(),), generator=g, device=dev).double()
        sign = torch.where(torch.rand(ties.numel(), **f64) < 0.5, -1.0, 1.0)
        X[ties] *= (sign * target * (1 + k * 2.0 ** -24) / (X[ties] @ y))[:, None]
        lam = float(torch.tensor(target, dtype=torch.float32))
    else:
        base = X[ties[0]].to(dtype).double()
        base *= target / float(base @ y)
        base = base.to(dtype).double()
        sign = torch.where(torch.rand(ties.numel(), **f64) < 0.5, -1.0, 1.0)
        X[ties] = sign[:, None] * base
        lam = float(torch.tensor(abs(float(base @ y.float().double())), dtype=torch.float32))
    X = X.to(dtype).contiguous()
    y = y.float()
    _, zn2 = cs.colstats(X, y)
    order = None
    if stochastic:  # the tie rows again after the movers, a repeat back to back
        order = torch.randint(0, p, (p,), generator=g, device=dev)
        order[:15] = torch.arange(15, device=dev)
        order[15:15 + ties.numel()] = ties
        order[16] = order[15]
    return X, zn2, torch.zeros(p, device=dev), y.clone(), lam, order, float(
        torch.linalg.vector_norm(y))


def _walker_equals_unscreened(torch, walk, unscreened):
    """alpha equal (a zero's sign aside), R and max |d| bit for bit."""
    (a_w, r_w, md_w), (a_h, r_h, md_h) = walk, unscreened
    return (torch.equal(a_w, a_h) and _same_bits(torch, r_w, r_h)
            and _same_bits(torch, md_w, md_h))


def check_cd_score(torch, label, X, R, zn2, alpha, lam):
    """The score pass against ``cd_score_plain`` on the same inputs: NaNs
    (and the chunks' -inf) at the same places, nz within G of each other,
    the headroom and the chunks' least within G (rn + |h|) (the dots'
    rounding in another order, both rounded the safe way). Returns max |h -
    h_plain| * nz, the difference in the dot's units."""
    from repro_torch.kernels import cd_sweep as cds

    p, m = X.shape
    head = torch.empty(p, device=X.device)
    nz, r0n = torch.empty_like(head), torch.empty((), dtype=torch.float64, device=X.device)
    cmin = torch.empty(-(-p // cds.CHUNK), device=X.device)
    cds.cd_score(X, R, zn2, alpha, lam, head, nz, cmin, r0n)
    h_p, nz_p, rn_p, cmin_p = cds.cd_score_plain(X, R, zn2, alpha, lam)
    G = cds.screen_gamma(m)
    nan = torch.isnan(h_p)
    ok = torch.equal(torch.isnan(head), nan)
    inf = torch.isinf(cmin_p)
    ok &= torch.equal(torch.isinf(cmin), inf) and bool(torch.all(
        (cmin.double() - cmin_p.double()).abs()[~inf]
        <= G * (rn_p + cmin_p.double().abs()[~inf]) + 1e-30))
    dh = (head.double() - h_p.double()).abs()[~nan]
    ok &= bool(torch.all(dh <= G * (rn_p + h_p.double().abs()[~nan]) + 1e-30))
    ok &= bool(torch.all((nz.double() - nz_p.double()).abs() <= G * nz_p.double()))
    ok &= abs(float(r0n) - rn_p) <= G * rn_p
    check(ok, f"{label}: the score pass and its plain version differ past G")
    return float((dh * nz_p.double()[~nan]).max()) if dh.numel() else 0.0


def check_cd_sweep(torch, label, X, zn2, alpha0, R0, lam, order, y_norm, nothing_moves=False):
    """The walker twice (equal bits), against the unscreened kernel H bit for
    bit (alpha equal up to a zero's sign, R and max |d| bitwise), and the
    screened plain version (bit for bit the unscreened plain loop, also run)
    within TOL_CD; with ``nothing_moves`` (lam above lam_max from zero)
    alpha stays 0, R its bits and max |d| 0. Returns the largest |difference|
    of alpha and R from the plain versions (H's are the walker's: the same
    bits)."""
    from repro_torch.kernels import cd_sweep as cds

    runs = []
    for _ in range(2):
        a, r = alpha0.clone(), R0.clone()
        before = cds.STATS.snapshot()
        md = cds.cd_sweep(X, a, r, zn2, lam, order)
        runs.append((a, r, md))
    torch.cuda.synchronize()
    stats = {k: v - before[k] for k, v in cds.STATS.snapshot().items()}
    check(all(_same_bits(torch, u, v) for u, v in zip(*runs)), f"{label}: two walks differ")
    a_k, r_k, md_k = runs[0]
    a_h, r_h = alpha0.clone(), R0.clone()
    md_h = cds.cd_sweep_unscreened(X, a_h, r_h, zn2, lam, order)
    check(_walker_equals_unscreened(torch, runs[0], (a_h, r_h, md_h)),
          f"{label}: the walker and the unscreened sweep differ")
    a_s, r_s = alpha0.clone(), R0.clone()
    md_s = cds.cd_sweep_screened_plain(X, a_s, r_s, zn2, lam, order)
    a_p, r_p = alpha0.clone(), R0.clone()
    md_p = cds.cd_sweep_plain(X, a_p, r_p, zn2, lam, order)
    check(_walker_equals_unscreened(torch, (a_s, r_s, md_s), (a_p, r_p, md_p)),
          f"{label}: the screened plain sweep and the plain loop differ")
    moved = int(torch.count_nonzero(a_k != alpha0))
    a_scale = max(float(a_p.abs().max()), float(a_k.abs().max()))
    d_a, d_r = float((a_k - a_p).abs().max()), float((r_k - r_p).abs().max())
    d_md = abs(float(md_k) - float(md_p))
    only = torch.nonzero((a_k != 0) != (a_p != 0)).view(-1)
    ties = [(int(j), float(a_k[j]), float(a_p[j])) for j in only[:8].tolist()]
    print(f"[cd_sweep] {label}: walker = H bit for bit; against plain: alpha {d_a:.3g} "
          f"({d_a / max(a_scale, 1e-30):.3g} of ||alpha||_inf {a_scale:.4g}), R {d_r:.3g} "
          f"({d_r / y_norm:.3g} of ||y||), max|d| {float(md_k)!r} vs {float(md_p)!r}, active "
          f"{int(torch.count_nonzero(a_k))} vs {int(torch.count_nonzero(a_p))}, {moved} moved, "
          f"near-ties in one support only: {only.numel()} {ties}; survivors "
          f"{stats['survivors']} of {stats['positions']} ({stats['rebases']} re-bases); twice: "
          f"equal bits")
    check(d_a <= TOL_CD * a_scale and d_r <= TOL_CD * y_norm and d_md <= TOL_CD * a_scale,
          f"{label}: kernel and plain sweep differ past TOL_CD")
    check(bool(torch.all((a_k[only].abs() <= TOL_CD * a_scale)
                         & (a_p[only].abs() <= TOL_CD * a_scale))),
          f"{label}: a support difference that is not a near-tie: {ties}")
    if nothing_moves:
        check(not bool(torch.any(a_k != 0)) and _same_bits(torch, r_k, R0)
              and float(md_k) == 0.0, f"{label}: something moved above lam_max")
    return max(d_a, d_r)


def phase2_cd_sweep(torch, dev):
    """The screened sweep (the score pass and the walker) against the
    unscreened kernel H (bit for bit) and the plain versions on the card:
    cyclic and stochastic orders (repeats inside the ring's window and back
    to back), m = 74, 186, 800, 20,000 (R in shared memory) and 60,000
    (past the on-chip cap), lam = 0, lam > lam_max, a warm start, a zero
    column, near-ties (``_cd_tie_case``), f32 and bf16, and one forced
    re-base after every idle survivor."""
    from repro_torch.kernels import cd_sweep as cds

    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    err = {"cd_walk": 0.0, "cd_sweep_unscreened": 0.0, "cd_score": 0.0}
    cases = [(m, dt, kind) for m in CD_M_CASES for dt in (torch.float32, torch.bfloat16)
             for kind in ("cyclic", "stochastic")]
    cases += [(800, torch.float32, kind) for kind in ("lam_zero", "above_lam_max", "warm",
                                                      "zero_column")]
    cases += [(74, torch.bfloat16, "warm"), (CD_M_SMEM, torch.float32, "stochastic"),
              (CD_M_PAST_CAP, torch.float32, "cyclic"), (CD_M_PAST_CAP, torch.bfloat16,
                                                         "stochastic")]
    cases += [(m, dt, kind) for m in (74, 800) for dt in (torch.float32, torch.bfloat16)
              for kind in ("tie", "tie_stochastic")]
    cases += [(CD_M_SMEM, torch.float32, "tie")]
    for m, dt, kind in cases:
        p = 1000 if m <= 800 else 300
        if kind.startswith("tie"):
            X, zn2, alpha0, R0, lam, order, y_norm = _cd_tie_case(
                torch, g, dev, m, p, dt, kind == "tie_stochastic")
        else:
            X, zn2, alpha0, R0, lam, order, y_norm = _cd_case(torch, g, dev, m, p, dt, kind)
        pl = cds.walk_plan(m, dt)
        label = (f"m={m} p={p} {str(dt).replace('torch.', '')} {kind} ({pl.route}, "
                 f"{pl.threads} threads, {pl.chain_threads} in the chain, R "
                 f"{'on chip' if cds.sweep_plan(m, dt).residual_on_chip else 'in device memory'})")
        err["cd_score"] = max(err["cd_score"], check_cd_score(torch, label, X, R0, zn2, alpha0,
                                                              lam))
        e = check_cd_sweep(torch, label, X, zn2, alpha0, R0, lam, order, y_norm,
                           nothing_moves=kind == "above_lam_max")
        err["cd_walk"] = err["cd_sweep_unscreened"] = max(err["cd_walk"], e)
    # a re-base after every idle survivor: the same bits as one walk
    X, zn2, alpha0, R0, lam, order, _ = _cd_case(torch, g, dev, 74, 1000, torch.float32,
                                                 "stochastic")
    out = []
    for limit in (1, 0):
        a, r = alpha0.clone(), R0.clone()
        before = cds.STATS.rebases
        out.append((a, r, cds.cd_sweep(X, a, r, zn2, lam / 3, order, rebase_after=limit)))
        print(f"[cd_sweep] rebase_after={limit}: {cds.STATS.rebases - before} re-bases")
    check(_walker_equals_unscreened(torch, *out), "a forced re-base changed the sweep's bits")
    print(f"[cd_sweep] phase 2: {len(cases) + 1} cases in {time.perf_counter() - t0:.1f} s")
    return err


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


def _stats_since(cds, before):
    return {k: v - before[k] for k, v in cds.STATS.snapshot().items()}


def _check_walks(tag, kernels, cds, st, sweeps):
    """Walker launches = sweeps + re-bases, a score pass a walk, H never."""
    n = kernels.launch_counts()
    check(0 < st["sweeps"] == sweeps and n["cd_walk"] == sweeps + st["rebases"] == st["walks"]
          and n["cd_score"] == n["cd_walk"] and n["cd_sweep_unscreened"] == 0,
          f"{tag}: cd_walk {n['cd_walk']} / cd_score {n['cd_score']} launches != sweeps "
          f"{sweeps} + re-bases {st['rebases']}, or H launched ({n['cd_sweep_unscreened']})")
    print(f"[{tag}] launches: cd_walk {n['cd_walk']} = {sweeps} sweeps + {st['rebases']} "
          f"re-bases, cd_score {n['cd_score']}, cd_sweep_unscreened 0; survivors "
          f"{st['survivors']:,} of {st['positions']:,} positions "
          f"({100 * st['survivors'] / max(st['positions'], 1):.4f}%), "
          f"{st['survivors'] / max(sweeps, 1):.1f} a sweep, idle {st['idle']:,}")
    return n["cd_walk"], n["cd_score"]


def _sweep_pair(torch, cds, Xt, zn2, alpha0, R0, lam, order=None):
    """The screened and the unscreened sweep from the same state: both
    results and whether they agree (alpha up to a zero's sign, R and max |d|
    bitwise)."""
    a_w, r_w = alpha0.clone(), R0.clone()
    md_w = cds.cd_sweep(Xt, a_w, r_w, zn2, lam, order)
    a_h, r_h = alpha0.clone(), R0.clone()
    md_h = cds.cd_sweep_unscreened(Xt, a_h, r_h, zn2, lam, order)
    torch.cuda.synchronize()
    return (a_w, r_w, md_w), _walker_equals_unscreened(torch, (a_w, r_w, md_w), (a_h, r_h, md_h))


def _time_sweeps(torch, fn, reset, reps, flush):
    """A sweep's device ms (CUDA events around the call, the host's reads
    between walks included) and host ms, the state reset and the L2 flushed
    before each (outside the timed span); the first call untimed."""
    reset()
    fn()
    dev_ms, host_ms = 0.0, 0.0
    for _ in range(reps):
        reset()
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host_ms += 1e3 * (time.perf_counter() - t0)
        dev_ms += start.elapsed_time(end)
    return dev_ms / reps, host_ms / reps


def _walker_ms(torch, cds, Xt, zn2, alpha, resid, lam, reset, flush, reps):
    """The walker's own device ms a sweep from reset()'s state under the
    path's re-base rule: each walk's launch between CUDA events, summed over
    the sweep's walks; the score passes between them run untimed; the L2
    flushed before each sweep; the first sweep untimed. Returns (ms,
    survivors, walks) of a sweep."""
    p, m = Xt.shape
    dev = Xt.device
    limit = cds.rebase_threshold(p, m, Xt.dtype)
    head, nz = torch.empty(p, device=dev), torch.empty(p, device=dev)
    cmin = torch.empty(-(-p // cds.CHUNK), device=dev)
    r0n = torch.empty((), dtype=torch.float64, device=dev)
    io = torch.zeros(3, dtype=torch.int64, device=dev)
    md = torch.zeros((), device=dev)

    def sweep():
        io.zero_()
        md.zero_()
        total, walks = 0.0, 0
        while True:
            cds.cd_score(Xt, resid, zn2, alpha, lam, head, nz, cmin, r0n)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            cds.cd_walk(Xt, alpha, resid, zn2, None, head, nz, cmin, r0n, md, io, lam, limit)
            end.record()
            pos, surv, _ = io.tolist()  # the walk's host read, as the path's
            total += start.elapsed_time(end)
            walks += 1
            if pos >= p:
                return total, surv, walks

    reset()
    sweep()
    total = 0.0
    for _ in range(reps):
        reset()
        flush.zero_()
        torch.cuda.synchronize()
        ms, surv, walks = sweep()
        total += ms
    return total / reps, surv, walks


def _plain_walker_ms(torch, cds, Xt, zn2, alpha, resid, lam, reset):
    """The walker's plain version's ms (host clock) over a sweep from
    reset()'s state under the path's re-base rule: each plain walk timed,
    the plain score passes between them untimed."""
    p, m = Xt.shape
    limit = cds.rebase_threshold(p, m, Xt.dtype)
    lam32 = float(torch.tensor(lam, dtype=torch.float32))
    n2_floor = torch.clamp_min(zn2, 1e-12)
    md = torch.zeros((), device=Xt.device)
    reset()
    pos, total = 0, 0.0
    while pos < p:
        head, nz, rn, _ = cds.cd_score_plain(Xt, resid, zn2, alpha, lam32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos, md, _, _ = cds._walk_plain(Xt, alpha, resid, zn2, n2_floor, lam32, None, head, nz,
                                        rn, pos, limit, md)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return 1e3 * total


def _rebase_scan(torch, cds, tag, Xt, zn2, alpha0, R0, lam, limits, flush, reps=3):
    """A sweep's device ms from (alpha0, R0) at each re-base threshold
    (``rebase_after``; 0: never), with its survivors and re-bases."""
    alpha, resid = alpha0.clone(), R0.clone()

    def reset():
        alpha.copy_(alpha0)
        resid.copy_(R0)

    cells = []
    for limit in limits:
        before = cds.STATS.snapshot()
        ms, _ = _time_sweeps(torch, lambda: cds.cd_sweep(Xt, alpha, resid, zn2, lam,
                                                         rebase_after=limit), reset, reps, flush)
        st = _stats_since(cds, before)
        cells.append(f"{limit}: {ms:.4f} ms ({st['survivors'] / st['sweeps']:.0f} survivors, "
                     f"{st['rebases'] / st['sweeps']:.1f} re-bases)")
    print(f"[rebase] {tag}, a sweep's device ms by idle survivors before a re-base (0: never; "
          f"the cost model's {cds.rebase_threshold(*Xt.shape, Xt.dtype)}): " + "; ".join(cells))


def phase3_baselines(torch, dev, launches, errs):
    """The paper's comparison on the card, on Pyrim at its published size:
    cyclic CD on the first PYRIM_POINTS points of a 100-point lambda grid,
    stochastic CD on the first PYRIM_STOCH_POINTS, both through the
    screened sweep (the walker launches = sweeps + re-bases), the cyclic
    path's first CD_BIT_POINTS points again through the unscreened kernel H
    (bit for bit), penalized FISTA on the same points as cyclic CD, and the
    FW path at the CD points' l1 norms (paper §2.1); one warm sweep at full
    p through the walker and H (bit for bit); then (phase 5) the screened
    sweep cold and warm, the score pass, H, the chain's floor and a FISTA
    iteration. Returns the CD kernels' timing rows; the errors join ``errs``."""
    from repro_torch import kernels
    from repro_torch.core import (CDConfig, FISTAConfig, baselines, cd_path, fista_path,
                                  fw_path, lambda_grid)
    from repro_torch.data import PROXY_SPECS, make_proxy
    from repro_torch.kernels import cd_sweep as cds
    from repro_torch.kernels import colstats as cs

    import numpy as np

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
    wp = cds.walk_plan(m, Xt.dtype)
    print(f"[pyrim] lambda_grid(n_points=100): lam_max {lams[0]:.6g}; points 0-"
          f"{PYRIM_POINTS - 1} down to {lams[PYRIM_POINTS - 1]:.6g}; the walker's route "
          f"{wp.route}, {wp.threads} threads ({wp.chain_threads} in the chain); a re-base "
          f"after {cds.rebase_threshold(p, m)} idle survivors")

    cfg = CDConfig(lam=0.0, max_sweeps=CD_SWEEPS, tol=BASELINE_TOL)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    before = cds.STATS.snapshot()
    cd = cd_path(Xt, y, lams[:PYRIM_POINTS], cfg, seed=0)
    st_cd = _stats_since(cds, before)
    _print_baseline_points("cd", cd, "sweeps")
    n_walk, n_score = _check_walks("cd", kernels, cds, st_cd, cd.total_iters)
    kernels.reset_launch_counts()
    before = cds.STATS.snapshot()
    scd = cd_path(Xt, y, lams[:PYRIM_STOCH_POINTS], dataclasses.replace(cfg, stochastic=True),
                  seed=0)
    st_scd = _stats_since(cds, before)
    _print_baseline_points("scd", scd, "sweeps")
    w, sc = _check_walks("scd", kernels, cds, st_scd, scd.total_iters)
    for name, n in (("cd_walk", n_walk + w), ("cd_score", n_score + sc),
                    ("cd_sweep_unscreened", 0)):  # with the dense width's, when it ran
        launches[name] = launches.get(name, 0) + n
    print(f"[cd] CD paths {time.perf_counter() - t0:.1f} s")

    # the screened path against an unscreened run of its first points, bit
    # for bit: the same sweeps, objectives and supports with their values
    t0 = time.perf_counter()
    screened_sweep = baselines.cd_sweep
    baselines.cd_sweep = cds.cd_sweep_unscreened
    try:
        kernels.reset_launch_counts()
        ref = cd_path(Xt, y, lams[:CD_BIT_POINTS], cfg, seed=0)
        n_h = kernels.launch_counts()["cd_sweep_unscreened"]
    finally:
        baselines.cd_sweep = screened_sweep
    for g, (a, b) in enumerate(zip(cd.points, ref.points)):
        same = (a.iterations == b.iterations and a.objective == b.objective
                and np.array_equal(a.alpha_nnz_idx, b.alpha_nnz_idx)
                and np.array_equal(a.alpha_nnz_val, b.alpha_nnz_val))
        print(f"[cd-bits] point {g}: screened {a.iterations} sweeps {a.seconds:.4f} s, "
              f"unscreened {b.iterations} sweeps {b.seconds:.4f} s: "
              f"{'bit for bit' if same else 'DIFFERENT'}")
        check(same, f"point {g}: the screened and the unscreened path differ")
    check(n_h == ref.total_iters, "the unscreened path's launches != its sweeps")
    print(f"[cd-bits] the first {CD_BIT_POINTS} points bit for bit ({n_h} unscreened sweeps, "
          f"{time.perf_counter() - t0:.1f} s)")

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
          f"{1e3 * cd.total_seconds / cd.total_iters:.4f} ms a sweep, {cd.total_dots:,} dots, "
          f"mean active {cd.mean_active:.1f}); stochastic CD {scd.total_seconds:.3f} s "
          f"({scd.total_iters} sweeps, 3 points); FISTA {fi.total_seconds:.3f} s "
          f"({fi.total_iters} iterations, {fi.total_dots:,} dots, mean active "
          f"{fi.mean_active:.1f}); FW {fw.total_seconds:.3f} s ({fw.total_iters} iterations, "
          f"kappa {fw_cfg.kappa}, {fw.total_dots:,} dots, mean active {fw.mean_active:.1f}); "
          f"FISTA and FW {time.perf_counter() - t0:.1f} s")

    # one warm sweep at full p, the walker against H bit for bit: from the
    # last point but one's alpha and residual at the last point's lam, where
    # coordinates move (at lams[0] = lam_max none can)
    _, zn2 = cs.colstats(Xt, y)
    lam = float(lams[PYRIM_POINTS - 1])
    warm = _alpha_from_point(torch, cd.points[-2], p, dev)
    R_warm = y - torch.mv(Xt.t(), warm)
    before = cds.STATS.snapshot()
    (a_w, _, _), same = _sweep_pair(torch, cds, Xt, zn2, warm, R_warm, lam)
    st_w = _stats_since(cds, before)
    moved = int(torch.count_nonzero(a_w != warm))
    print(f"[cd] warm sweep at full p (point {PYRIM_POINTS - 2}'s alpha at point "
          f"{PYRIM_POINTS - 1}'s lam): walker {'= H bit for bit' if same else '!= H'}; {moved} "
          f"coordinates moved; survivors {st_w['survivors']} of {p:,} "
          f"({100 * st_w['survivors'] / p:.4f}%), {st_w['rebases']} re-bases")
    check(same and moved > 0, "the warm Pyrim sweep: the walker differs from H, or nothing moved")

    # phase 5: the screened sweep cold (from zero at the last point's lam, as
    # H is timed) and warm, the score pass, H and its chain's floor, the plain
    # versions; L2 flushed before each
    flush = torch.empty(64 * 2**20, device=dev)
    alpha, resid = torch.zeros(p, device=dev), y.clone()

    def cold():
        alpha.zero_()
        resid.copy_(y)

    def warm_state():
        alpha.copy_(warm)
        resid.copy_(R_warm)

    sweep = lambda: cds.cd_sweep(Xt, alpha, resid, zn2, lam)  # noqa: E731
    before = cds.STATS.snapshot()
    ms_cold, host_cold = _time_sweeps(torch, sweep, cold, 5, flush)
    st_cold = _stats_since(cds, before)
    before = cds.STATS.snapshot()
    ms_warm, host_warm = _time_sweeps(torch, sweep, warm_state, 5, flush)
    st_warmt = _stats_since(cds, before)
    order = torch.randint(0, p, (p,), device=dev)
    ms_sto, _ = _time_sweeps(torch, lambda: cds.cd_sweep(Xt, alpha, resid, zn2, lam, order), cold,
                             3, flush)
    head, nz = torch.empty(p, device=dev), torch.empty(p, device=dev)
    cmin = torch.empty(-(-p // cds.CHUNK), device=dev)
    r0n = torch.empty((), dtype=torch.float64, device=dev)
    score_ms = _time_cold(torch, lambda: cds.cd_score(Xt, resid, zn2, alpha, lam, head, nz, cmin,
                                                      r0n), 20, flush)
    # the walker's own launches in a sweep, cold and warm, the path's re-base
    # rule; its plain version on the cold state
    walk_cold, surv_cold, walks_cold = _walker_ms(torch, cds, Xt, zn2, alpha, resid, lam, cold,
                                                  flush, 5)
    walk_warm, surv_warm, walks_warm = _walker_ms(torch, cds, Xt, zn2, alpha, resid, lam,
                                                  warm_state, flush, 5)
    walk_plain_ms = _plain_walker_ms(torch, cds, Xt, zn2, alpha, resid, lam, cold)
    limits = [max(1, round(f * cds.rebase_threshold(p, m))) if f else 0
              for f in REBASE_SCAN_FACTORS]
    _rebase_scan(torch, cds, "Pyrim cold", Xt, zn2, torch.zeros(p, device=dev), y, lam, limits,
                 flush)
    _rebase_scan(torch, cds, "Pyrim warm", Xt, zn2, warm, R_warm, lam, limits, flush)
    ms_h = _time_cold(torch, lambda: cds.cd_sweep_unscreened(Xt, alpha, resid, zn2, lam), 3,
                      flush)
    floor_ms = _time_cold(torch, lambda: cds.chain_floor(p, dev), 3, flush)
    # H and its plain loop on the same CD_PLAIN_ROWS rows, cold from zero
    Xs, zs = Xt[:CD_PLAIN_ROWS], zn2[:CD_PLAIN_ROWS]
    a_s, r_s = torch.zeros(CD_PLAIN_ROWS, device=dev), y.clone()

    def cold_slice():
        a_s.zero_()
        r_s.copy_(y)

    ms_h_slice, _ = _time_sweeps(torch, lambda: cds.cd_sweep_unscreened(Xs, a_s, r_s, zs, lam),
                                 cold_slice, 5, flush)
    cold_slice()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cds.cd_sweep_plain(Xs, a_s, r_s, zs, lam)
    torch.cuda.synchronize()
    h_plain_ms = 1e3 * (time.perf_counter() - t0)
    # the screened sweep's plain version warm at full p (host clock), the
    # score pass's plain version queued
    warm_state()
    t0 = time.perf_counter()
    cds.cd_sweep_screened_plain(Xt, alpha, resid, zn2, lam)
    torch.cuda.synchronize()
    sweep_plain_ms = 1e3 * (time.perf_counter() - t0)
    score_plain_ms = _time_queued(torch, lambda i: cds.cd_score_plain(Xt, resid, zn2, alpha,
                                                                      lam), 20)
    score_lib_ms = _time_queued(torch, lambda i: torch.mv(Xt, resid), 200)
    b_sweep = _bound(cds.screened_bytes(p, m, Xt.dtype, ordered=False), 4 * p * m)
    b_walk = _bound(cds.walk_bytes(p, m, Xt.dtype, surv_cold, walks_cold, ordered=False),
                    4 * surv_cold * m)
    b_h = _bound(cds.sweep_bytes(p, m, Xt.dtype, ordered=False), 4 * p * m)
    b_h_slice = _bound(cds.sweep_bytes(CD_PLAIN_ROWS, m, Xt.dtype, ordered=False),
                       4 * CD_PLAIN_ROWS * m)
    b_score = _bound(cds.score_bytes(p, m, Xt.dtype), 4 * p * m)
    path_ms = 1e3 * cd.total_seconds / cd.total_iters
    print(f"[timing] screened CD sweep (Pyrim, m={m}, p={p:,}, cyclic, lam = point "
          f"{PYRIM_POINTS - 1}'s, L2 flushed): cold from zero {ms_cold:.6f} ms device "
          f"({host_cold:.6f} ms host; survivors {st_cold['survivors'] / st_cold['sweeps']:.1f} "
          f"a sweep, {st_cold['rebases'] / st_cold['sweeps']:.2f} re-bases), warm "
          f"{ms_warm:.6f} ms device ({host_warm:.6f} ms host; survivors "
          f"{st_warmt['survivors'] / st_warmt['sweeps']:.1f} a sweep, "
          f"{100 * st_warmt['survivors'] / st_warmt['positions']:.4f}% of p), stochastic cold "
          f"{ms_sto:.6f} ms; the path's mean {path_ms:.6f} ms a sweep (host clock, "
          f"{cd.total_iters} sweeps); bound {b_sweep[0]:.6f} ms ({b_sweep[1]}), "
          f"{100 * b_sweep[0] / ms_cold:.2f}% of bound cold; plain (screened, warm, host) "
          f"{sweep_plain_ms:.6f} ms")
    print(f"[timing] the walker's own launches a sweep (the path's re-base rule): cold "
          f"{walk_cold:.6f} ms ({walks_cold} walks, {surv_cold} survivors; bound "
          f"{b_walk[0]:.6f} ms by {b_walk[1]}, {100 * b_walk[0] / walk_cold:.2f}%; plain walks "
          f"on the same state {walk_plain_ms:.6f} ms, host), warm {walk_warm:.6f} ms "
          f"({walks_warm} walks, {surv_warm} survivors); the score pass {score_ms:.6f} ms (bound "
          f"{b_score[0]:.6f} ms, {100 * b_score[0] / score_ms:.2f}%; plain {score_plain_ms:.6f} "
          f"ms; torch.mv of its c alone {score_lib_ms:.6f} ms)")
    print(f"[timing] cd_sweep_unscreened (H, cold from zero, the state carried across reps): "
          f"{ms_h:.6f} ms a sweep, bound {b_h[0]:.6f} ms ({100 * b_h[0] / ms_h:.2f}%); the "
          f"chain's floor, {p:,} dependent warp sums: {floor_ms:.6f} ms; {1e6 * ms_h / p:.1f} ns "
          f"a coordinate; screened cold / H {ms_cold / ms_h:.5f}, warm / H {ms_warm / ms_h:.5f}; "
          f"on the first {CD_PLAIN_ROWS:,} rows from zero: H {ms_h_slice:.6f} ms (bound "
          f"{b_h_slice[0]:.6f} ms), its plain loop {h_plain_ms:.6f} ms (host)")
    rows = {
        "cd_walk": dict(ms=walk_cold, plain_ms=walk_plain_ms, library_ms=None,
                        bound_ms=b_walk[0], bound_by=b_walk[1],
                        timed_on=f"Pyrim m={m} p={p}, a cold sweep's walks"),
        "cd_score": dict(ms=score_ms, plain_ms=score_plain_ms, library_ms=None,
                         bound_ms=b_score[0], bound_by=b_score[1]),
        "cd_sweep_unscreened": dict(ms=ms_h_slice, plain_ms=h_plain_ms, library_ms=None,
                                    bound_ms=b_h_slice[0], bound_by=b_h_slice[1],
                                    timed_on=f"Pyrim's first {CD_PLAIN_ROWS} rows, m={m}"),
    }

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
    return rows


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

def phase3_cd_paper_width(torch, Xt, y):
    """CD at the paper's dense width (p = 4,272,227, m = 800, the main
    path's design): cyclic CD (table 4's settings) point by point down
    lambda_grid(n_points=100), each point warm-started from the one before,
    while the budget allows; penalized FISTA on the same points, each CD
    point's penalized objective within 1e-3 of FISTA's; the FW path at CD's
    l1 norms beside them (paper Table 4 at 4M variables). Then the walker
    against H bit for bit on the design's first CD_4M_SLICE rows."""
    from repro_torch import kernels
    from repro_torch.core import CDConfig, FISTAConfig, baselines, fista_path, fw_path, lambda_grid
    from repro_torch.kernels import cd_sweep as cds
    from repro_torch.kernels import colstats as cs

    t_phase = time.perf_counter()
    p, m = Xt.shape
    lams = lambda_grid(Xt, y, n_points=100)
    cfg = CDConfig(lam=0.0, max_sweeps=CD_SWEEPS, tol=BASELINE_TOL)
    wp = cds.walk_plan(m, Xt.dtype)
    print(f"[cd-4m] p={p:,} m={m} f32: lam_max {lams[0]:.6g}; the walker's route {wp.route}, "
          f"{wp.threads} threads ({wp.chain_threads} in the chain); a re-base after "
          f"{cds.rebase_threshold(p, m)} idle survivors")
    kernels.reset_launch_counts()
    before_all = cds.STATS.snapshot()
    points, alpha, prev, cd_s = [], None, None, 0.0
    while len(points) < CD_4M_MAX_POINTS and (len(points) < CD_4M_MIN_POINTS
                                               or cd_s < CD_4M_BUDGET_S):
        g, lam = len(points), float(lams[len(points)])
        before = cds.STATS.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = baselines.cd_solve(Xt, y, cfg, None, alpha, lam=lam)
        objective = float(res.objective)
        dt = time.perf_counter() - t0
        cd_s += dt
        st = _stats_since(cds, before)
        prev, alpha = alpha, res.alpha
        l1 = float(alpha.abs().sum())
        # the penalized lasso's duality gap at the scaled residual
        r = y - torch.mv(Xt.t(), alpha)
        theta = r * min(1.0, lam / float(torch.mv(Xt, r).abs().max()))
        pen = 0.5 * float(r.double() @ r.double()) + lam * l1
        dual = 0.5 * float(y.double() @ y.double()) - 0.5 * float(
            (y - theta).double() @ (y - theta).double())
        points.append(dict(lam=lam, objective=objective, l1=l1, sweeps=res.iterations,
                           seconds=dt, active=res.active, gap=pen - dual))
        print(f"[cd-4m] point {g} lam={lam:.6g}: {res.iterations} sweeps, {st['rebases']} "
              f"re-bases, survivors {st['survivors'] / res.iterations:.1f} a sweep "
              f"({100 * st['survivors'] / st['positions']:.5f}% of p), {dt:.3f} s "
              f"({1e3 * dt / res.iterations:.3f} ms a sweep), active {res.active}, l1 {l1:.6g}, "
              f"objective {objective!r}, penalized {objective + lam * l1!r}, duality gap "
              f"{pen - dual:.6g} ({(pen - dual) / pen:.3g} of it)")
        check(math.isfinite(objective) and pen - dual <= 1e-3 * pen,
              f"CD at the dense width, point {g}: not finite, or its gap past 1e-3")
    n = len(points)
    st = _stats_since(cds, before_all)
    walks = _check_walks("cd-4m", kernels, cds, st, sum(pt["sweeps"] for pt in points))

    # a sweep near lam_max on the device's clock: point 1's lam from zero
    flush = torch.empty(64 * 2**20, device=Xt.device)
    a0, r0 = torch.zeros(p, device=Xt.device), y.clone()
    _, zn2 = cs.colstats(Xt, y)

    def reset():
        a0.zero_()
        r0.copy_(y)

    before = cds.STATS.snapshot()
    sweep_ms, sweep_host = _time_sweeps(torch, lambda: cds.cd_sweep(Xt, a0, r0, zn2, lams[1]),
                                        reset, 3, flush)
    st1 = _stats_since(cds, before)
    head, nz = torch.empty(p, device=Xt.device), torch.empty(p, device=Xt.device)
    cmin = torch.empty(-(-p // cds.CHUNK), device=Xt.device)
    r0n = torch.empty((), dtype=torch.float64, device=Xt.device)
    score_ms = _time_cold(torch, lambda: cds.cd_score(Xt, y, zn2, a0, lams[1], head, nz, cmin,
                                                      r0n), 3, flush)
    b_score = _bound(cds.score_bytes(p, m, Xt.dtype), 4 * p * m)
    walk_ms, surv, walks1 = _walker_ms(torch, cds, Xt, zn2, a0, r0, lams[1], reset, flush, 3)
    b_walk = _bound(cds.walk_bytes(p, m, Xt.dtype, surv, walks1, ordered=False), 4 * surv * m)
    print(f"[timing] dense-width sweep from zero at point 1's lam: {sweep_ms:.6f} ms device "
          f"({sweep_host:.6f} ms host; survivors {st1['survivors'] / st1['sweeps']:.1f} a sweep, "
          f"{st1['rebases'] / st1['sweeps']:.2f} re-bases); the score pass {score_ms:.6f} ms "
          f"(bound {b_score[0]:.6f} ms, {100 * b_score[0] / score_ms:.2f}%); the walker's own "
          f"launches {walk_ms:.6f} ms ({walks1} walks, {surv} survivors; bound "
          f"{b_walk[0]:.6f} ms, {100 * b_walk[0] / walk_ms:.2f}%)")
    # the last point's first sweep, warm from the point before, at each
    # re-base threshold
    limits = [max(1, round(f * cds.rebase_threshold(p, m))) for f in REBASE_SCAN_FACTORS if f]
    _rebase_scan(torch, cds, f"dense width, point {len(points) - 1} warm", Xt, zn2, prev,
                 y - torch.mv(Xt.t(), prev), points[-1]["lam"], limits, flush, reps=2)
    del a0, r0, head, nz, flush

    t0 = time.perf_counter()
    fi = fista_path(Xt, y, lams[:n], FISTAConfig(max_iters=CD_4M_FISTA_ITERS, tol=0.0), seed=0)
    fista_s = time.perf_counter() - t0
    fw_cfg = main_config(p, "kernels")
    fw = fw_path(Xt, y, [pt["l1"] for pt in points], fw_cfg, seed=0, device=Xt.device)
    for g, (a, b, c) in enumerate(zip(points, fi.points, fw.points)):
        pen_cd = a["objective"] + a["lam"] * a["l1"]
        rel = abs(pen_cd - _penalized(b)) / abs(_penalized(b))
        print(f"[cd-4m-vs-fista] point {g}: penalized CD {pen_cd!r} ({a['seconds']:.3f} s, "
              f"{a['sweeps']} sweeps) FISTA {_penalized(b)!r} ({b.seconds:.3f} s, "
              f"{b.iterations} iterations) rel {rel:.3g}; FW at CD's l1 {a['l1']:.6g}: objective {c.objective!r} (CD's "
              f"{a['objective']!r}, ratio {c.objective / a['objective']:.6f}), {c.seconds:.3f} s, "
              f"{c.iterations} iterations")
        check(rel <= 1e-3, f"CD at the dense width, point {g}: CD and FISTA apart by {rel:.3g}")
    print(f"[cd-4m] {n} points: CD {cd_s:.3f} s ({sum(pt['sweeps'] for pt in points)} sweeps), "
          f"FISTA {fista_s:.3f} s ({fi.total_iters} iterations), FW {fw.total_seconds:.3f} s "
          f"({fw.total_iters} iterations)")

    # the walker against H on the design's first rows, from zero at a lam
    # where coordinates of those rows move (half their own lam_max)
    t0 = time.perf_counter()
    Xs = Xt[:CD_4M_SLICE]
    _, zn2 = cs.colstats(Xs, y)
    lam = float((Xs @ y).abs().max()) / 2
    before = cds.STATS.snapshot()
    (a_w, _, _), same = _sweep_pair(torch, cds, Xs, zn2, torch.zeros(CD_4M_SLICE, device=Xt.device),
                                    y.clone(), lam)
    st = _stats_since(cds, before)
    moved = int(torch.count_nonzero(a_w))
    print(f"[cd-4m] the first {CD_4M_SLICE:,} rows at m={m}, from zero at lam {lam:.6g}: walker "
          f"{'= H bit for bit' if same else '!= H'}, {moved} moved, {st['survivors']} survivors, "
          f"{st['rebases']} re-bases ({time.perf_counter() - t0:.1f} s)")
    check(same and moved > 0, "the dense slice: the walker differs from H, or nothing moved")
    print(f"[cd-4m] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(zip(("cd_walk", "cd_score"), walks))


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


# --------------------------------------------------------------------------
# The distributed backend (repro_torch.distributed): its kernels against their
# plain versions (phase 2), a (1, 1) mesh over NCCL in this process on each
# path ("mesh, world 1") and 4 ranks over gloo on one card ("mesh, 4 ranks")
# --------------------------------------------------------------------------

MESH_TILES = 4  # phase 2 cuts a design's features into 4 tiles, as a (1, 4) mesh
MESH_LANES = 3  # the mesh's batched path: 3 points in lanes of 3
MESH_STEPS = 300  # the timed mesh and single-device steps, and the away points'
MESH_TEL_STEPS = 200  # the steps of each mesh solve with the ring
MESH_KERNELS = ("sampled_scores_owned", "sparse_sampled_scores_owned",
                "sampled_scores_lanes_owned", "sparse_sampled_scores_lanes_owned",
                "owned_column", "owned_column_lanes", "step_tail_given", "step_tail_en_given",
                "step_tail_lanes_given", "step_tail_en_lanes_given", "step_tail_given_tel",
                "step_tail_en_given_tel", "step_tail_lanes_given_tel",
                "step_tail_en_lanes_given_tel", "dir_tail_given", "dir_tail_en_given")
# the 4 ranks' problem: a sparse proxy whose 1,024 blocks of 256 split into
# whole blocks on (1, 4) and (2, 2)
RANKS_P, RANKS_M, RANKS_DENSITY = 262_144, 4_096, 0.002
RANKS_STEPS, RANKS_LOG_STEPS = 200, 50
RANKS_TIMEOUT_S = 300


def _mesh_tiles(torch, design, n=MESH_TILES):
    """``n`` tiles of the design's features (views, a rank's tile each):
    ``(tile, off)``, the block-ELL ones whole blocks."""
    if _is_sparse(design):
        nb = -(-design.nblocks // n)
        return [((design.values[i * nb:(i + 1) * nb], design.rows[i * nb:(i + 1) * nb]),
                 i * nb * design.block_size) for i in range(n)]
    pl = -(-design.shape[0] // n)
    return [(design[i * pl:(i + 1) * pl], i * pl) for i in range(n)]


def _tile_len(tile):
    return tile[0].shape[0] * tile[0].shape[1] if isinstance(tile, tuple) else tile.shape[0]


def _owned(torch, tile, r, blk, bs, off, plain=False):
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg

    if isinstance(tile, tuple):
        fn = sg.sparse_sampled_scores_owned_plain if plain else sg.sparse_sampled_scores_owned
        return fn(tile[0], tile[1], r, blk, bs, off)
    fn = fw.sampled_scores_owned_plain if plain else fw.sampled_scores_owned
    return fn(tile, r, blk, bs, off)


def _owned_case(torch, label, design, tiles, r, blk, bs, p):
    """The tiles' owned scores of one draw: two launches bitwise equal, an
    unowned position +0.0 (sign clear), the sum over the tiles bitwise the
    single-device kernel's scores, each tile within RTOL_SUM of its plain
    version. Returns the largest |kernel - plain|."""
    from repro_torch.kernels import fw_grad as fw

    from repro_torch.kernels import sparse_grad as sg

    idx = fw.block_indices(blk.long(), bs)
    want = (sg.sparse_sampled_scores(design.values, design.rows, r, blk, bs)
            if _is_sparse(design) else fw.sampled_scores(design, r, blk, bs))
    total, err = None, 0.0
    for tile, off in tiles:
        got = _owned(torch, tile, r, blk, bs, off)
        check(_same_bits(torch, got, _owned(torch, tile, r, blk, bs, off)),
              f"owned scores {label}: two launches differ")
        pl = _tile_len(tile)
        foreign = (idx < off) | (idx >= off + pl)
        check(bool((got[foreign] == 0).all()) and not bool(torch.signbit(got[foreign]).any()),
              f"owned scores {label}: an unowned position is not +0.0")
        plain = _owned(torch, tile, r, blk, bs, off, plain=True)
        err = max(err, float((got - plain).abs().max()))
        total = got.clone() if total is None else total + got
    real = idx < p
    check(torch.equal(total[real], want[real]),
          f"owned scores {label}: the tiles' sum differs from the single-device scores")
    check(bool((total[~real] == 0).all()), f"owned scores {label}: a padded id scored")
    return err


def phase2_mesh_kernels(torch, design, y, layout):
    """The distributed backend's instantiations at the path's shapes (the
    design cut into MESH_TILES feature tiles, views): K2's or K5's owned
    scores (a uniform draw at width 1, each tile's edge ids, a draw none of
    tile 0 owns, blocks with ids past p at the block width, bf16 on a part
    of the design) and their lane form (a frozen lane), each bitwise its
    single-device scores once summed over the tiles; ``owned_column`` and
    its lane form bitwise ``dense_columns``; the tails with the column given
    (``step_tail_given`` and its EN, lane and TEL siblings) bitwise the
    single-device tail kernels; the direction tail with its columns given
    bitwise ``dir_tail`` (and its split form with a ``complete`` that adds
    nothing), both within RTOL_SUM of their plain version."""
    from repro_torch.core import FWConfig
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg
    from repro_torch.kernels import step_tail as st
    from repro_torch.kernels.step_tail import TailRecord

    t0 = time.perf_counter()
    dev = y.device
    g = torch.Generator(device=dev)
    g.manual_seed(26)
    sparse = _is_sparse(design)
    p, m = design.shape
    ell = _ell_of(design)
    tiles = _mesh_tiles(torch, design)
    pl = _tile_len(tiles[0][0])
    errs = {k: 0.0 for k in MESH_KERNELS}
    sk = "sparse_sampled_scores_owned" if sparse else "sampled_scores_owned"
    r = torch.randn(m, generator=g, device=dev)
    kappa = kappa_fraction(p, 0.01)
    bs = design.block_size if sparse else 128
    nblocks = -(-p // bs)
    edges = torch.tensor([off + d for _, off in tiles for d in (0, pl - 1) if off + d < p],
                         device=dev)
    draws = {"uniform": (torch.randint(0, p, (kappa,), generator=g, device=dev), 1),
             "edges": (edges, 1),
             "foreign to tile 0": (torch.randint(pl, p, (512,), generator=g, device=dev), 1),
             f"blocks of {bs} with ids past p": (torch.cat([
                 torch.tensor([nblocks - 1, 0], device=dev),
                 torch.randperm(nblocks, generator=g, device=dev)[:6]]), bs)}
    for what, (blk, w) in draws.items():
        errs[sk] = max(errs[sk], _owned_case(torch, f"{layout} {what}", design, tiles, r, blk,
                                             w, p))
    if sparse:
        nbp = min(80, design.nblocks)
        part = dataclasses.replace(design, values=design.values[:nbp].to(torch.bfloat16),
                                   rows=design.rows[:nbp], p=nbp * design.block_size)
    else:
        part = design[:20_000].to(torch.bfloat16)
    pp = part.shape[0]
    errs[sk] = max(errs[sk], _owned_case(
        torch, f"{layout} bf16", part, _mesh_tiles(torch, part), r,
        torch.randint(0, pp, (2048,), generator=g, device=dev), 1, pp))
    print(f"[mesh-kernels] {sk} ({layout}): {len(draws) + 1} draws over {MESH_TILES} tiles of "
          f"{pl:,} features: the tiles' sum bitwise the single-device scores, unowned +0.0, "
          f"two launches equal, max |kernel - plain| {errs[sk]:.3e}")

    lk = "sparse_sampled_scores_lanes_owned" if sparse else "sampled_scores_lanes_owned"
    R = torch.randn(MESH_LANES, m, generator=g, device=dev)
    blkL = torch.randint(0, p, (MESH_LANES, kappa), generator=g, device=dev)
    lanes = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    for tile, off in tiles[:2]:
        if sparse:
            got = sg.sparse_sampled_scores_lanes_owned(tile[0], tile[1], R, blkL, 1, lanes, off)
            plain = sg.sparse_sampled_scores_lanes_owned_plain(tile[0], tile[1], R, blkL, 1,
                                                               lanes, off)
        else:
            got = fw.sampled_scores_lanes_owned(tile, R, blkL, 1, lanes, off)
            plain = fw.sampled_scores_lanes_owned_plain(tile, R, blkL, 1, lanes, off)
        for lane in (0, 2):
            check(_same_bits(torch, got[lane], _owned(torch, tile, R[lane].contiguous(),
                                                       blkL[lane], 1, off)),
                  f"{lk}: lane {lane} differs from its one-lane launch")
            errs[lk] = max(errs[lk], float((got[lane] - plain[lane]).abs().max()))
    print(f"[mesh-kernels] {lk} ({layout}): L={MESH_LANES}, lane 1 frozen, each running lane "
          f"bitwise its one-lane launch; max |kernel - plain| {errs[lk]:.3e}")

    ids = torch.cat([edges[:6], torch.tensor([-1, 7, 7, p - 1], device=dev)])
    want = st.dense_columns(ell, ids.clamp_min(0), m)
    want[ids < 0] = 0
    total = None
    for tile, off in tiles:
        got = st.owned_column_lanes(tile, ids, off, m)
        check(_same_bits(torch, got, st.owned_column_plain(tile, ids, off, m)),
              f"owned_column_lanes ({layout}): differs from its plain version")
        one = st.owned_column(tile, ids[1], off, m)
        check(_same_bits(torch, one, got[1]), f"owned_column ({layout}): != its lane form")
        total = got if total is None else total + got
    check(torch.equal(total, want), f"owned_column ({layout}): the tiles' sum != the columns")
    print(f"[mesh-kernels] owned_column / owned_column_lanes ({layout}): {ids.numel()} ids "
          "(tile edges, -1, a repeat, p - 1), each tile bitwise its plain version, their sum "
          "bitwise the dense columns")

    cfg = FWConfig(delta=5.0)
    designs = [(f"{layout} f32", design, torch.float32)]
    designs.append((f"{layout} bf16", part, torch.bfloat16))
    for label, mat, dtype in designs:
        mell, pm = _ell_of(mat), mat.shape[0]
        for i_star in (0, int(torch.randint(0, pm, (), generator=g, device=dev)), pm - 1):
            z = st.dense_columns(mell, torch.tensor([i_star], device=dev), m)[0]
            col = st.GivenCol(z, sparse)
            for en in (None, st.ENTail(torch.tensor(-6.0, device=dev),
                                       torch.tensor(0.4, device=dev).to(dtype), EN_L2)):
                beta, args = _tail_args(torch, g, pm, m, dtype, i_star)
                if en is None:
                    want = st.step_tail(mell, beta.clone(), *args, cfg)
                    got = st.step_tail_given(col, beta.clone(), *args, cfg)
                    key = "step_tail_given"
                else:
                    want = st.step_tail_en(mell, beta.clone(), *args, cfg, en)
                    got = st.step_tail_en_given(col, beta.clone(), *args, cfg, en)
                    key = "step_tail_en_given"
                plain = st.step_tail_plain(col, beta.clone(), *args, cfg, en)
                check(all(_same_bits(torch, a, b) for a, b in zip(want, got)),
                      f"{key} {label} i*={i_star}: differs from the single-device tail")
                check(all(_same_bits(torch, a, b) for a, b in zip(got, plain)),
                      f"{key} {label} i*={i_star}: differs from its plain version")
        # the TEL instantiations: the ring's record beside the same outputs
        beta, args = _tail_args(torch, g, pm, m, dtype, 3)
        col = st.GivenCol(st.dense_columns(mell, torch.tensor([3], device=dev), m)[0], sparse)
        yty1 = torch.tensor(2.0, device=dev).to(dtype)
        for en in (None, st.ENTail(torch.tensor(-6.0, device=dev),
                                   torch.tensor(0.4, device=dev).to(dtype), EN_L2)):
            rings = [torch.zeros(10 * 8, dtype=torch.int32, device=dev) for _ in range(3)]
            recs = [TailRecord(r, 8, 5, 17, 99, True, yty1) for r in rings]
            if en is None:
                key = "step_tail_given_tel"
                want = st.step_tail(mell, beta.clone(), *args, cfg, recs[0])
                got = st.step_tail_given(col, beta.clone(), *args, cfg, recs[1])
            else:
                key = "step_tail_en_given_tel"
                want = st.step_tail_en(mell, beta.clone(), *args, cfg, en, recs[0])
                got = st.step_tail_en_given(col, beta.clone(), *args, cfg, en, recs[1])
            plain = st.step_tail_plain(col, beta.clone(), *args, cfg, en, recs[2])
            check(all(_same_bits(torch, a, b) for a, b in zip(want, got))
                  and torch.equal(rings[0], rings[1]),
                  f"{key} {label}: differs from the single-device TEL tail")
            check(all(_same_bits(torch, a, b) for a, b in zip(got, plain))
                  and torch.equal(rings[1], rings[2]), f"{key} {label}: differs from its plain "
                  "version")
    print(f"[mesh-kernels] step_tail_given / _en_given / _given_tel / _en_given_tel ({layout}, "
          "f32 at the path's shapes and bf16): bitwise the single-device tail kernels and their "
          "plain versions at i* = 0, a random one and p - 1, the rings too")

    L = MESH_LANES
    beta_l, largs = _lane_tail_state(torch, g, p, m, torch.float32, L)
    i_l = torch.randint(0, p, (L,), generator=g, device=dev)
    largs = largs[:10] + (i_l,) + largs[11:]
    zl = st.GivenCol(st.dense_columns(ell, i_l, m), sparse)
    lanes = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    en_l = st.ENTail(largs[11] + 0.5, torch.full((L,), 40.0, device=dev), EN_L2)
    yty = torch.tensor(2.0, device=dev)
    cursors = [TEL_CAP - 1] + [3 * lane for lane in range(1, L)]
    for en in (None, en_l):
        for tel in (False, True):
            key = "step_tail" + ("_en" if en is not None else "") + "_lanes_given" + (
                "_tel" if tel else "")
            outs = []
            for route in ("single", "given", "plain"):
                rec, ring = None, None
                if tel:
                    (ring,) = _tel_rings(torch, dev, 1, L, cursors)
                    rec = TailRecord(ring.buf, TEL_CAP, 0, 0, 42_723, True, yty, list(cursors),
                                     ring.dev_cursor)
                b = beta_l.clone()
                if route == "plain":
                    o = st.step_tail_lanes_plain(zl, b, *largs, lanes, cfg, en, rec)
                elif en is None:
                    fn = st.step_tail_lanes if route == "single" else st.step_tail_lanes_given
                    o = fn(ell if route == "single" else zl, b, *largs, lanes, cfg, tel=rec)
                else:
                    fn = st.step_tail_en_lanes if route == "single" else st.step_tail_en_lanes_given
                    o = fn(ell if route == "single" else zl, b, *largs, lanes, cfg, en, tel=rec)
                outs.append((o, ring))
            (so, sr), (go, gr), (po, pr) = outs
            check(all(_same_bits(torch, a, b) for a, b in zip(so, go)),
                  f"{key} ({layout}): differs from the single-device lane tail")
            check(all(_same_bits(torch, a, b) for a, b in zip(go, po)),
                  f"{key} ({layout}): differs from its plain version")
            if tel:
                check(torch.equal(sr.buf, gr.buf) and torch.equal(gr.buf, pr.buf)
                      and torch.equal(sr.dev_cursor, gr.dev_cursor)
                      and torch.equal(gr.dev_cursor, pr.dev_cursor),
                      f"{key} ({layout}): the lane rings or cursors differ")
    print(f"[mesh-kernels] step_tail_lanes_given / _en_lanes_given and their _tel forms "
          f"({layout}, L={L}, lane 1 frozen, lane 0 renormalizing and its ring wrapping): "
          "bitwise the single-device lane tails and their plain versions, rings and cursors "
          "too")

    n_dir = 0
    for case in ("away", "pairwise", "drop", "refresh", "empty"):
        beta, kw, en, want_p = dir_tail_case(torch, design, y, case, g)
        zc = st.dense_columns(ell, st.dir_column_ids(kw["i_f"], kw["buf"], p), m)
        want = st.dir_tail(ell, beta.clone(), *_dir_args(kw), _dir_cfg())
        got = st.dir_tail_given(zc, beta.clone(), *_dir_args(kw), _dir_cfg())
        check(all(a is None or _same_bits(torch, a, b) for a, b in zip(want, got)),
              f"dir_tail_given ({layout}, {case}): differs from dir_tail")
        errs["dir_tail_given"] = max(errs["dir_tail_given"],
                                     max(abs(float(a) - float(b)) for a, b in
                                         zip(_dir_floats(got), _dir_floats(want_p))))
        if not kw["refresh"]:
            split = st.dir_tail_given(zc, beta.clone(), *_dir_args(kw), _dir_cfg(),
                                      complete=lambda t: t)
            check(all(a is None or _same_bits(torch, a, b) for a, b in zip(want, split)),
                  f"dir_tail_given ({layout}, {case}): its split form differs")
        n_dir += 1
    print(f"[mesh-kernels] dir_tail_given ({layout}): {n_dir} cases bitwise dir_tail (its split "
          "form too, with nothing to add between its launches); max |kernel - plain| "
          f"{errs['dir_tail_given']:.3e}")
    n_dir = 0
    for case in ("away", "pairwise", "refresh"):
        beta, kw, en, want_p = dir_tail_case(torch, design, y, case, g, en_l2=EN_L2)
        zc = st.dense_columns(ell, st.dir_column_ids(kw["i_f"], kw["buf"], p), m)
        want = st.dir_tail_en(ell, beta.clone(), *_dir_args(kw), _dir_cfg(), en)
        got = st.dir_tail_en_given(zc, beta.clone(), *_dir_args(kw), _dir_cfg(), en)
        check(all(a is None or _same_bits(torch, a, b) for a, b in zip(want, got)),
              f"dir_tail_en_given ({layout}, {case}): differs from dir_tail_en")
        errs["dir_tail_en_given"] = max(errs["dir_tail_en_given"],
                                        max(abs(float(a) - float(b)) for a, b in
                                            zip(_dir_floats(got), _dir_floats(want_p))))
        if not kw["refresh"]:
            split = st.dir_tail_en_given(zc, beta.clone(), *_dir_args(kw), _dir_cfg(), en,
                                         complete=lambda t: t)
            check(all(a is None or _same_bits(torch, a, b) for a, b in zip(want, split)),
                  f"dir_tail_en_given ({layout}, {case}): its split form differs")
        n_dir += 1
    print(f"[mesh-kernels] dir_tail_en_given ({layout}, l2={EN_L2}): {n_dir} cases bitwise "
          "dir_tail_en (its split form too); max |kernel - plain| "
          f"{errs['dir_tail_en_given']:.3e}")
    MESH_SECONDS[f"kernels, {layout}"] = time.perf_counter() - t0
    print(f"[mesh-kernels] ({layout}) {MESH_SECONDS[f'kernels, {layout}']:.1f} s")
    return errs if layout == "dense" else {f"{k}_sparse": v for k, v in errs.items()}


_NCCL = {"up": False}
MESH_SECONDS = {}  # each mesh phase's seconds, summed in main's last lines


def _nccl_world1(torch):
    """NCCL's default group of one rank in this process (a free localhost
    port), made once."""
    import socket

    import torch.distributed as tdist

    if not _NCCL["up"]:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        tdist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                                 rank=0)
        _NCCL["up"] = True
    return tdist


def _points_bits(a, b):
    import numpy as np

    return all(x.iterations == y_.iterations and x.n_dots == y_.n_dots
               and np.array_equal(x.alpha_nnz_idx, y_.alpha_nnz_idx)
               and np.array_equal(x.alpha_nnz_val, y_.alpha_nnz_val)
               and x.objective == y_.objective for x, y_ in zip(a.points, b.points)) \
        and len(a.points) == len(b.points)


def phase3_mesh_world1(torch, design, y, single, layout):
    """The mesh at world size 1 over NCCL, in this process: a (1, 1) mesh of
    the design already on the card (no copy), the grid's first 3 points
    through ``distributed.fw_path`` bit for bit the unfused single-device
    path (``single``, the same per-point seeds), the launches a step checked
    (the owned scores, the argmax, the owned column and the GIVEN tail once
    each, K2/K5 and the tail never); on the sparse path one elastic-net
    point and one away point bit for bit their single-device solves; the
    3 points in lanes of 3 through ``distributed.fw_path_batched`` bit for
    bit the single-device batched path; ``certified_gap`` equal to the
    single device's. Returns the launches and the mesh's timing rows."""
    from repro_torch import distributed as D
    from repro_torch import kernels
    from repro_torch.core import LASSO, ENOracle, engine, path
    from repro_torch.core.path import point_seed
    from repro_torch.core.vertex import LaneSampler, TorchSampler
    from repro_torch.obs import TelemetrySpec

    t0 = time.perf_counter()
    tdist = _nccl_world1(torch)
    mesh = D.fw_mesh(1, 1)
    sparse = _is_sparse(design)
    shard = D.shard_sparse if sparse else D.shard_dense
    op = shard(design, y, mesh, device=y.device)
    check((op.values if sparse else op.Xt).data_ptr()
          == (design.values if sparse else design).data_ptr(), "the (1, 1) mesh copied the design")
    cfg, deltas = single["cfg"], single["deltas"][:N_COMPARE]
    sk = "sparse_sampled_scores" if sparse else "sampled_scores"
    launches = {}
    kernels.reset_launch_counts()
    res = D.fw_path(op, deltas, cfg, seed=0, report_gap=False)
    got = kernels.launch_counts()
    ref = single["res"]._replace(points=single["res"].points[:N_COMPARE])
    _print_points(f"mesh-{layout}", res, cfg)
    check(_points_bits(res, ref), f"mesh (1, 1) {layout}: the first {N_COMPARE} points differ "
          "from the unfused single-device path")
    it = res.total_iters
    for name in (f"{sk}_owned", "vertex_argmax", "owned_column", "step_tail_given"):
        check(got[name] == it, f"mesh {layout}: {name} launches {got[name]} != iterations {it}")
    check(got[sk] == 0 == got["step_tail"], f"mesh {layout}: a single-device kernel launched")
    check(got["sparse_colstats" if sparse else "colstats"] == N_COMPARE,
          f"mesh {layout}: the setup pass's launches != points")
    for name in (f"{sk}_owned", "owned_column", "step_tail_given"):
        launches[name] = got[name]
    print(f"[mesh-{layout}] (1, 1) NCCL mesh: the first {N_COMPARE} points ({it} steps) bit for "
          f"bit the unfused single-device path; launches {_nonzero(got)}")

    if sparse:
        d = float(deltas[0])
        en = ENOracle(EN_L2)
        kernels.reset_launch_counts()
        a = D.solve(en, op, cfg, TorchSampler(point_seed(0, 0), y.device), None, d)
        got = kernels.launch_counts()
        b = engine.solve(en, design, y, cfg, TorchSampler(point_seed(0, 0), y.device), None, d,
                         device=y.device)
        check(torch.equal(a.alpha, b.alpha) and a.iterations == b.iterations,
              "mesh EN point differs from the single-device point")
        check(got["step_tail_en_given"] == a.iterations == got["vertex_argmax_shifted"],
              "mesh EN point: launches")
        launches["step_tail_en_given"] = got["step_tail_en_given"]
        print(f"[mesh-{layout}] elastic-net point (l2={EN_L2}, delta={d:.6g}): {a.iterations} "
              f"steps, objective {float(a.objective)!r}, bit for bit the single-device point")
        acfg = dataclasses.replace(cfg, step_rule="away", max_iters=MESH_STEPS, tol=0.0,
                                   patience=10**9)
        d = float(deltas[-1])
        kernels.reset_launch_counts()
        a = D.solve(LASSO, op, acfg, TorchSampler(point_seed(0, 2), y.device), None, d)
        got = kernels.launch_counts()
        b = engine.solve(LASSO, design, y, acfg, TorchSampler(point_seed(0, 2), y.device), None,
                         d, device=y.device)
        check(torch.equal(a.alpha, b.alpha), "mesh away point differs from the single device")
        check(got["dir_tail_given"] == MESH_STEPS == got["owned_column_lanes"],
              "mesh away point: launches")
        launches["dir_tail_given"] = got["dir_tail_given"]
        print(f"[mesh-{layout}] away point ({MESH_STEPS} steps, delta={d:.6g}): objective "
              f"{float(a.objective)!r}, bit for bit the single-device point; the direction "
              "tail with its columns given once a step")
        kernels.reset_launch_counts()
        a = D.solve(en, op, acfg, TorchSampler(point_seed(0, 2), y.device), None, d)
        got = kernels.launch_counts()
        b = engine.solve(en, design, y, acfg, TorchSampler(point_seed(0, 2), y.device), None, d,
                         device=y.device)
        check(torch.equal(a.alpha, b.alpha), "mesh EN away point differs from the single device")
        check(got["dir_tail_en_given"] == MESH_STEPS, "mesh EN away point: launches")
        launches["dir_tail_en_given"] = got["dir_tail_en_given"]
        print(f"[mesh-{layout}] elastic-net away point ({MESH_STEPS} steps): objective "
              f"{float(a.objective)!r}, bit for bit the single-device point")

        kernels.reset_launch_counts()
        bat = D.fw_path_batched(op, deltas, cfg, seed=0, lane_width=MESH_LANES, oracle=en,
                                report_gap=False)
        got = kernels.launch_counts()
        one = path.fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=MESH_LANES,
                                   oracle=en, device=y.device)
        check(_points_bits(bat, one), f"mesh {layout}: the EN batched chunk differs from the "
              "single device's")
        check(got["step_tail_en_lanes_given"] == got["vertex_argmax_shifted_lanes"] > 0,
              "mesh EN batched chunk: launches")
        launches["step_tail_en_lanes_given"] = got["step_tail_en_lanes_given"]
        print(f"[mesh-{layout}] elastic-net fw_path_batched, {N_COMPARE} points in lanes of "
              f"{MESH_LANES}: {got['step_tail_en_lanes_given']} batched steps bit for bit the "
              "single-device batched path")

        # the ring on the mesh: the TEL forms of the GIVEN tails (a solve and
        # a batched solve of each oracle), rings and all bit for bit the
        # single device's
        tcfg = dataclasses.replace(cfg, max_iters=MESH_TEL_STEPS, tol=0.0, patience=10**9,
                                   telemetry=TelemetrySpec(capacity=TEL_CAP))
        d = float(deltas[0])
        kernels.reset_launch_counts()
        for orc in (LASSO, en):
            a = D.solve(orc, op, tcfg, TorchSampler(7, y.device), None, d)
            b = engine.solve(orc, design, y, tcfg, TorchSampler(7, y.device), None, d,
                             device=y.device)
            check(torch.equal(a.alpha, b.alpha) and torch.equal(a.telemetry.buf,
                                                                 b.telemetry.buf),
                  f"mesh {layout}: a solve with the ring differs from the single device's")
            a, _ = D.solve_batched(orc, op, tcfg, LaneSampler(8, MESH_LANES, y.device), None,
                                   deltas)
            b, _ = engine.solve_batched(orc, design, y, tcfg, LaneSampler(8, MESH_LANES,
                                                                         y.device), None,
                                        deltas, device=y.device)
            check(torch.equal(a.alpha, b.alpha) and torch.equal(a.telemetry.buf,
                                                                 b.telemetry.buf),
                  f"mesh {layout}: a batched solve with the rings differs from the single "
                  "device's")
        got = kernels.launch_counts()
        for name in ("step_tail_given_tel", "step_tail_en_given_tel", "step_tail_lanes_given_tel",
                     "step_tail_en_lanes_given_tel"):
            check(got[name] > 0, f"mesh {layout}: {name} never launched")
            launches[name] = got[name]
        print(f"[mesh-{layout}] the ring on the mesh ({MESH_TEL_STEPS} steps, the lasso and the "
              f"elastic-net, one lane and {MESH_LANES}): bit for bit the single device's, rings "
              f"too; TEL launches { {k: v for k, v in got.items() if k.endswith('given_tel')} }")

    kernels.reset_launch_counts()
    bat = D.fw_path_batched(op, deltas, cfg, seed=0, lane_width=MESH_LANES, report_gap=False)
    got = kernels.launch_counts()
    kernels.reset_launch_counts()
    one = path.fw_path_batched(design, y, deltas, cfg, seed=0, lane_width=MESH_LANES,
                               device=y.device)
    base = kernels.launch_counts()
    check(_points_bits(bat, one), f"mesh {layout}: the batched chunk differs from the single "
          "device's")
    steps = base[f"{sk}_lanes"]
    for name in (f"{sk}_lanes_owned", "owned_column_lanes", "step_tail_lanes_given"):
        check(got[name] == steps, f"mesh {layout}: {name} launches {got[name]} != {steps}")
        launches[name] = got[name]
    print(f"[mesh-{layout}] fw_path_batched, {N_COMPARE} points in lanes of {MESH_LANES}: "
          f"{steps} batched steps bit for bit the single-device batched path")

    pt = res.points[-1]
    alpha = _alpha_from_point(torch, pt, design.shape[0], y.device)
    g_mesh = float(D.certified_gap(LASSO, op, alpha, pt.reg, cfg))
    g_one = float(LASSO.gap(design, y, alpha, torch.tensor(pt.reg, device=y.device), cfg))
    check(g_mesh == g_one, f"mesh certified gap {g_mesh!r} != single device {g_one!r}")
    print(f"[mesh-{layout}] certified_gap at point {N_COMPARE - 1}: {g_mesh!r}, equal to the "
          "single device's")

    timing = _mesh_timing(torch, tdist, D, op, design, y, cfg, float(deltas[-1]), layout)
    MESH_SECONDS[f"world 1, {layout}"] = time.perf_counter() - t0
    print(f"[mesh-{layout}] phase took {MESH_SECONDS[f'world 1, {layout}']:.1f} s")
    return launches, timing


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _mesh_timing(torch, tdist, D, op, design, y, cfg, delta, layout):
    """A mesh step against the unfused single-device step (wall per step over
    MESH_STEPS fixed steps, alternated), each collective of the step alone
    (NCCL at world size 1), and the mesh kernels' times beside their bounds,
    plain versions and library calls."""
    from repro_torch.core import LASSO, engine
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_grad as sg
    from repro_torch.kernels import step_tail as st
    from repro_torch.kernels.step_tail import TailRecord

    dev = y.device
    p, m = design.shape
    sparse = _is_sparse(design)
    scfg = dataclasses.replace(cfg, max_iters=MESH_STEPS, tol=0.0, patience=10**9)
    walls = {"single": [], "mesh": []}
    for tag in ("single", "mesh", "mesh", "single"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tag == "mesh":
            r = D.solve(LASSO, op, scfg, TorchSampler(5, dev), None, delta)
        else:
            r = engine.solve(LASSO, design, y, scfg, TorchSampler(5, dev), None, delta,
                             device=dev)
        float(r.objective)
        torch.cuda.synchronize()
        walls[tag].append(1e3 * (time.perf_counter() - t1) / MESH_STEPS)
    print(f"[timing] mesh-{layout} step (1, 1) NCCL vs the unfused single-device step, "
          f"{MESH_STEPS} steps a solve, alternated (ms/step, setup included): single "
          f"{walls['single']}, mesh {walls['mesh']}")
    kappa = kappa_fraction(p, 0.01)
    mesh = op.mesh
    for name, axis, n in (("score all_reduce (world)", "world", kappa),
                          ("column all_reduce (model)", "model", m),
                          ("refresh pair all_reduce (data)", "data", 2)):
        buf = torch.randn(n, device=dev)
        group, _ = mesh.axis(axis)
        # NCCL at world size 1 moves no byte: the cost is the call's, on the
        # host, so the host's clock over calls back to back, then a sync;
        # the port's all_reduce skips an axis of one rank
        ms = {}
        for who, call in (("nccl", lambda: tdist.all_reduce(buf, group=group)),
                          ("port", lambda: D.backend.all_reduce(buf, mesh, axis))):
            reps = 200
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            ms[who] = 1e3 * (time.perf_counter() - t1) / reps
        dev_ms = _time_queued(torch, lambda i: tdist.all_reduce(buf, group=group), 50)
        print(f"[timing] mesh-{layout} {name}, {n} f32: NCCL's all_reduce {ms['nccl']:.6f} ms a "
              f"call on the host's clock ({dev_ms:.6f} ms of the stream's time queued); the "
              f"port's backend.all_reduce on this axis of one rank {ms['port']:.6f} ms")

    out = {}

    def row(name, ms, plain_ms, library_ms, nbytes, flops, note=""):
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        lib = "null" if library_ms is None else f"{library_ms:.6f} ms"
        print(f"[timing] {name}: {ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.6f} ms, "
              f"library {lib}{note}")

    g = torch.Generator(device=dev)
    g.manual_seed(27)
    idxs = [torch.randint(0, p, (kappa,), generator=g, device=dev) for _ in range(32)]
    r = y.clone()
    tile, off = op.tile, op.off
    L = MESH_LANES
    R = torch.randn(L, m, generator=g, device=dev)
    lanes = torch.arange(L, dtype=torch.int32, device=dev)
    blkL = [torch.randint(0, p, (L, kappa), generator=g, device=dev) for _ in range(8)]
    if sparse:
        vals, rows = tile.values, tile.rows
        nnz = vals.shape[-1]
        slots = vals.view(-1, nnz)
        nz = sum(int(torch.count_nonzero(slots[f])) for f in idxs) / len(idxs)
        row("sparse_sampled_scores_owned",
            _time_queued(torch, lambda i: sg.sparse_sampled_scores_owned(
                vals, rows, r, idxs[i % 32], 1, off), 200),
            _time_queued(torch, lambda i: sg.sparse_sampled_scores_owned_plain(
                vals, rows, r, idxs[i % 32], 1, off), 50),
            None, kappa * nnz * 4 + nz * 4 + kappa * 4 + kappa * 8 + m * 4, 2 * nz,
            note=f" [the (1, 1) tile, width 1, kappa={kappa}; library: none]")
        row("sparse_sampled_scores_lanes_owned",
            _time_queued(torch, lambda i: sg.sparse_sampled_scores_lanes_owned(
                vals, rows, R, blkL[i % 8], 1, lanes, off), 100),
            _time_queued(torch, lambda i: sg.sparse_sampled_scores_lanes_owned_plain(
                vals, rows, R, blkL[i % 8], 1, lanes, off), 10),
            None, L * (kappa * nnz * 4 + nz * 4 + kappa * 12 + m * 4), 2 * L * nz,
            note=f" [L={L}; library: none]")
        mat = (vals, rows)
        col_bytes = nnz * 8 + m * 4
        lib_col = None
    else:
        row("sampled_scores_owned",
            _time_queued(torch, lambda i: fw.sampled_scores_owned(tile, r, idxs[i % 32], 1, off),
                         200),
            _time_queued(torch, lambda i: fw.sampled_scores_owned_plain(tile, r, idxs[i % 32], 1,
                                                                        off), 50),
            _time_queued(torch, lambda i: torch.mv(tile.index_select(0, idxs[i % 32]), r), 50),
            kappa * m * 4 + m * 4 + kappa * 8 + kappa * 4, 2 * kappa * m,
            note=f" [the (1, 1) tile, kappa={kappa}, m={m}; library: torch.mv on index_select]")
        row("sampled_scores_lanes_owned",
            _time_queued(torch, lambda i: fw.sampled_scores_lanes_owned(
                tile, R, blkL[i % 8], 1, lanes, off), 100),
            _time_queued(torch, lambda i: fw.sampled_scores_lanes_owned_plain(
                tile, R, blkL[i % 8], 1, lanes, off), 10),
            None, L * (kappa * m * 4 + m * 4 + kappa * 12), 2 * L * kappa * m,
            note=f" [L={L}; library: none]")
        mat = tile
        col_bytes = 2 * m * 4
        lib_col = lambda ids: tile.index_select(0, ids)  # noqa: E731
    ids1 = [i[:1] for i in idxs]
    idsL = [i[:L] for i in idxs]
    row("owned_column",
        _time_queued(torch, lambda i: st.owned_column(mat, ids1[i % 32][0], off, m), 400),
        _time_queued(torch, lambda i: st.owned_column_plain(mat, ids1[i % 32], off, m), 50),
        None if lib_col is None else _time_queued(torch, lambda i: lib_col(ids1[i % 32]), 400),
        col_bytes + 8, 0, note=" [library: index_select of the row (dense); none sparse]")
    row("owned_column_lanes",
        _time_queued(torch, lambda i: st.owned_column_lanes(mat, idsL[i % 32], off, m), 400),
        _time_queued(torch, lambda i: st.owned_column_plain(mat, idsL[i % 32], off, m), 50),
        None if lib_col is None else _time_queued(torch, lambda i: lib_col(idsL[i % 32]), 400),
        L * (col_bytes + 8), 0, note=f" [{L} ids]")
    from repro_torch.core import FWConfig

    tcfg = FWConfig(delta=5.0)
    i_t = int(idxs[0][0])
    beta_t, targs = _tail_args(torch, g, p, m, torch.float32, i_t)
    col = st.GivenCol(st.owned_column(mat, targs[9], off, m), sparse)
    row("step_tail_given",
        _time_queued(torch, lambda i: st.step_tail_given(col, beta_t, *targs, tcfg), 400),
        _time_queued(torch, lambda i: st.step_tail_plain(col, beta_t, *targs, tcfg), 10),
        None, 4 * m * 4 + 64, 5 * m, note=f" [m={m}, the column given; library: none]")
    en = st.ENTail(torch.tensor(-6.0, device=dev), torch.tensor(0.4, device=dev), EN_L2)
    row("step_tail_en_given",
        _time_queued(torch, lambda i: st.step_tail_en_given(col, beta_t, *targs, tcfg, en), 400),
        _time_queued(torch, lambda i: st.step_tail_plain(col, beta_t, *targs, tcfg, en), 10),
        None, 4 * m * 4 + 72, 5 * m + 20, note=" [library: none]")
    beta_l, largs = _lane_tail_state(torch, g, p, m, torch.float32, L)
    largs = (torch.full((L,), 0.9, device=dev),) + largs[1:]  # no lane renormalizes
    zl = st.GivenCol(st.owned_column_lanes(mat, largs[10], off, m), sparse)
    row("step_tail_lanes_given",
        _time_queued(torch, lambda i: st.step_tail_lanes_given(zl, beta_l, *largs, lanes, tcfg),
                     400),
        _time_queued(torch, lambda i: st.step_tail_lanes_plain(zl, beta_l, *largs, lanes, tcfg),
                     4),
        None, L * (4 * m * 4 + 64), L * 5 * m, note=f" [L={L}; library: none]")
    en_l = st.ENTail(largs[11] + 0.5, torch.full((L,), 40.0, device=dev), EN_L2)
    row("step_tail_en_lanes_given",
        _time_queued(torch, lambda i: st.step_tail_en_lanes_given(zl, beta_l, *largs, lanes, tcfg,
                                                                  en_l), 400),
        _time_queued(torch, lambda i: st.step_tail_lanes_plain(zl, beta_l, *largs, lanes, tcfg,
                                                               en_l), 4),
        None, L * (4 * m * 4 + 72), L * 5 * m, note=f" [L={L}; library: none]")
    # the TEL forms: the same launches writing a ring record (a lane's each)
    yty = torch.tensor(2.0, device=dev)
    (ring,) = _tel_rings(torch, dev, 1)
    rec = TailRecord(ring.buf, TEL_CAP, 7, 7, 1000, True, yty)
    row("step_tail_given_tel",
        _time_queued(torch, lambda i: st.step_tail_given(col, beta_t, *targs, tcfg, rec), 400),
        _time_queued(torch, lambda i: st.step_tail_plain(col, beta_t, *targs, tcfg, None, rec),
                     8),
        None, 4 * m * 4 + 64 + TEL_RECORD_BYTES, 5 * m + 16,
        note=f" [a {TEL_RECORD_BYTES}-byte record; library: none]")
    row("step_tail_en_given_tel",
        _time_queued(torch, lambda i: st.step_tail_en_given(col, beta_t, *targs, tcfg, en, rec),
                     400),
        _time_queued(torch, lambda i: st.step_tail_plain(col, beta_t, *targs, tcfg, en, rec), 8),
        None, 4 * m * 4 + 72 + TEL_RECORD_BYTES, 5 * m + 24, note=" [library: none]")
    (lring,) = _tel_rings(torch, dev, 1, L)
    lrec = TailRecord(lring.buf, TEL_CAP, 0, 0, 1000, True, yty, [0] * L, lring.dev_cursor)
    row("step_tail_lanes_given_tel",
        _time_queued(torch, lambda i: st.step_tail_lanes_given(zl, beta_l, *largs, lanes, tcfg,
                                                               lrec), 400),
        _time_queued(torch, lambda i: st.step_tail_lanes_plain(
            zl, beta_l, *largs, lanes, tcfg, None, lrec._replace(cursors=[0] * L)), 4),
        None, L * (4 * m * 4 + 64 + TEL_RECORD_BYTES), L * 5 * m, note=f" [L={L}]")
    row("step_tail_en_lanes_given_tel",
        _time_queued(torch, lambda i: st.step_tail_en_lanes_given(zl, beta_l, *largs, lanes, tcfg,
                                                                  en_l, lrec), 400),
        _time_queued(torch, lambda i: st.step_tail_lanes_plain(
            zl, beta_l, *largs, lanes, tcfg, en_l, lrec._replace(cursors=[0] * L)), 4),
        None, L * (4 * m * 4 + 72 + TEL_RECORD_BYTES), L * 5 * m, note=f" [L={L}]")
    if sparse:
        ell = _ell_of(design)
        for key, l2 in (("dir_tail_given", None), ("dir_tail_en_given", EN_L2)):
            beta, kw, den, _ = dir_tail_case(torch, design, y, "away", g, en_l2=l2)
            zc = st.dense_columns(mat, st.dir_column_ids(kw["i_f"], kw["buf"], p), m)
            n_buf = kw["buf"].numel()
            extra = () if den is None else (den,)
            given = st.dir_tail_given if den is None else st.dir_tail_en_given
            single = st.dir_tail if den is None else st.dir_tail_en
            # each form on its own copy of the state, in turns: a call moves
            # beta in place, so the copies walk the same states
            b_given, b_single = beta.clone(), beta.clone()
            ms = {"given": [], "single": []}
            for who in ("single", "given", "given", "single"):
                if who == "given":
                    ms[who].append(_time_queued(torch, lambda i: given(
                        zc, b_given, *_dir_args(kw), _dir_cfg(), *extra), 200))
                else:
                    ms[who].append(_time_queued(torch, lambda i: single(
                        ell, b_single, *_dir_args(kw), _dir_cfg(), *extra), 200))
            last = given(zc, b_given.clone(), *_dir_args(kw), _dir_cfg(), *extra)
            row(key, min(ms["given"]),
                _time_queued(torch, lambda i: st.dir_tail_given_plain(
                    zc, beta, *_dir_args(kw), _dir_cfg(), den), 5),
                None, 5 * m * 4 + n_buf * 20 + 64 + (8 if den is not None else 0),
                12 * m + (24 if den is not None else 0),
                note=f" [m={m}, {n_buf} slots{'' if l2 is None else f', l2={l2}'}; bytes: R, y, "
                     "z_f, z_a, the new R, the buffer; library: none; in turns with the "
                     f"single-device {single.__name__} on a copy of the same state: given "
                     f"{[round(t, 6) for t in ms['given']]}, single "
                     f"{[round(t, 6) for t in ms['single']]} ms; the state after the calls: "
                     f"scale {float(last.scale)!r}, renormalized {float(last.scale) == 1.0}]")
    return out


# --------------------------------------------------------------------------
# LM serving (repro_torch.models, configs, training, launch.serve): no
# kernel of its own, cuBLAS and torch's ops on the card
# --------------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_EXTRA, SERVE_DECODE = 4, 128, 3, 16
SERVE_TIMED_PREFILLS, SERVE_PROFILED_STEPS = 3, 4
# architecture -> the layers it runs on the card (None: its full config);
# the widths are always the config's own
SERVE_DEPTH = {
    "deepseek_7b": None, "mamba2_130m": None, "hymba_1_5b": None, "seamless_m4t_medium": None,
    "gemma2_9b": 2, "internlm2_20b": 2, "qwen2_72b": 2, "internvl2_76b": 2,
    "kimi_k2_1t_a32b": 2,  # its dense first layer + 1 MoE layer
    "arctic_480b": 1,
}
# the dtypes each architecture runs in: bf16 (its config's) for the
# timing, the determinism check and the incremental check at
# SERVE_BF16_ATOL; f32 for the incremental check at the reference's
# tolerance. In bf16 the gap is rounding amplified: a decode step's GEMMs
# (M = 4 rows) and the forward's (M = 524) take other cuBLAS kernels, so
# other summation orders and other bf16 roundings, which these
# random-weight stacks amplify over their depth (deepseek-7b on an H100:
# an f32 gap of 9.4e-4, a bf16 gap of 1.0 on logits of 11.4), past the
# reference's rtol 2e-2 / atol 2e-3
SERVE_DTYPES = ("bfloat16", "float32")
# the bf16 checks' limits, each architecture's own: max |diff| over max(1,
# max |logit|) (an atol in units of the logits' scale), the incremental decode
# against the forward at full widths and the card against the CPU at the
# reduced configs. The runs are deterministic, and the gaps grow with
# depth, so each limit lies between that architecture's own sound gap and
# its gap with RoPE's table planted in bf16 as read on an H100 (their
# geometric mean, two digits; PERF.md §6). mamba2 has no attention: 2x
# its sound gap against the forward; against the CPU, where its sound gap
# read 0, 0.003
SERVE_BF16_ATOL = {
    "deepseek_7b": 0.24, "mamba2_130m": 0.065, "internlm2_20b": 0.034, "gemma2_9b": 0.014,
    "qwen2_72b": 0.026, "internvl2_76b": 0.048, "arctic_480b": 0.032, "kimi_k2_1t_a32b": 0.041,
    "hymba_1_5b": 0.099, "seamless_m4t_medium": 0.13,
}
SERVE_CPU_BF16_ATOL = {
    "deepseek_7b": 0.018, "mamba2_130m": 0.003, "internlm2_20b": 0.017, "gemma2_9b": 0.0096,
    "qwen2_72b": 0.017, "internvl2_76b": 0.016, "arctic_480b": 0.04, "kimi_k2_1t_a32b": 0.025,
    "hymba_1_5b": 0.013, "seamless_m4t_medium": 0.043,
}
# bf16-only faults planted in the port (``_planted``) to show what the bf16
# checks catch: the decode steps only against the forward, the card's run
# only against the CPU. A fault that SERVE_FAULTS_CAUGHT names must read
# past the limit wherever its code runs; the others, about one bf16
# rounding each, are printed (the limits catch them in some runs only)
SERVE_FAULTS = {
    "rope_table_bf16": "RoPE's frequencies rounded to bf16 (the table kept in the activation dtype)",
    "probs_f32": "the attention's probabilities left in f32 (not cast to the activation dtype)",
    "norm_bf16": "RMSNorm's statistics taken in bf16",
    "ssm_state_bf16": "the SSM's recurrent state rounded to bf16 at each decode step",
}
SERVE_FAULTS_CAUGHT = ("rope_table_bf16",)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense, tensor cores
SERVE_SECONDS = {}


def _serve_cfg(arch, dtype=None):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if SERVE_DEPTH[arch] is not None:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _clone_cache(cache):
    return {k: v.clone() for k, v in cache.items()}


def _forward_drops(torch, model, cfg, batch):
    """``forward`` with each MoE layer's routing recorded: (logits, a (B, S)
    bool of the tokens with an assignment past capacity in some layer).
    The record swaps ``moe_lib.apply_moe`` for a wrapper, which takes
    effect only because ``model._ffn`` calls it through the module
    (``moe_lib.apply_moe``); every MoE layer must have been recorded."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib

    if not cfg.n_experts:
        return M.forward(model, batch, cfg), None
    n_moe = sum(b.moe is not None for blocks, _ in model.stacks() for b in blocks)
    dropped = []
    apply_moe = moe_lib.apply_moe

    def recording(params, x, cfg_):
        _, idx, _ = moe_lib._route(params, x, cfg_)
        past = moe_lib._positions(idx, cfg_.n_experts) >= moe_lib._capacity(x.shape[1], cfg_)
        dropped.append(past.any(-1))
        return apply_moe(params, x, cfg_)

    moe_lib.apply_moe = recording
    try:
        full = M.forward(model, batch, cfg)
    finally:
        moe_lib.apply_moe = apply_moe
    check(len(dropped) == n_moe, f"{cfg.name}: {len(dropped)} MoE layers recorded of {n_moe} "
          "(forward no longer calls moe_lib.apply_moe through the module?)")
    return full, torch.stack(dropped).any(0)


@contextlib.contextmanager
def _planted(torch, fault, calls):
    """Plant ``fault`` (a SERVE_FAULTS key; None plants nothing) in the port
    for the ``with`` body, by swapping a module attribute for a faulty
    version of it; ``calls[0]`` counts the faulty version's calls (0: the
    fault's code did not run)."""
    from repro_torch.models import attention, layers, ssm
    from repro_torch.models import model as M

    if fault is None:
        yield
        return
    if fault == "rope_table_bf16":
        mod, name = layers, "_rope_frequencies_on"
        orig = mod._rope_frequencies_on

        def faulty(hd, theta, dev):
            return orig(hd, theta, dev).to(torch.bfloat16).float()
    elif fault == "probs_f32":
        mod, name = attention, "_sdpa"
        orig = mod._sdpa

        def faulty(q, k, v, mask, cfg, decode=False):
            return orig(q.float(), k.float(), v.float(), mask, cfg, decode=decode).to(q.dtype)
    elif fault == "norm_bf16":
        mod, name = M, "rmsnorm"
        orig = mod.rmsnorm

        def faulty(params, x, eps):
            return (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
                    * (1.0 + params.scale)).to(x.dtype)
    elif fault == "ssm_state_bf16":
        mod, name = ssm, "decode_ssm"
        orig = mod.decode_ssm

        def faulty(params, x, cache, cfg):
            out, c = orig(params, x, cache, cfg)
            return out, ssm.SSMCache(conv=c.conv, state=c.state.to(torch.bfloat16).float())
    else:
        raise KeyError(fault)

    def counted(*args, **kw):
        calls[0] += 1
        return faulty(*args, **kw)

    setattr(mod, name, counted)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _gaps(torch, pairs, scale):
    """(got, want) logits pairs: the worst ratio of |diff| to rtol 2e-2 +
    atol 2e-3, max |diff|, that over max(1, ``scale``), all finite."""
    ratio = max(float(((a - b).abs() / (2e-3 + 2e-2 * b.abs())).max()) for a, b in pairs)
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
    return dict(ratio=ratio, diff=diff, gap=diff / max(1.0, scale), finite=finite)


def _incremental_vs_full(torch, model, cfg, batch, nxt, max_seq, faults=()):
    """Prefill SERVE_PROMPT tokens, decode SERVE_EXTRA more; each position's
    logits against ``forward`` over all of them (``_gaps``: the reference's
    own tolerance for this check, ``tests/test_serve.py``: rtol 2e-2, atol
    2e-3, and the gap in units of the logits' scale). With MoE layers a
    decoded token that ``forward`` routed past capacity (a drop, which a
    one-token decode never makes) and the row's later tokens are left out,
    and counted; the prompt's own capacity must be the forward's, so the
    prefill's drops are the forward's. Each of ``faults`` is planted in the
    decode steps of a run of its own from the same prefill. Returns
    (prefill logits, the prefill's cache, max |logit|, rows left out, and
    ``_gaps`` a run, keyed by its fault, None the sound run; a planted run
    whose fault's code did not run is left out)."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib

    P = SERVE_PROMPT
    full, dropped = _forward_drops(
        torch, model, cfg, dict(batch, tokens=torch.cat([batch["tokens"], nxt], 1)))
    keep = torch.ones((SERVE_BATCH, SERVE_EXTRA), dtype=torch.bool, device=full.device)
    if dropped is not None:
        S0 = cfg.n_prefix_embeds + P
        check(moe_lib._capacity(S0, cfg) == moe_lib._capacity(S0 + SERVE_EXTRA, cfg),
              f"{cfg.name}: the prompt's capacity differs from the forward's")
        keep = torch.cumsum(dropped[:, S0:S0 + SERVE_EXTRA].int(), 1) == 0
    logits, cache = M.prefill(model, batch, cfg, max_seq=max_seq)
    base = _clone_cache(cache)
    scale = float(full.abs().max())
    gaps = {}
    for fault in (None, *faults):
        c = cache if fault is None else _clone_cache(base)
        pairs, calls = [(logits[:, 0], full[:, P - 1])], [0]
        with _planted(torch, fault, calls):
            for t in range(SERVE_EXTRA):
                lg, c = M.decode_step(model, nxt[:, t:t + 1], c, cfg)
                pairs.append((lg[:, 0][keep[:, t]], full[:, P + t][keep[:, t]]))
        if fault is None or calls[0]:
            gaps[fault] = _gaps(torch, [(a, b) for a, b in pairs if a.numel()], scale)
        del c, pairs
    del full, cache
    return logits, base, scale, int((~keep).sum()), gaps


def _two_decodes(torch, model, cfg, logits, cache, timed=False):
    """Two greedy decodes of SERVE_DECODE tokens from one prefill (the cache
    cloned): (tokens, logits) of each and, timed, each step's seconds."""
    from repro_torch.training import make_serve_step

    serve = make_serve_step(cfg)
    runs, secs = [], []
    for _ in range(2):
        c = _clone_cache(cache)
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        toks, lgs = [], []
        for _ in range(SERVE_DECODE):
            t0 = time.perf_counter()
            tok, lg, c = serve(model, tok, c)
            if timed:
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            toks.append(tok)
            lgs.append(lg)
        runs.append((torch.cat(toks, 1), torch.cat(lgs, 1)))
        del c
    return runs, secs


def _param_bytes(model, skip=()):
    return sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if not n.startswith(skip))


def _serve_bounds(torch, model, cfg, cache_len):
    """(decode bound ms, its bytes; prefill bound ms, its bytes, its FLOPs):
    a decode step reads every weight once but the embedding table (B rows
    of it), and the K/V of the cache's valid prefix; the prefill does
    2 FLOPs a weight a token (the head at the last position only) and the
    attention's two score-square products, and reads every weight once."""
    B, P = SERVE_BATCH, SERVE_PROMPT
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    emb = model.embed.tok
    head = emb if cfg.tie_embeddings else model.lm_head.w
    kv_bytes = 2 * L * B * cache_len * cfg.n_kv_heads * hd * emb.element_size()
    dec_bytes = (_param_bytes(model, ("embed.",)) + B * cfg.d_model * emb.element_size()
                 + (head.numel() * head.element_size() if cfg.tie_embeddings else 0)
                 + kv_bytes)
    body = sum(p.numel() for n, p in model.named_parameters()
               if not n.startswith(("embed.", "lm_head.")))
    flops = (2 * B * P * body + 2 * B * head.numel()
             + L * 2 * 2 * B * cfg.n_heads * P * P * hd)
    pre_bytes = _param_bytes(model)
    return (dec_bytes / HBM_BYTES_PER_S * 1e3, dec_bytes,
            max(pre_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3, pre_bytes, flops)


def _decode_profile(torch, model, cfg, logits, cache):
    """Device busy share and launches a decode step (``torch.profiler`` over
    SERVE_PROFILED_STEPS steps after one warm step); None where the
    profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training import make_serve_step

    serve = make_serve_step(cfg)
    c = _clone_cache(cache)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    tok, _, c = serve(model, tok, c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILED_STEPS):
            tok, _, c = serve(model, tok, c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us <= 0:
        return None
    n = SERVE_PROFILED_STEPS
    top = ", ".join(f"{e.key[:48]} {e.self_device_time_total / n / 1e3:.4f} ms"
                    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6])
    return dict(busy_ms=busy_us / 1e3 / n, wall_ms=wall * 1e3 / n,
                launches=sum(e.count for e in rows) / n, top=top)


def phase_serve(torch):
    """The LM serving path at full widths on the card (SERVE_DEPTH): each
    architecture in bf16 (finite logits, two decodes of SERVE_DECODE tokens
    bit for bit equal, incremental decoding against ``forward`` within
    SERVE_BF16_ATOL[arch] of the logits' scale, and past it under each planted
    fault of SERVE_FAULTS_CAUGHT whose code runs) and in f32 (incremental
    decoding against ``forward`` at rtol 2e-2, atol 2e-3, and the two
    decodes); deepseek-7b at its full config in bf16 also timed
    (prefill, decode steps, the profiler's busy share and launches a step,
    the head's routes) beside its bounds. Each model is freed before the
    next."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.serve import set_matmul_precision, synthetic_batch
    from repro_torch.models import model as M

    set_matmul_precision()
    dev = torch.device("cuda")
    failures, out = [], {}
    order = ["deepseek_7b"] + [a for a in ARCH_IDS if a != "deepseek_7b"]
    for arch in order:
        for dtype in SERVE_DTYPES:
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cfg = _serve_cfg(arch, dtype)
            model = M.init_params(0, cfg, dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            batch = synthetic_batch(cfg, SERVE_BATCH, SERVE_PROMPT, gen)
            nxt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_EXTRA), generator=gen,
                                device=dev)
            max_seq = cfg.n_prefix_embeds + SERVE_PROMPT + SERVE_DECODE + 8
            n_params = sum(p.numel() for p in model.parameters())
            bf16 = dtype == "bfloat16"
            logits, cache, scale, left_out, gaps = _incremental_vs_full(
                torch, model, cfg, batch, nxt, max_seq, tuple(SERVE_FAULTS) if bf16 else ())
            sound = gaps.pop(None)
            timed = arch == "deepseek_7b" and bf16
            runs, secs = _two_decodes(torch, model, cfg, logits, cache, timed=timed)
            same = bool(torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1]))
            label = f"{arch} {dtype} ({cfg.n_layers} layers{'' if SERVE_DEPTH[arch] is None else ', depth cut'})"
            if not sound["finite"]:
                failures.append(f"{label}: non-finite logits")
            if not bf16 and sound["ratio"] > 1.0:
                failures.append(f"{label}: incremental vs forward {sound['ratio']:.3f}x the tolerance")
            limit = SERVE_BF16_ATOL[arch]
            if bf16 and sound["gap"] > limit:
                failures.append(f"{label}: incremental vs forward {sound['gap']:.4f} of the scale, "
                                f"past {limit}")
            for fault, g in gaps.items():
                if fault in SERVE_FAULTS_CAUGHT and g["gap"] <= limit:
                    failures.append(f"{label}: the planted {fault} reads {g['gap']:.4f} of the "
                                    f"scale, within {limit}")
            if not same:
                failures.append(f"{label}: two decodes differ")
            if timed:
                out["deepseek"] = _serve_timing(torch, model, cfg, batch, logits, cache, secs,
                                                max_seq, n_params)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            SERVE_SECONDS[f"{arch} {dtype}"] = sec
            if bf16:
                checked = (f"{sound['gap']:.6f} of the scale (limit {limit}; "
                           f"{sound['ratio']:.4f}x rtol 2e-2 atol 2e-3); planted in the decode: "
                           + ", ".join(f"{f} {g['gap']:.6f}" for f, g in gaps.items()))
            else:
                checked = f"{sound['ratio']:.4f}x the tolerance rtol 2e-2 atol 2e-3"
            print(f"[serve] {label}: {n_params:,} parameters; prefill {SERVE_BATCH}x"
                  f"{SERVE_PROMPT + cfg.n_prefix_embeds} + decode {SERVE_EXTRA} against forward "
                  f"over {SERVE_PROMPT + SERVE_EXTRA}: max |diff| {sound['diff']:.6g} (max |logit| "
                  f"{scale:.4g}), {checked}"
                  f"{f'; {left_out} decoded rows after a forward drop left out' if left_out else ''}"
                  f"; two decodes of "
                  f"{SERVE_DECODE} tokens bitwise equal: {same}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {sec:.1f} s")
            del model, cache, logits, runs, batch
    torch.cuda.empty_cache()
    check(not failures, "serving: " + "; ".join(failures))
    print(f"[serve] phase: {sum(SERVE_SECONDS.values()):.1f} s over {len(SERVE_SECONDS)} runs")
    return out


def _serve_timing(torch, model, cfg, batch, logits, cache, secs, max_seq, n_params):
    """deepseek-7b's numbers: prefill seconds (median of
    SERVE_TIMED_PREFILLS after the checks' warm one), a decode step (median
    of the two decodes' steps past each first), tok/s at the batch, the
    profiler's busy share and launches a step, and the bounds."""
    from repro_torch.models import model as M

    pre = []
    for _ in range(SERVE_TIMED_PREFILLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, c = M.prefill(model, batch, cfg, max_seq=max_seq)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
        del lg, c
    steps = secs[1:SERVE_DECODE] + secs[SERVE_DECODE + 1:]
    step_ms = sorted(steps)[len(steps) // 2] * 1e3
    prof = _decode_profile(torch, model, cfg, logits, cache)
    dec_ms, dec_bytes, pre_bound_ms, pre_bytes, flops = _serve_bounds(
        torch, model, cfg, SERVE_PROMPT + 2)
    pre_s = sorted(pre)[len(pre) // 2]
    head = _head_routes(torch, model, cfg)
    print(f"[serve-time] deepseek-7b bf16, {n_params:,} parameters ({_param_bytes(model):,} "
          f"bytes), batch {SERVE_BATCH}, prompt {SERVE_PROMPT}; card {card_line()}")
    print(f"[serve-time] prefill {SERVE_BATCH}x{SERVE_PROMPT}: {pre_s:.6f} s (median of "
          f"{SERVE_TIMED_PREFILLS}: {[round(p, 6) for p in pre]}); bound {pre_bound_ms:.4f} ms "
          f"(max of {pre_bytes:,} bytes at 3.35 TB/s and {flops:,} FLOPs at 989 TFLOP/s bf16)")
    print(f"[serve-time] decode step {step_ms:.4f} ms (median of {len(steps)}; min "
          f"{min(steps) * 1e3:.4f}, max {max(steps) * 1e3:.4f}), {SERVE_BATCH / step_ms * 1e3:.1f} "
          f"tok/s at batch {SERVE_BATCH}; bound {dec_ms:.4f} ms ({dec_bytes:,} bytes: the weights "
          f"but the embedding table, and the K/V at length {SERVE_PROMPT + 2})")
    if prof is None:
        print("[serve-time] device busy share: not measured (the profiler reported no device "
              "time)")
    else:
        print(f"[serve-time] profiled decode step: wall {prof['wall_ms']:.4f} ms, device busy "
              f"{prof['busy_ms']:.4f} ms ({prof['busy_ms'] / prof['wall_ms'] * 100:.1f}% of the "
              f"profiled wall, {prof['busy_ms'] / step_ms * 100:.1f}% of the unprofiled median "
              f"step), {prof['launches']:.1f} kernels and copies a step; top: {prof['top']}")
    print(f"[serve-time] the head's f32 logits at batch {SERVE_BATCH} (CUDA events, 50 "
          f"calls): bf16 product with an f32 output {head['out_dtype']:.6f} ms (the port's), "
          f"an f32 copy of the head {head['f32_copy']:.6f} ms, upcast each call "
          f"{head['upcast']:.6f} ms; max |diff| out_dtype vs f32 copy {head['diff']:.3g}")
    return dict(prefill_s=pre_s, step_ms=step_ms, prof=prof, dec_bound_ms=dec_ms,
                pre_bound_ms=pre_bound_ms, head=head)


def _head_routes(torch, model, cfg):
    """The three ways to the reference's f32 logits from bf16 operands at
    deepseek-7b's head, timed: ``layers._matmul_f32`` (a bf16 product with
    an f32 output), an f32 copy of the head kept beside it, and the head
    upcast at every call."""
    from repro_torch.models.layers import _matmul_f32

    w = model.lm_head.w
    x = torch.randn((SERVE_BATCH, cfg.d_model), device=w.device).to(w.dtype)
    w32 = w.float()
    routes = {"out_dtype": lambda: _matmul_f32(x, w), "f32_copy": lambda: x.float() @ w32,
              "upcast": lambda: x.float() @ w.float()}
    out = {}
    for name, fn in routes.items():
        for _ in range(3):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(50):
            fn()
        b.record()
        torch.cuda.synchronize()
        out[name] = a.elapsed_time(b) / 50
    out["diff"] = float((routes["out_dtype"]() - routes["f32_copy"]()).abs().max())
    del w32
    return out


def phase_serve_card_vs_cpu(torch):
    """Each of the ten architectures at ``reduced(ssm_chunk=8)`` with TF32
    off: the port's forward, prefill and 3 serve steps on the card against
    its own CPU run on the same weights and inputs; in f32 at the CPU
    parity tests' tolerance (rtol 1e-4, atol 1e-5 in units of the logits'
    scale, ``tests/_torch_lm.py``), in bf16 within SERVE_CPU_BF16_ATOL[arch] of
    the logits' scale (the card's and the CPU's bf16 products sum in other
    orders, and each rounding the other does not make moves these stacks'
    logits), and past it with each fault of SERVE_FAULTS_CAUGHT planted in
    the card's run where its code runs (the others printed)."""
    import copy

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.serve import set_matmul_precision, synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.training import make_serve_step

    def outputs(model, cfg, batch, nxt, dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        res = [M.forward(model, dict(b, tokens=torch.cat([b["tokens"], nxt.to(dev)], 1)), cfg)]
        logits, cache = M.prefill(model, b, cfg, max_seq=24 + 3 + 8)
        res.append(logits)
        serve = make_serve_step(cfg)
        for t in range(3):
            _, lg, cache = serve(model, nxt[:, t:t + 1].to(dev), cache)
            res.append(lg)
        return [r.cpu().float() for r in res]

    set_matmul_precision()
    worst, failures = {}, []
    for arch, dtype in ((a, d) for d in ("float32", "bfloat16") for a in ARCH_IDS):
        cfg = get_config(arch).reduced(ssm_chunk=8, dtype=dtype)
        cpu = M.init_params(0, cfg, "cpu")
        card = copy.deepcopy(cpu).to("cuda")
        batch = synthetic_batch(cfg, 2, 24, torch.Generator().manual_seed(1), n_frames=16)
        nxt = torch.randint(0, cfg.vocab_size, (2, 3), generator=torch.Generator().manual_seed(2))
        want = outputs(cpu, cfg, batch, nxt, "cpu")
        for fault in (None, *(SERVE_FAULTS if dtype == "bfloat16" else ())):
            calls = [0]
            with _planted(torch, fault, calls):
                got = outputs(card, cfg, batch, nxt, "cuda")
            if fault is not None and not calls[0]:
                continue
            if dtype == "float32":
                r = max(float(((g - w).abs() / (1e-5 * max(1.0, float(w.abs().max()))
                                                 + 1e-4 * w.abs())).max())
                        for g, w in zip(got, want))
            else:
                r = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                        for g, w in zip(got, want))
            worst[(arch, dtype, fault)] = r
        r, limit = worst[(arch, dtype, None)], SERVE_CPU_BF16_ATOL[arch]
        if dtype == "float32" and r > 1.0:
            failures.append(f"{arch} {dtype} at {r:.3f}x the tolerance")
        if dtype == "bfloat16" and r > limit:
            failures.append(f"{arch} {dtype} at {r:.4f} of the scale, past {limit}")
        for fault in SERVE_FAULTS_CAUGHT:
            g = worst.get((arch, dtype, fault))
            if g is not None and g <= limit:
                failures.append(f"{arch} {dtype}: the planted {fault} reads {g:.4f} of the scale, "
                                f"within {limit}")
        del cpu, card
    print("[serve-cpu] reduced float32, the card against the CPU (forward, prefill, 3 decode "
          "steps), worst |diff| as a share of rtol 1e-4 + atol 1e-5 x scale: "
          + ", ".join(f"{a} {r:.4f}" for (a, d, f), r in worst.items() if d == "float32"))
    print("[serve-cpu] reduced bfloat16, the card against the CPU, max |diff| over the scale "
          "(limit): " + ", ".join(f"{a} {r:.6g} ({SERVE_CPU_BF16_ATOL[a]})"
                                  for (a, d, f), r in worst.items()
                                  if d == "bfloat16" and f is None))
    for fault in SERVE_FAULTS:
        print(f"[serve-cpu] reduced bfloat16, {fault} planted in the card's run"
              f"{' (must be caught)' if fault in SERVE_FAULTS_CAUGHT else ''}: "
              + (", ".join(f"{a} {r:.6g}" for (a, d, f), r in worst.items() if f == fault)
                 or "its code runs in none"))
    check(not failures, "serving, card against CPU: " + "; ".join(failures))


# --------------------------------------------------------------------------
# LM training (the port's models, training, runtime and data packages; no
# kernel of their own: the products are cuBLAS's through torch.matmul)
# --------------------------------------------------------------------------

# the reference's train_4k shape (launch/cells.py): sequence 4,096, one data
# shard's 16 rows of the global 256, in its TRAIN_MICROBATCHES microbatches
TRAIN_SEQ, TRAIN_BATCH = 4096, 16
TRAIN_MICROBATCHES = {"deepseek_7b": 8, "mamba2_130m": 1}
# architecture -> the layers it trains on the card (None: its full config).
# deepseek-7b's 30 layers need ~138 GB of AdamW state (bf16 weights and
# grads, f32 m, v, master and accumulator): the deepest whole count whose
# measured peak leaves 10% of the card free (PERF.md §4,
# scripts/torch_train_depth_probe.py)
TRAIN_DEPTH = {"deepseek_7b": 9, "mamba2_130m": None}
# the rate reached at step 1 (warmup 1): the reference's base lr for
# mamba2-130m; deepseek-7b overshoots it (AdamW's first step moves every
# weight by the rate: its loss 13.59 -> 47.88 at 3e-4), so the rate of
# scripts/torch_train_depth_probe.py's scan (1e-6, 1e-5, 3e-5, 1e-4 at 9
# layers) whose third loss is lowest (PERF.md §6)
TRAIN_LR = {"deepseek_7b": 1e-5, "mamba2_130m": 3e-4}
TRAIN_TIMEOUT_S = 300
TRAIN_STEPS = 3  # on one batch: the loss falls (tests/test_archs.py's criterion)
TRAIN_FREE_SHARE = 0.10  # of the card's memory the peak must leave free
# the card against the CPU at the reduced configs, one make_train_step(
# microbatches=2) step from the same weights and batch (the default
# schedule: lr 3e-6 at step 1): loss and grad_norm as a relative gap,
# the updated parameters as max |diff| over max(1, max |p|); each limit
# read from the runs on an H100 (PERF.md §6)
TRAIN_CPU_LIMITS = {  # about 3-10x the largest gap read over the ten (PERF.md §6)
    "float32": {"loss": 1e-6, "grad_norm": 1e-5, "params": 1e-5},
    "bfloat16": {"loss": 1e-3, "grad_norm": 1e-2, "params": 1e-4},
}
RESUME_ARCH, RESUME_BATCH, RESUME_SEQ, RESUME_STEPS, RESUME_EVERY, RESUME_CRASH = (
    "mamba2_130m", 4, 512, 6, 3, 4)
RESUME_TIMEOUT_S = 300
TRAIN_SECONDS = {}


def _train_cfg(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if TRAIN_DEPTH[arch] is not None:
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_DEPTH[arch])
    return cfg


def _train_flops(model, cfg, tokens, rows, seq):
    """(model FLOPs of a step, remat's extra forward): 6 FLOPs a weight a
    token for every matmul weight (the blocks and the head; a tied head is
    the embedding table read as one), plus the attention's two S x S
    products a layer (the full square, as the port computes it; forward
    and twice that backward); remat runs each block's forward again."""
    params = dict(model.named_parameters())
    blocks = sum(p.numel() for n, p in params.items() if n.startswith(("layers.", "prefix_")))
    head = model.embed.tok.numel() if cfg.tie_embeddings else model.lm_head.w.numel()
    other = sum(p.numel() for n, p in params.items()
                if not n.startswith(("layers.", "prefix_", "embed.", "lm_head.")))
    attn_fwd = 0
    if cfg.family != "ssm":
        attn_fwd = cfg.n_layers * 2 * 2 * rows * seq * seq * cfg.q_dim
    model_flops = 6 * (blocks + head + other) * tokens + 3 * attn_fwd
    return model_flops, 2 * blocks * tokens + attn_fwd


def _profile_train_step(torch, fn):
    """Device busy share and kernel launches of one train step
    (``torch.profiler``); None where the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us <= 0:
        return None
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms"
                    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:5])
    return dict(busy_s=busy_us / 1e6, wall_s=wall, launches=sum(e.count for e in rows), top=top)


def _train_run(torch, arch):
    """TRAIN_STEPS steps of ``arch`` (``_train_cfg``) on one batch at
    TRAIN_LR[arch], the last under the profiler: the losses, each step's
    seconds, the profile, the FLOPs and the peak memory."""
    from repro_torch.data.lm_pipeline import batch_at_step
    from repro_torch.launch.serve import set_matmul_precision
    from repro_torch.training import init_train_state, make_train_step

    set_matmul_precision()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    cfg = _train_cfg(arch)
    params, state = init_train_state(0, cfg, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at_step(
        cfg, 0, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0).items()}
    step = make_train_step(cfg, microbatches=TRAIN_MICROBATCHES[arch], base_lr=TRAIN_LR[arch],
                           warmup=1)
    losses, secs, res = [], [], {}

    def one():  # a step's wall: the profiler's reading of its events is not in it
        torch.cuda.synchronize()
        ts = time.perf_counter()
        res["out"] = step(params, state, batch)
        torch.cuda.synchronize()
        res["wall"] = time.perf_counter() - ts

    prof = None
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:
            prof = _profile_train_step(torch, one)
        else:
            one()
        _, _, metrics = res["out"]
        losses.append(float(metrics["loss"]))
        secs.append(res["wall"])
    flops, remat = _train_flops(params, cfg, TRAIN_BATCH * TRAIN_SEQ, TRAIN_BATCH, TRAIN_SEQ)
    out = dict(arch=arch, n_layers=cfg.n_layers, optimizer=cfg.optimizer, remat=cfg.remat,
               params=sum(p.numel() for p in params.parameters()), losses=losses, secs=secs,
               grad_norm=float(metrics["grad_norm"]), prof=prof, flops=flops, remat_flops=remat,
               peak=torch.cuda.max_memory_allocated(),
               total=torch.cuda.get_device_properties(0).total_memory)
    del params, state, batch, step, res, metrics
    torch.cuda.empty_cache()
    return out


def train_child(arch, work):
    """``_train_run`` in a child process (``--train-child ARCH DIR``), its
    numbers in DIR/train_ARCH.json: a fresh CUDA context and allocator, as
    ``scripts/torch_train_depth_probe.py`` measured TRAIN_DEPTH in."""
    import torch

    Path(work, f"train_{arch}.json").write_text(json.dumps(_train_run(torch, arch)))


def phase_train(torch):
    """LM training at published widths on the card: deepseek-7b (its
    recipe: bf16, AdamW with the f32 master, remat) cut to TRAIN_DEPTH
    layers, and mamba2-130m whole, each at the reference's train_4k shape
    (16 rows of 4,096 tokens in TRAIN_MICROBATCHES microbatches), a cut
    model in a child process (``train_child``, the allocator's state the
    depth was measured in), the whole one here. TRAIN_STEPS steps on one
    batch at TRAIN_LR[arch], the last under the profiler (its launches and
    the device's busy share): every loss finite and the last below the
    first; the step's seconds (median of the steps after the first, the
    profiled one among them), tokens/s, the model FLOPs and their share of
    989 TFLOP/s, and the peak memory, which must leave TRAIN_FREE_SHARE of
    the card free."""
    import os
    import tempfile

    failures, out = [], {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch in ("deepseek_7b", "mamba2_130m"):
        t0 = time.perf_counter()
        if TRAIN_DEPTH[arch] is None:  # the whole model, with room to spare: in this process
            r = _train_run(torch, arch)
        else:
            with tempfile.TemporaryDirectory() as work:
                proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                                       "--train-child", arch, work], env=env,
                                      capture_output=True, text=True, timeout=TRAIN_TIMEOUT_S)
                check(proc.returncode == 0, f"train child {arch}: exit {proc.returncode}\n"
                      f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
                r = json.loads(Path(work, f"train_{arch}.json").read_text())
        TRAIN_SECONDS[arch] = time.perf_counter() - t0
        losses, secs, prof, peak, total = r["losses"], r["secs"], r["prof"], r["peak"], r["total"]
        step_s = statistics.median(secs[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        label = (f"{arch} bf16 ({r['n_layers']} layers"
                 f"{', depth cut' if TRAIN_DEPTH[arch] is not None else ''})")
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"{label}: non-finite losses {losses}")
        elif not losses[-1] < losses[0]:
            failures.append(f"{label}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
        if peak > (1 - TRAIN_FREE_SHARE) * total:
            failures.append(f"{label}: peak {peak / 1e9:.2f} GB leaves under "
                            f"{TRAIN_FREE_SHARE:.0%} of {total / 1e9:.2f} GB free")
        print(f"[train] {label}: {r['params']:,} parameters, {r['optimizer']}, remat "
              f"{r['remat']}; {TRAIN_STEPS} steps on one batch of {TRAIN_BATCH}x{TRAIN_SEQ} in "
              f"{TRAIN_MICROBATCHES[arch]} microbatches at lr {TRAIN_LR[arch]} (warmup 1): "
              f"losses {[round(x, 6) for x in losses]}, grad_norm {r['grad_norm']:.6g}")
        print(f"[train-time] {label}: card {card_line()}; step {step_s:.6f} s (median of the "
              f"{len(secs) - 1} steps after the first, the last profiled; all "
              f"{[round(x, 4) for x in secs]}), "
              f"{tokens / step_s:,.1f} tokens/s; model FLOPs a step {r['flops']:.4e} (6 x "
              f"weights x tokens + attention), "
              f"{r['flops'] / step_s / BF16_FLOPS_PER_S * 100:.2f}% of 989 TFLOP/s; remat's "
              f"extra forward {r['remat_flops']:.4e} FLOPs apart; peak device memory "
              f"{peak / 1e9:.3f} GB of {total / 1e9:.2f} GB ({peak / total * 100:.1f}%); "
              f"{TRAIN_SECONDS[arch]:.1f} s")
        if prof is None:
            print(f"[train-time] {label}: device busy share not measured (the profiler "
                  "reported no device time)")
        else:
            print(f"[train-time] {label}: profiled step {TRAIN_STEPS}: wall {prof['wall_s']:.4f} s, device "
                  f"busy {prof['busy_s']:.4f} s ({prof['busy_s'] / prof['wall_s'] * 100:.1f}% "
                  f"of the profiled wall), {prof['launches']:,} kernels and copies a step; "
                  f"top: {prof['top']}")
        out[arch] = dict(losses=losses, step_s=step_s, peak=peak, flops=r["flops"], prof=prof,
                         remat=r["remat_flops"])
    check(not failures, "training: " + "; ".join(failures))
    return out


def phase_train_card_vs_cpu(torch):
    """The ten architectures at ``reduced(ssm_chunk=8)`` in f32 and bf16 with
    TF32 off: one ``make_train_step(microbatches=2)`` step (its default
    schedule) on the card against the port on the CPU from the same weights
    and batch (4 rows of 32): loss and grad_norm as a relative gap, the
    updated parameters as max |diff| over max(1, max |p|), each within
    TRAIN_CPU_LIMITS[dtype]."""
    import copy

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data.lm_pipeline import batch_at_step
    from repro_torch.launch.serve import set_matmul_precision
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training import optimizers as opt

    set_matmul_precision()
    t0 = time.perf_counter()
    worst, failures = {}, []
    for dtype in ("float32", "bfloat16"):
        for arch in ARCH_IDS:
            cfg = get_config(arch).reduced(ssm_chunk=8, dtype=dtype)
            cpu, _ = init_train_state(0, cfg, "cpu")
            card = copy.deepcopy(cpu).to("cuda")
            batch = {k: torch.from_numpy(v)
                     for k, v in batch_at_step(cfg, 0, batch=4, seq_len=32).items()}
            step = make_train_step(cfg, microbatches=2)
            res = {}
            for dev, model in (("cpu", cpu), ("cuda", card)):
                state = opt.init_optimizer(cfg.optimizer, model)
                model, state, metrics = step(model, state, {k: v.to(dev) for k, v in batch.items()})
                res[dev] = ({n: p.detach().float().cpu() for n, p in model.named_parameters()},
                            {k: float(metrics[k]) for k in ("loss", "grad_norm")})
            gaps = {k: abs(res["cuda"][1][k] - res["cpu"][1][k]) / abs(res["cpu"][1][k])
                    for k in ("loss", "grad_norm")}
            gaps["params"] = max(float((res["cuda"][0][n] - w).abs().max())
                                 / max(1.0, float(w.abs().max()))
                                 for n, w in res["cpu"][0].items())
            finite = all(math.isfinite(res["cuda"][1][k]) for k in ("loss", "grad_norm"))
            worst[(arch, dtype)] = gaps
            for k, limit in TRAIN_CPU_LIMITS[dtype].items():
                if not finite or not gaps[k] <= limit:
                    failures.append(f"{arch} {dtype} {k}: {gaps[k]:.3g} past {limit}")
            del cpu, card, res
    for dtype in ("float32", "bfloat16"):
        print(f"[train-cpu] reduced {dtype}, one step with 2 microbatches, the card against the "
              f"CPU (loss gap, grad_norm gap, params max |diff| over scale; limits "
              f"{TRAIN_CPU_LIMITS[dtype]}): "
              + ", ".join(f"{a} {g['loss']:.3g}/{g['grad_norm']:.3g}/{g['params']:.3g}"
                          for (a, d), g in worst.items() if d == dtype))
    TRAIN_SECONDS["card vs cpu"] = time.perf_counter() - t0
    check(not failures, "training, card against CPU: " + "; ".join(failures))


def train_resume_child(work):
    """The resume check's child (``--train-resume-child DIR``): deterministic
    kernels on (its parent set CUBLAS_WORKSPACE_CONFIG before CUDA
    started); RESUME_ARCH whole trained RESUME_STEPS steps straight, and
    again crashed at step RESUME_CRASH and resumed from its step
    RESUME_EVERY checkpoint; its result in DIR/resume.json."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.lm_pipeline import batch_at_step
    from repro_torch.launch.serve import set_matmul_precision
    from repro_torch.runtime import Trainer, TrainerConfig

    torch.use_deterministic_algorithms(True)
    set_matmul_precision()
    cfg = get_config(RESUME_ARCH)

    def data_fn(step):
        return batch_at_step(cfg, step, batch=RESUME_BATCH, seq_len=RESUME_SEQ, seed=0)

    def trainer(d):
        return Trainer(cfg, TrainerConfig(total_steps=RESUME_STEPS, checkpoint_every=RESUME_EVERY,
                                          checkpoint_dir=str(Path(work) / d), keep_checkpoints=1),
                       data_fn, device="cuda")

    t0 = time.perf_counter()
    a = trainer("straight")
    pa, oa, _ = a.run()
    t_straight = time.perf_counter() - t0
    b = trainer("crashed")
    try:
        b.run(crash_at=RESUME_CRASH)
        raise CheckFailed("the crashed run did not crash")
    except RuntimeError as err:
        if "simulated crash" not in str(err):
            raise
    c = trainer("crashed")
    pc, oc, step = c.run()
    same = all(torch.equal(x, y) for x, y in zip(pa.parameters(), pc.parameters()))
    same_opt = int(oa.step) == int(oc.step) and all(
        torch.equal(x, y) for path in oa.inner for x, y in zip(oa.inner[path], oc.inner[path]))
    differ = [n for (n, x), (_, y) in zip(pa.named_parameters(), pc.named_parameters())
              if not torch.equal(x, y)]
    out = dict(params_bits=same, opt_bits=same_opt, step=step, differ=differ[:5],
               history=a.history, resumed=c.history, crashed=b.history,
               straight_s=t_straight, total_s=time.perf_counter() - t0,
               params=sum(p.numel() for p in pa.parameters()))
    Path(work, "resume.json").write_text(json.dumps(out))


def train_resume_start():
    """Start the resume check's child (``--train-resume-child``) in the
    background (``_child_start``), its checkpoints (~2 GB each, the bits
    under test, not the disk) in memory where the host has a tmpfs; it runs
    beside the entry points' last turn, which times no gate."""
    import os

    shm = "/dev/shm" if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK) else None
    return _child_start("--train-resume-child", RESUME_TIMEOUT_S,
                        {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, tmp_dir=shm)


def phase_train_resume(torch, started):
    """Crash-equivalent resume on the card: the child (deterministic
    kernels, ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, ``train_resume_start``)
    trains RESUME_ARCH whole at RESUME_BATCH x RESUME_SEQ for RESUME_STEPS
    steps with a checkpoint every RESUME_EVERY, crashes at step
    RESUME_CRASH and resumes; its final parameters and optimizer state must
    equal the uninterrupted run's bit for bit. A failure in the child (an
    op without a deterministic CUDA form raises there, naming itself)
    fails the phase with its text."""
    out, _ = _child_result(started, "resume.json")
    check(out["params_bits"] and out["opt_bits"] and out["step"] == RESUME_STEPS,
          f"train resume: the resumed run differs from the straight one (parameters "
          f"{out['params_bits']}, optimizer state {out['opt_bits']}, step {out['step']}; "
          f"first differing {out['differ']})")
    TRAIN_SECONDS["resume"] = time.perf_counter() - started[2]
    print(f"[train-resume] {RESUME_ARCH} whole ({out['params']:,} parameters), "
          f"{RESUME_BATCH}x{RESUME_SEQ}, {RESUME_STEPS} steps, a checkpoint every {RESUME_EVERY}, "
          f"deterministic kernels: crashed at step {RESUME_CRASH} and resumed, the final "
          f"parameters and optimizer state bit for bit the straight run's; losses "
          f"{[round(x, 6) for x in out['history']]} (resumed {[round(x, 6) for x in out['resumed']]}); "
          f"the straight run {out['straight_s']:.1f} s, the child {out['total_s']:.1f} s, "
          f"{TRAIN_SECONDS['resume']:.1f} s from its start (beside the entry points' last turn)")


# ---------------------------------------------------------------------------
# The LM stack on a mesh (ROADMAP item 15c): the sharding rules on a (1, 1)
# DeviceMesh over NCCL, and the dry run's cells in a child
# ---------------------------------------------------------------------------

MESH_LM_TIMEOUT_S = 300
MESH_LM_DECODE = 3  # decode steps after the 4 x 128 prefill (phase_serve's shape)
DRYRUN_TIMEOUT_S = 900
DRYRUN_DEVICE = "cuda"  # the fake tensors' device (fake: no memory on the card)
# the production cells on (16, 16): (arch, shape)
DRYRUN_CELLS = (("deepseek_7b", "train_4k"), ("deepseek_7b", "decode_32k"),
                ("mamba2_130m", "long_500k"), ("deepseek_7b", "prefill_32k"))
DRYRUN_CROSS_TOL = 0.10  # the (1, 1) count against phase_train's model FLOPs + remat's forward
CARD_GB = 80.0  # an H100 SXM's device memory
MESH_LM_SECONDS = {}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _first_divergence(torch, run_a, run_b):
    """The first op whose result differs between two runs of the same step
    (each op's result summed in f64 on the card, below DTensor's layer;
    the global-shape runs of DTensor's propagation are fake and skipped):
    (index, op a, op b) or None."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sums(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if (isinstance(out, torch.Tensor) and out.is_floating_point() and not is_fake(out)
                    and "_c10d" not in str(func)):
                self.rows.append((str(func), tuple(out.shape),
                                  float(out.detach().double().sum())))
            return out

    logs = []
    for fn in (run_a, run_b):
        with Sums() as m:
            fn()
        logs.append([r for r in m.rows if "copy" not in r[0] and "view" not in r[0]])
    for i, (a, b) in enumerate(zip(*logs)):
        if a[1:] != b[1:] and not (a[2] != a[2] and b[2] != b[2]):
            return i, a, b
    return None


def mesh_lm_child(work):
    """The mesh checks' child (``--mesh-lm-child DIR``): deterministic
    kernels (its parent set CUBLAS_WORKSPACE_CONFIG before CUDA started),
    NCCL at world size 1 and ``make_host_mesh()`` (1, 1) on the card.
    deepseek-7b at its full config in bf16: a 4 x 128 prefill and
    MESH_LM_DECODE greedy decode steps, plain and with its parameters,
    batch and cache as DTensors under ``activation_mesh``; mamba2-130m whole:
    one train step at 16 x 4,096 plain and on the mesh from the same
    weights. Its numbers in DIR/mesh_lm.json."""
    import copy

    import torch
    import torch.distributed as tdist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.lm_pipeline import batch_at_step
    from repro_torch.launch.dryrun import distribute_opt_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import set_matmul_precision, synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.models import sharding as sh
    from repro_torch.training import init_train_state, make_serve_step, make_train_step

    torch.use_deterministic_algorithms(True)
    set_matmul_precision()
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                             world_size=1, device_id=torch.device("cuda", 0))
    out = {"backend": tdist.get_backend()}
    try:
        mesh = make_host_mesh(device="cuda")
        out["mesh"] = [str(mesh.device_type), list(mesh.shape), list(mesh.mesh_dim_names)]

        def on_mesh(tensors):
            specs = sh.batch_specs(tensors, mesh)
            return {k: distribute_tensor(v, mesh, sh.placements(specs[k], mesh))
                    for k, v in tensors.items()}

        # deepseek-7b serving
        t0 = time.perf_counter()
        cfg = get_config("deepseek_7b")
        model = M.init_params(0, cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = synthetic_batch(cfg, SERVE_BATCH, SERVE_PROMPT, gen)
        max_seq = SERVE_PROMPT + MESH_LM_DECODE + 8
        serve = make_serve_step(cfg)

        def decode(params, prompt):
            logits, cache = M.prefill(params, prompt, cfg, max_seq)
            tok = sh.argmax_last(logits[:, -1, :]).to(torch.int32)[:, None]
            toks, lgs = [_whole(tok)], [_whole(logits)]
            for _ in range(MESH_LM_DECODE):
                tok, lg, cache = serve(params, tok, cache)
                toks.append(_whole(tok))
                lgs.append(_whole(lg))
            kinds = sorted({type(v).__name__ for k, v in cache.items() if k != "len"})
            return torch.cat(toks, 1), lgs, kinds

        plain_toks, plain_lgs, _ = decode(model, batch)
        sh.distribute_params(model, mesh)
        with sh.activation_mesh(mesh), implicit_replication():
            mesh_toks, mesh_lgs, kinds = decode(model, on_mesh(batch))
        out["serve"] = dict(
            tokens_equal=bool(torch.equal(plain_toks, mesh_toks)),
            tokens=plain_toks.tolist(),
            max_abs_diff=max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(plain_lgs, mesh_lgs)),
            logit_scale=max(float(a.float().abs().max()) for a in plain_lgs),
            param_kind=type(next(model.parameters())).__name__, cache_kinds=kinds,
            seconds=time.perf_counter() - t0)
        del model, plain_lgs, mesh_lgs
        torch.cuda.empty_cache()

        # mamba2-130m training
        t0 = time.perf_counter()
        cfg = get_config("mamba2_130m")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at_step(
            cfg, 0, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0).items()}
        step = make_train_step(cfg, microbatches=TRAIN_MICROBATCHES["mamba2_130m"],
                               base_lr=TRAIN_LR["mamba2_130m"], warmup=1)

        def plain_state():
            return init_train_state(0, cfg, dev)

        def mesh_state():
            params, state = init_train_state(0, cfg, dev)
            state = distribute_opt_state(state, params, mesh)
            return sh.distribute_params(params, mesh, fsdp=True), state

        def leaves(metrics, params, state):
            """The step's results by name, whole: its loss and gradient
            norm, the updated parameters, the optimizer's state."""
            out = {k: _whole(metrics[k]) for k in ("loss", "grad_norm")}
            out.update({f"param {n}": _whole(p).detach() for n, p in params.named_parameters()})
            out["state step"] = _whole(state.step)
            for path, leaf in state.inner.items():
                for field, t in zip(leaf._fields, leaf):
                    out[f"state {path}/{field}"] = _whole(t)
            return out

        def run_plain():
            params, state = plain_state()
            params, state, metrics = step(params, state, batch)
            return leaves(metrics, params, state)

        def run_mesh():
            params, state = mesh_state()
            with sh.activation_mesh(mesh), implicit_replication():
                params, state, metrics = step(params, state, on_mesh(batch))
            return leaves(metrics, params, state)

        def same_bits(x, y):
            return x.shape == y.shape and x.dtype == y.dtype and torch.equal(
                x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))

        a, b = run_plain(), run_mesh()
        differ = [k for k in a if not same_bits(a[k], b[k])]
        out["train"] = dict(loss=(float(a["loss"]), float(b["loss"])),
                            grad_norm=(float(a["grad_norm"]), float(b["grad_norm"])),
                            leaves=len(a), bits_equal=not differ,
                            first_leaf=differ[0] if differ else None,
                            seconds=time.perf_counter() - t0)
        del a, b
        if differ:
            out["train"]["first_divergence"] = _first_divergence(torch, run_plain, run_mesh)
    finally:
        tdist.destroy_process_group()
    Path(work, "mesh_lm.json").write_text(json.dumps(out))


def dryrun_child(work):
    """The dry run's child (``--dryrun-child DIR``): its fake process groups
    live here, away from the script's NCCL groups. The (1, 1) cells of the
    card's own runs (phase_train's deepseek-7b cut: TRAIN_DEPTH layers,
    TRAIN_BATCH x TRAIN_SEQ in 8 microbatches; phase_serve's 4 x 128
    prefill and a decode step at its cache length) on a fake group of one
    rank, then DRYRUN_CELLS on (16, 16) over 256 fake ranks
    (``launch.dryrun.run_cell``); the records in DIR/dryrun.json."""
    import torch  # noqa: F401  (the child's own CUDA build, no device touched)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh

    recs = {}
    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        mesh = make_host_mesh(device=DRYRUN_DEVICE)
        deep = get_config("deepseek_7b")
        cut = dataclasses.replace(deep, n_layers=TRAIN_DEPTH["deepseek_7b"])
        recs["train_cut_1x1"] = dryrun.run_cell(
            "deepseek_7b", "train", False, device=DRYRUN_DEVICE, mesh=mesh, cfg_override=cut,
            shape=ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH),
            microbatches=TRAIN_MICROBATCHES["deepseek_7b"])
        recs["prefill_1x1"] = dryrun.run_cell(
            "deepseek_7b", "prefill", False, device=DRYRUN_DEVICE, mesh=mesh, cfg_override=deep,
            shape=ShapeSpec("prefill", "prefill", SERVE_PROMPT, SERVE_BATCH))
        recs["decode_1x1"] = dryrun.run_cell(
            "deepseek_7b", "decode", False, device=DRYRUN_DEVICE, mesh=mesh, cfg_override=deep,
            shape=ShapeSpec("decode", "decode", SERVE_PROMPT + SERVE_DECODE + 8, SERVE_BATCH))
    for arch, shape in DRYRUN_CELLS:
        recs[f"{arch} {shape}"] = dryrun.run_cell(arch, shape, False, device=DRYRUN_DEVICE)
    recs["seconds"] = time.perf_counter() - t0
    Path(work, "dryrun.json").write_text(json.dumps(recs, default=str))


def _child_start(flag, timeout_s, env_extra=None, tmp_dir=None):
    """Start ``chip_smoke.py FLAG DIR`` in the background (its own session,
    its log and numbers in DIR, a new directory under ``tmp_dir``, the
    system's temporary directory by default): (process, DIR, start time,
    log, timeout)."""
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix="repro_child_", dir=tmp_dir)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    log = open(Path(d, "child.log"), "w+")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), flag, d], env=env,
                            stdout=log, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return proc, d, time.perf_counter(), log, timeout_s


def _child_result(started, name):
    """Wait for a ``_child_start`` child and read its DIR/NAME (the child's
    log in the failure's text); the directory is removed."""
    import os
    import shutil
    import signal

    proc, work, t0, log, timeout_s = started
    try:
        try:
            proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise CheckFailed(f"{name} child: past {timeout_s} s")
        log.seek(0)
        text = log.read()
        check(proc.returncode == 0, f"{name} child: exit {proc.returncode}\n{text[-5000:]}")
        return json.loads(Path(work, name).read_text()), time.perf_counter() - t0
    finally:
        log.close()
        shutil.rmtree(work, ignore_errors=True)


def _child_stop(started):
    """Kill a ``_child_start`` child that is still running (a phase before
    its reading failed) and remove its directory."""
    import os
    import shutil
    import signal

    proc, work, _, log, _ = started
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    log.close()
    shutil.rmtree(work, ignore_errors=True)


def dryrun_start():
    return _child_start("--dryrun-child", DRYRUN_TIMEOUT_S)


def _roofline_line(rec):
    r = rec["roofline"]
    return (f"compute {r['compute_s']:.6g} s, memory {r['memory_s']:.6g} s, collective "
            f"{r['collective_s']:.6g} s, dominant {r['dominant']}; FLOPs a rank "
            f"{r['flops_per_device']:.4e}, bytes a rank {r['bytes_per_device']:.4e}, wire bytes "
            f"{r['wire_bytes_per_device']:.4e}")


def _tally_line(rec):
    t = rec["roofline"]["collectives"]
    return ", ".join(f"{k} {int(v['count'])} ({v['wire_bytes']:.4e} B)" for k, v in t.items()
                     if v["count"])


def phase_mesh_lm(torch):
    """The LM stack on the (1, 1) NCCL mesh on the card (a child,
    ``mesh_lm_child``): deepseek-7b's decoded tokens under
    ``activation_mesh`` must equal the plain run's (the logits' largest
    difference printed); mamba2-130m's train step on it must give the plain
    step's loss, gradient norm, updated parameters and optimizer state bit
    for bit, else the first leaf and the first op whose bits differ are
    named and the phase fails."""
    failures = []
    t0 = time.perf_counter()
    res, _ = _child_result(_child_start("--mesh-lm-child", MESH_LM_TIMEOUT_S,
                                        {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}), "mesh_lm.json")
    MESH_LM_SECONDS["mesh child"] = time.perf_counter() - t0
    s, t = res["serve"], res["train"]
    print(f"[mesh-lm] mesh {res['mesh']} over {res['backend']} at world size 1; card "
          f"{card_line()}")
    print(f"[mesh-lm] deepseek-7b bf16 (full config) {SERVE_BATCH}x{SERVE_PROMPT} prefill + "
          f"{MESH_LM_DECODE} greedy decode steps, parameters {s['param_kind']}, cache "
          f"{s['cache_kinds']}: tokens equal the plain run's: {s['tokens_equal']}; logits' max "
          f"|diff| {s['max_abs_diff']:.6g} (max |logit| {s['logit_scale']:.4g}); "
          f"{s['seconds']:.1f} s")
    if not s["tokens_equal"]:
        failures.append("deepseek-7b on the mesh decoded other tokens than the plain run")
    print(f"[mesh-lm] mamba2-130m train step at {TRAIN_BATCH}x{TRAIN_SEQ}: loss plain/mesh "
          f"{t['loss'][0]!r}/{t['loss'][1]!r}, grad_norm {t['grad_norm'][0]!r}/"
          f"{t['grad_norm'][1]!r}; the loss, gradient norm, updated parameters and optimizer "
          f"state ({t['leaves']} tensors) bit for bit equal: {t['bits_equal']}; "
          f"{t['seconds']:.1f} s")
    if not t["bits_equal"]:
        failures.append(f"mamba2-130m's step on the mesh differs from the plain step in its "
                        f"bits: the first differing leaf {t['first_leaf']}; the first differing "
                        f"op (index, plain, mesh): {t.get('first_divergence')}")
    check(not failures, "mesh LM: " + "; ".join(failures))


def phase_dryrun(dryrun_started, train_out, serve_out):
    """The dry run (its child, ``dryrun_child``, started after the training
    phases): the (1, 1) count of phase_train's deepseek-7b cut must land
    within DRYRUN_CROSS_TOL of that step's model FLOPs plus remat's
    forward, its roofline bound printed beside the measured step, and the
    serving cells' beside phase_serve's times; DRYRUN_CELLS on (16, 16)
    must come out ok, each with its three terms in H100 figures, its
    tallies and its GB a rank against the card's 80 GB."""
    failures = []
    t1 = time.perf_counter()
    recs, child_s = _child_result(dryrun_started, "dryrun.json")
    MESH_LM_SECONDS["dry-run child (waited)"] = time.perf_counter() - t1
    bad = [k for k, r in recs.items() if k != "seconds" and r["status"] != "ok"]
    for k in bad:
        failures.append(f"dry run {k}: {recs[k]['status']} {recs[k].get('error', '')[:300]}")
    print(f"[dryrun] the dry run's child: {recs['seconds']:.1f} s of cells, "
          f"{child_s:.1f} s from its start; fake tensors on '{DRYRUN_DEVICE}'; H100 figures "
          f"989 TFLOP/s bf16, 3.35 TB/s, 50 GB/s a link (card {card_line()})")
    if "train_cut_1x1" not in bad and "deepseek_7b" in train_out:
        rec, tr = recs["train_cut_1x1"], train_out["deepseek_7b"]
        want = tr["flops"] + tr["remat"]
        got = rec["roofline"]["flops_per_device"]
        gap = got / want - 1.0
        print(f"[dryrun] (1, 1) phase_train's deepseek-7b cut ({TRAIN_DEPTH['deepseek_7b']} "
              f"layers, {TRAIN_BATCH}x{TRAIN_SEQ}, {rec['microbatches']} microbatches): counted "
              f"FLOPs {got:.4e} against phase_train's model FLOPs + remat's forward "
              f"{tr['flops']:.4e} + {tr['remat']:.4e} = {want:.4e} ({gap * 100:+.2f}%, limit "
              f"{DRYRUN_CROSS_TOL:.0%}); {_roofline_line(rec)}; roofline bound "
              f"{rec['roofline'][rec['roofline']['dominant'] + '_s']:.4f} s against the measured "
              f"step {tr['step_s']:.4f} s; {rec['hbm_per_device_gb']:.2f} GB (arguments + "
              f"temporaries)")
        if abs(gap) > DRYRUN_CROSS_TOL:
            failures.append(f"the (1, 1) FLOP count of phase_train's cut is {gap * 100:+.1f}% "
                            f"off its model FLOPs + remat")
    deep = serve_out.get("deepseek") or {}
    for key, measured in (("prefill_1x1", deep.get("prefill_s")),
                          ("decode_1x1", (deep.get("step_ms") or 0) / 1e3 or None)):
        if key in bad:
            continue
        rec = recs[key]
        bound = rec["roofline"][rec["roofline"]["dominant"] + "_s"]
        print(f"[dryrun] (1, 1) deepseek-7b {key.split('_')[0]} at phase_serve's shape: "
              f"{_roofline_line(rec)}; roofline bound {bound:.6f} s against the measured "
              f"{'not measured' if measured is None else f'{measured:.6f} s'}")
    for arch, shape in DRYRUN_CELLS:
        key = f"{arch} {shape}"
        if key in bad:
            continue
        rec = recs[key]
        gb = rec["hbm_per_device_gb"]
        print(f"[dryrun] {key} (16, 16), {rec['probe_s']} s: {_roofline_line(rec)}; tallies "
              f"{_tally_line(rec) or 'none'}; {gb:.2f} GB a rank of the card's {CARD_GB:.0f} GB "
              f"({'fits' if gb <= CARD_GB else 'does not fit'}: arguments "
              f"{rec['memory']['argument_size'] / 1e9:.2f} GB + temporaries "
              f"{rec['memory']['temp_size'] / 1e9:.2f} GB); useful FLOPs ratio "
              f"{rec['useful_flops_ratio']:.3f}")
    print(f"[mesh-lm] the mesh phases: "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in MESH_LM_SECONDS.items())}")
    check(not failures, "dry run: " + "; ".join(failures))


# the port's examples and CI scripts, each run as a child process at its
# reference size (the dense example on the kernels' backend, its paper-size
# sparse run batched; the solver family at a fifth of its 10,000 steps a
# solve, whose logistic steps of ~330 launches would take ~160 s alone, and
# the quickstart at a fifth of its 50,000, which took ~100 s of the last
# turn's ~120 on an H100): the
# telemetry smoke first and alone, right after the build (its gates time a
# host-bound hot loop), then at the end the headline example alone and
# twelve together, the serve and train launchers and the serving, training,
# feature-selection and compressed data-parallel examples among them
# (none times a gate; their own seconds then share the card and the host);
# the outputs' directory is the call's own
# the serve launcher at deepseek-7b's full config (``python -m
# repro_torch.launch.serve``, as a script path)
SERVE_ENTRY = ("src/repro_torch/launch/serve.py",
               ["--arch", "deepseek_7b", "--batch", "4", "--prompt-len", "128", "--tokens", "32"])
# the train launcher at mamba2-130m's full config (``python -m
# repro_torch.launch.train``, as a script path)
TRAIN_ENTRY = ("src/repro_torch/launch/train.py",
               ["--arch", "mamba2_130m", "--steps", "5", "--ckpt-dir", "{out}/train"])
ENTRY_GATES = (  # run first, on a host no other phase has loaded yet
    (("scripts/torch_telemetry_smoke.py", ["--out-dir", "{out}/telemetry"]),),
)
ENTRY_RUNS = (
    (("examples/torch_lasso_fullpath_4m.py",
      ["--paper-size", "--backend", "sparse", "--driver", "batched"]),),
    (("examples/torch_solver_family.py", ["--max-iters", "2000"]),
     ("examples/torch_lasso_fullpath_4m.py", ["--backend", "kernels"]),
     ("examples/torch_quickstart.py", ["--max-iters", "10000"]),
     ("scripts/torch_solver_report.py", ["--out-dir", "{out}/report", "--distributed"]),
     ("scripts/torch_chaos_smoke.py", ["--out", "{out}/chaos_metrics.json"]),
     ("scripts/torch_profile_capture.py", ["--out", "{out}/profile"]),
     SERVE_ENTRY, ("examples/torch_serve_lm.py", []), TRAIN_ENTRY,
     ("examples/torch_train_lm.py", ["--ckpt-dir", "{out}/train_lm"]),
     ("examples/torch_fw_feature_selection.py", []), ("examples/torch_compressed_dp.py", [])),
)
ENTRY_TIMEOUT_S = 300
ENTRY_SECONDS = {}  # each entry point's seconds, for the summary
ENTRY_KEYS = ("PATH DONE", "total iters", "card:", "overhead", "PASS", "FAIL", "obj=",
              "chaos smoke", "profile_capture", "# wrote", "grid points", "advantage", "densest",
              "[serve]", "[train]", "[train_lm]", "[probe]", "[compressed_dp]")


def phase_entry_points(torch, runs=ENTRY_RUNS):
    """The port's examples and CI scripts (``runs``: ENTRY_GATES, then
    ENTRY_RUNS), each as a child process on the card (the kernels phase 1
    built, from ``build/``), a turn's children at once: a non-zero exit or
    a run past ENTRY_TIMEOUT_S fails the script; each run's seconds and the
    lines that carry its numbers printed."""
    import os
    import signal
    import tempfile

    # a CPU thread a child: the children's host work is launches, and a
    # turn's children share the host's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        for turn in runs:
            procs = []
            for path, args in turn:
                argv = [a.format(out=out) for a in args]
                log = open(os.path.join(out, f"{len(ENTRY_SECONDS) + len(procs)}.log"), "w+")
                procs.append((path, args, log, time.perf_counter(), subprocess.Popen(
                    [sys.executable, str(ROOT / path), *argv], cwd=str(ROOT), env=env,
                    stdout=log, stderr=subprocess.STDOUT, text=True, start_new_session=True)))
            ends = {}
            while len(ends) < len(procs):  # each child's seconds from its own end
                for n, (*_, t0, proc) in enumerate(procs):
                    if n not in ends and proc.poll() is not None:
                        ends[n] = time.perf_counter() - t0
                if time.perf_counter() - procs[0][3] > ENTRY_TIMEOUT_S:
                    for *_, other in procs:  # each child's session: its own children too
                        if other.poll() is None:
                            os.killpg(other.pid, signal.SIGKILL)
                    raise CheckFailed(f"{[p[0] for p in procs]}: past {ENTRY_TIMEOUT_S} s")
                time.sleep(0.2)
            for n, (path, args, log, t0, proc) in enumerate(procs):
                label = f"{path} {' '.join(args)}".strip()
                rc = proc.returncode
                ENTRY_SECONDS[label] = sec = ends[n]
                log.seek(0)
                text = log.read()
                log.close()
                for line in text.splitlines():
                    if any(k in line for k in ENTRY_KEYS):
                        print(f"[entry] {Path(path).name}: {line.strip()}")
                check(rc == 0, f"{label}: exit {rc}\n{text[-4000:]}")
                print(f"[entry] {label}: exit 0 in {sec:.1f} s")
    print(f"[entry] {sum(len(t) for t in runs)} entry points: "
          f"{time.perf_counter() - t_phase:.1f} s")


def mesh_rank(rank, workdir, world):
    """One rank of the "mesh, 4 ranks" phase (a spawned process on the one
    card; it loads the kernels phase 1 built and prints nothing): gloo over
    CUDA tensors, the proxy built from the same seed on every rank, and
    its results (rank 0 also the single-device runs) in a JSON file."""
    import hashlib
    import os

    import torch
    import torch.distributed as tdist

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "init"),
                             world_size=world, rank=rank)
    from repro_torch import distributed as D
    from repro_torch import kernels
    from repro_torch.core import (LASSO, LOGISTIC, ENOracle, FWConfig, LaneStreamSampler,
                                  StreamSampler, TorchSampler, engine)
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.data import make_sparse_wide_problem
    from repro_torch.resilience import guards

    dev = torch.device("cuda")
    out = {"rank": rank, "sec": {}}
    t0 = time.perf_counter()
    mat, y, _ = make_sparse_wide_problem(RANKS_M, RANKS_P, RANKS_DENSITY, 30, seed=3, device=dev,
                                         block_size=SPARSE_BLOCK)
    labels = torch.where(y >= 0, 1.0, -1.0)

    def digest(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()

    out["problem"] = digest(mat.values)
    kappa = kappa_fraction(RANKS_P, 0.01)
    cfg = FWConfig(delta=40.0, kappa=kappa, max_iters=RANKS_STEPS, tol=0.0, patience=10**9,
                   backend="sparse")
    one = rank == 0  # the single-device runs, on rank 0 only
    kernels.reset_launch_counts()
    op14 = D.shard_sparse(mat, y, D.fw_mesh(1, world))
    a = D.solve(LASSO, op14, cfg, TorchSampler(1, dev))
    out["14"] = {"digest": digest(a.alpha), "iters": a.iterations, "n_dots": a.n_dots}
    if one:
        b = engine.solve(LASSO, mat, y, cfg, TorchSampler(1, dev), device=dev)
        out["14"]["bits"] = bool(torch.equal(a.alpha, b.alpha)) and a.iterations == b.iterations
    out["sec"]["14"] = time.perf_counter() - t0

    op22 = D.shard_sparse(mat, y, D.fw_mesh(2, world // 2))
    fam = {}
    lcfg = dataclasses.replace(cfg, delta=20.0, max_iters=RANKS_LOG_STEPS)
    for name, orc, yy, c in (("lasso", LASSO, y, cfg), ("elasticnet", ENOracle(EN_L2), y, cfg),
                             ("logistic", LOGISTIC, labels, lcfg),
                             ("away", LASSO, y, dataclasses.replace(cfg, step_rule="away"))):
        opx = op22 if yy is y else D.shard_sparse(mat, yy, op22.mesh)
        r = D.solve(orc, opx, c, TorchSampler(2, dev))
        fam[name] = [float(r.objective), digest(r.alpha)]
        if one:
            s = engine.solve(orc, mat, yy, c, TorchSampler(2, dev), device=dev)
            fam[name].append(float(s.objective))
        if name == "lasso":
            res = guards.solve_resilient_sharded(LASSO, op22, c, TorchSampler(2, dev))
            out["guard_bits"] = bool(torch.equal(res.alpha, r.alpha))
    out["22"] = fam
    out["sec"]["22"] = time.perf_counter() - t0

    # lanes against sequential solves on the same rows, each lane's stream its own
    g = torch.Generator(device="cpu")
    g.manual_seed(4)
    streams = [torch.randint(0, RANKS_P, (RANKS_STEPS, kappa), generator=g).to(dev)
               for _ in range(MESH_LANES)]
    deltas = [10.0, 20.0, 40.0]
    bcfg = dataclasses.replace(cfg, max_iters=RANKS_STEPS // 2)
    res, _ = D.solve_batched(LASSO, op22, bcfg, LaneStreamSampler(streams), None, deltas)
    seq = [D.solve(LASSO, op22, bcfg, StreamSampler(s), None, d)
           for s, d in zip(streams, deltas)]
    out["lanes_bits"] = all(torch.equal(res.alpha[i], s.alpha) and res.iterations[i] ==
                            s.iterations for i, s in enumerate(seq))
    out["sec"]["lanes"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    tdist.barrier()
    tdist.destroy_process_group()


def phase3_mesh_ranks(torch):
    """Four processes on the one card over gloo with CUDA tensors (NCCL puts
    no two ranks on one card), each with the kernels on its tile of a sparse
    proxy (p = 262,144, m = 4,096, 1,024 blocks of 256): a (1, 4) lasso run
    bit for bit the single-device run; on (2, 2) the lasso, the elastic-net,
    the logistic and the away rule within rtol 1e-4 of their single-device
    runs, every rank holding the same alpha; the guarded solve with no
    fault bit for bit ``solve``; 3 batched lanes bit for bit 3 sequential
    mesh solves on the rows each drew. Returns the rank-0 launch counts."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    world = 4
    with tempfile.TemporaryDirectory() as work:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, work, world)) for r in range(world)]
        for pr in procs:
            pr.start()
        deadline = time.time() + RANKS_TIMEOUT_S
        for pr in procs:
            pr.join(max(1.0, deadline - time.time()))
        alive = [pr for pr in procs if pr.is_alive()]
        for pr in alive:
            pr.kill()
            pr.join()
        check(not alive, f"mesh ranks: {len(alive)} rank(s) still running after "
              f"{RANKS_TIMEOUT_S} s")
        check(all(pr.exitcode == 0 for pr in procs),
              f"mesh ranks: exit codes {[pr.exitcode for pr in procs]}")
        outs = [json.loads(Path(work, f"rank{r}.json").read_text()) for r in range(world)]
    r0 = outs[0]
    check(all(o["problem"] == r0["problem"] for o in outs), "mesh ranks built different problems")
    check(r0["14"]["bits"], "mesh ranks (1, 4): differs from the single-device run")
    check(all(o["14"]["digest"] == r0["14"]["digest"] for o in outs),
          "mesh ranks (1, 4): the ranks' alphas differ")
    for name, row in r0["22"].items():
        obj, dig, single = row
        check(all(o["22"][name][1] == dig for o in outs), f"mesh ranks (2, 2) {name}: ranks differ")
        check(abs(obj - single) <= 1e-4 * abs(single),
              f"mesh ranks (2, 2) {name}: objective {obj!r} vs single device {single!r}")
        print(f"[mesh-ranks] (2, 2) {name}: objective {obj!r}, single device {single!r} "
              f"(rel {abs(obj - single) / abs(single):.3e}), every rank's alpha equal")
    check(r0["guard_bits"], "mesh ranks: the guarded solve differs from solve")
    check(all(o["lanes_bits"] for o in outs), "mesh ranks: a lane differs from its sequential "
          "solve")
    print(f"[mesh-ranks] (1, 4): {r0['14']['iters']} steps bit for bit the single-device run; "
          "the no-fault guarded solve bit for bit solve; 3 lanes bit for bit their sequential "
          f"mesh solves; rank 0's seconds {r0['sec']}; rank 0's launches {r0['launches']}")
    MESH_SECONDS["4 ranks"] = time.perf_counter() - t0
    print(f"[mesh-ranks] phase took {MESH_SECONDS['4 ranks']:.1f} s")
    return r0["launches"]


if __name__ == "__main__":
    sys.exit(main())
