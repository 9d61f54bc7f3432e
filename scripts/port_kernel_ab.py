#!/usr/bin/env python3
"""Time kernels of the PyTorch port on one CUDA card, for the
``repro_torch`` package found under ``--src``:

- K2's ``vertex_argmax`` at kappa = 1% of p (uniform sampling) and at
  n = p (the 'full' sampling of a paper-size dense point, blocks of 128);
- K6's ``sparse_colstats`` over the E2006-log1p proxy at its published
  size with the L2 flushed, beside cuSPARSE's CSR SpMV on a copy;
- K5's ``sparse_sampled_scores`` on that proxy at width 1 (kappa = 1% of
  p) and width 256 (166 blocks), on 32 index sets drawn as phase 5 draws
  them, with sha256 digests of the scores on ``chip_smoke.k5_digest_inputs``;
- K7's ``sparse_fused_chunk`` per chunk of K = 8 steps on that proxy, on
  four index sets drawn as ``chip_smoke.py``'s phase 5 draws them;
- the unfused step (``fuse_steps = 1``): host-clock ms per iteration of a
  fixed run of 300 steps, on the proxy ('sparse') and at the paper's dense
  size ('kernels');
- the ``fused_replay`` of 8 fixed records over p = 4,272,227
  coefficients: without a renorm and with distinct coordinates; and with
  a renorm at the first record and a coordinate that wins 3 times;
- K4's ``dense_fused_chunk`` per chunk of K = 8 steps at the paper's
  dense size (p = 4,272,227, m = 800), as phase 5 draws it;
- the one-lane launches that the batched lanes share their kernels with:
  K2's ``sampled_scores`` at the paper's dense size (kappa = 1% of p,
  width 1), the argmax above, and the step's ``step_tail`` on both
  layouts (no renorm), beside K5 above, each tail also in its
  elastic-net instantiation (``step_tail_en``) on the same state;
- the lasso's lane launches of the argmax and the tail at 13 lanes, at the
  paper's dense size (kappa = 1% of p a lane; m = 800, no renorm).

The argmax, the tail, K4 and K7 also have elastic-net instantiations (the
score shift, the EN line search, the alpha ledger); every launch timed
here is the lasso's, whose bits and time those must leave alone, but the
EN tail's, which shares its source with the tail (and with the step
rules' direction tail).

For K2's scores, the argmax, the tail, K5, K7, the replay, K4 and the lane
argmax and tail it also
prints a sha256 digest of every output byte (records, final residual and
(S, F, Q); or beta and the statistics), so two versions that agree bit for
bit print the same digests. The
timing helpers are ``chip_smoke.py``'s.

To compare two versions on one card, run it once per checkout in one
command, in turns (A, B, B, A), each in its own process:

    python3 scripts/port_kernel_ab.py --src src --tag change
    python3 scripts/port_kernel_ab.py --src /path/to/other/checkout/src --tag parent

Prints the card's name and power limit, then one JSON line: the tag and,
per kernel, its ms, plain ms, library ms, bound ms, bound's kind and
(where taken) digest. Needs a card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def digest(outs) -> str:
    """sha256 of the bytes of every tensor in ``outs`` (nested tuples)."""
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, (tuple, list)):
            for v in x:
                add(v)
        else:
            h.update(x.detach().reshape(-1).cpu().numpy().tobytes())

    add(outs)
    return h.hexdigest()


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
    from repro_torch.core import FWConfig, engine
    from repro_torch.core.sampling import kappa_fraction
    from repro_torch.core.vertex import TorchSampler
    from repro_torch.data import PROXY_SPECS, make_sparse_wide_problem, make_wide_problem
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import fw_grad as fw
    from repro_torch.kernels import sparse_colstats as sc
    from repro_torch.kernels import sparse_grad as sg
    from repro_torch.kernels import step_tail as st

    card = cs.card_line()
    _build.build()
    dev = torch.device("cuda")
    out = {"tag": args.tag, "src": str(Path(fw.__file__).resolve().parents[2])}

    def record(name, t, note):
        bound_ms, bound_by = cs._bound(t["nbytes"], t["flops"])
        out[name] = dict(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t.get("library_ms"),
                         bound_ms=bound_ms, bound_by=bound_by)
        if "digest" in t:
            out[name]["digest"] = t["digest"]
        print(f"[{args.tag}] {name}: {t['ms']:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
              f"plain {t['plain_ms']:.6f} ms, library {t.get('library_ms')}"
              f"{', sha256 ' + t['digest'][:16] if 'digest' in t else ''}{note}")

    p = cs.P_PAPER
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    kappa = kappa_fraction(p, 0.01)
    idx = TorchSampler(11, dev).uniform(kappa, p)
    scores = torch.randn(kappa, generator=g, device=dev)
    t = cs.vertex_argmax_times(torch, fw, scores, idx, 1, p)
    t["digest"] = digest(fw.vertex_argmax(scores, idx, 1, p))
    record("vertex_argmax_kappa", t, f" [n = kappa = {kappa}, width 1]")
    bs = 128
    blk = torch.arange(-(-p // bs), device=dev)
    scores = torch.randn(blk.numel() * bs, generator=g, device=dev)
    record("vertex_argmax_full", cs.vertex_argmax_times(torch, fw, scores, blk, bs, p, reps=200),
           f" [n = {scores.numel()}, {blk.numel()} blocks of {bs}, p_valid = {p}]")
    del scores

    # ---- the replay: 8 fixed records over p coefficients ----------------------
    cfg = FWConfig(delta=50.0, max_iters=10**6)
    K = cs.FUSE
    beta0 = torch.randn(p, generator=g, device=dev)
    cases = {}
    i_stars = torch.randint(0, p, (K,), generator=g, device=dev)
    cases["fused_replay"] = (i_stars, torch.linspace(0.05, 0.4, K, device=dev),
                             torch.tensor(1.0, device=dev), "no renorm, distinct coordinates")
    rep = i_stars.clone()
    rep[2] = rep[5] = rep[7] = rep[0]
    lams = torch.linspace(0.05, 0.4, K, device=dev)
    lams[0] = 0.75  # 3e-6 * 0.25 < renorm_threshold 1e-6: a renorm at the first record
    cases["fused_replay_renorm"] = (rep, lams, torch.tensor(3e-6, device=dev),
                                    "a renorm at the first record, one coordinate 4 times")
    dts = torch.where(torch.rand(K, generator=g, device=dev) < 0.5, -50.0, 50.0)
    nps = torch.rand(K, generator=g, device=dev) < 0.3
    zero, zero_i = torch.zeros((), device=dev), torch.zeros((), dtype=torch.int32, device=dev)
    for name, (ist, lm, scale, what) in cases.items():
        beta = beta0.clone()

        def replay(i, fn=fs.fused_replay):
            return fn(beta, scale, zero, zero, zero_i, ist, lm, dts, nps, 0, cfg)

        first = fs.fused_replay(beta0.clone(), scale, zero, zero, zero_i, ist, lm, dts, nps, 0,
                                cfg)
        t = dict(ms=cs._time_queued(torch, replay, 200),
                 # ~25 launches a record: 4 calls stay under the ~1000-entry launch queue
                 plain_ms=cs._time_queued(torch, lambda i: replay(i, fs.fused_replay_plain), 4),
                 nbytes=K * (8 + 4 + 4 + 1 + 4 + 4) + 4 * 4 + 4 * 4, flops=K * 12,
                 digest=digest(first))
        record(name, t, f" [K={K} records, p={p}: {what}]")
        del beta
    del beta0

    def tail_times(name, mat, p, m, nbytes, note):
        """The step's tail, one lane, from chip_smoke's fixed state."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        tcfg = FWConfig(delta=5.0)
        beta, targs = cs._tail_args(torch, gen, p, m, torch.float32, int(idx[0]))
        first = st.step_tail(mat, beta.clone(), *targs, tcfg)
        t = dict(ms=cs._time_queued(torch, lambda i: st.step_tail(mat, beta, *targs, tcfg), 400),
                 # ~75 launches a call: 10 calls keep the queue under its ~1000 entries
                 plain_ms=cs._time_queued(torch, lambda i: st.step_tail_plain(
                     mat, beta, *targs, tcfg), 10),
                 nbytes=nbytes, flops=5 * m, digest=digest(first))
        record(name, t, note)
        # the elastic-net's instantiation on the same state (l2 = 1, Q = 2,
        # the selected score the linear one plus 0.25)
        en = st.ENTail(targs[10].float() + 0.25, torch.tensor(2.0, device=dev), 1.0)
        first = st.step_tail_en(mat, beta.clone(), *targs, tcfg, en)
        t = dict(ms=cs._time_queued(torch, lambda i: st.step_tail_en(mat, beta, *targs, tcfg, en),
                                    400),
                 plain_ms=cs._time_queued(torch, lambda i: st.step_tail_plain(
                     mat, beta, *targs, tcfg, en), 10),
                 nbytes=nbytes + 8, flops=7 * m, digest=digest(first))
        record(f"{name}_en", t, note)

    # ---- K6 and K7 on the E2006-log1p proxy -----------------------------------
    spec = PROXY_SPECS["e2006-log1p"]
    mat, y, _ = make_sparse_wide_problem(spec.m, spec.p, spec.col_density, spec.n_relevant,
                                         seed=0, device=dev, block_size=cs.SPARSE_BLOCK)
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    t = cs.sparse_colstats_times(torch, sc, mat, y, flush)
    record("sparse_colstats", t, t["note"])
    del flush

    nnz = mat.nnz_max
    slots = mat.values.view(-1, nnz)
    sampler = TorchSampler(11, dev)
    nb = kappa // cs.SPARSE_BLOCK
    sets = {1: [sampler.uniform(kappa, p) for _ in range(32)],
            cs.SPARSE_BLOCK: [torch.randperm(mat.nblocks, generator=sampler.generator,
                                             device=dev)[:nb] for _ in range(32)]}
    digests = cs.k5_digests(torch, sg, mat, y)
    for bs, ids in sets.items():
        n = ids[0].numel() * bs
        feats = [(b.long()[:, None] * bs + torch.arange(bs, device=dev)).reshape(-1) for b in ids]
        nz = sum(int(torch.count_nonzero(slots[f])) for f in feats) / len(feats)
        t = dict(ms=cs._time_queued(torch, lambda i: sg.sparse_sampled_scores(
                     mat.values, mat.rows, y, ids[i % 32], bs), 200),
                 plain_ms=cs._time_queued(torch, lambda i: sg.sparse_sampled_scores_plain(
                     mat.values, mat.rows, y, ids[i % 32], bs), 50),
                 nbytes=n * nnz * 4 + nz * 4 + n * 4 + ids[0].numel() * 8 + mat.m * 4,
                 flops=2 * nz, digest=digests[bs])
        record(f"sparse_sampled_scores_w{bs}", t, f" [width {bs}, n={n}, nnz_max={nnz}]")
    tail_times("step_tail_sparse", (mat.values, mat.rows), p, mat.m,
               3 * mat.m * 4 + nnz * 8 + 64, f" [sparse, m={mat.m}, nnz_max={nnz}, no renorm]")
    delta = torch.tensor(50.0, device=dev)
    ucfg = cs.sparse_config(p, fuse_steps=1)
    out["sparse_unfused_step_wall_ms"] = cs.unfused_step_wall_ms(
        torch, mat, y, engine.precompute_colstats(mat, y, ucfg), ucfg, delta)
    print(f"[{args.tag}] sparse unfused step: {out['sparse_unfused_step_wall_ms']:.4f} ms "
          "wall per iteration (300 steps)")

    def chunk_times(name, fn, plain, head, mat_y, stats, sampler, m, step_bytes, step_flops,
                    note):
        chunks = []
        for _ in range(4):
            ix = sampler.uniform_chunk(K, kappa, p)
            chunks.append((ix, stats.zty[ix], stats.znorm2[ix]))
        kw = cs._fused_kw(10**6)
        delta = torch.tensor(50.0, device=dev)

        def chunk(i, f=fn):
            ix, zty_s, zn2_s = chunks[i % 4]
            return f(*head, mat_y, mat_y, (zero, zero, zero), ix, zty_s, zn2_s, 0, delta, **kw)

        outs = [chunk(i) for i in range(4)]
        t = dict(ms=cs._time_queued(torch, chunk, 20),
                 plain_ms=cs._time_queued(torch, lambda i: chunk(i, plain), 2),
                 nbytes=K * step_bytes(chunks), flops=K * step_flops(chunks),
                 digest=digest(outs))
        record(name, t, note)
        print(f"[{args.tag}] {name} per step: {t['ms'] / K:.6f} ms")

    def stored(chunks):  # mean stored nonzeros a step over the index sets
        return sum(int(torch.count_nonzero(slots[ix.reshape(-1)])) for ix, _, _ in chunks) / (
            len(chunks) * K)

    stats = engine.precompute_colstats(mat, y, cs.sparse_config(p, fuse_steps=1))
    chunk_times("sparse_fused_chunk", fs.sparse_fused_chunk, fs.sparse_fused_chunk_plain,
                (mat.values, mat.rows), y, stats, TorchSampler(11, dev), mat.m,
                lambda c: kappa * nnz * 4 + stored(c) * 4 + kappa * 16 + 3 * mat.m * 4,
                lambda c: 2 * stored(c),
                f" [one chunk of K={K} steps, kappa={kappa}, nnz_max={nnz}, m={mat.m}]")
    del mat, y, stats, slots

    # ---- K4 at the paper's dense size -------------------------------------------
    Xt, y, _ = make_wide_problem(p, cs.M_PAPER, cs.N_REL, seed=0, device=dev)
    m = cs.M_PAPER
    idxs = [TorchSampler(11, dev).uniform(kappa, p)] + [
        TorchSampler(12 + k, dev).uniform(kappa, p) for k in range(31)]  # 32 sets >> L2
    r = y.clone()
    t = dict(ms=cs._time_queued(torch, lambda i: fw.sampled_scores(Xt, r, idxs[i % 32], 1), 200),
             plain_ms=cs._time_queued(torch, lambda i: fw.sampled_scores_plain(
                 Xt, r, idxs[i % 32], 1), 50),
             library_ms=cs._time_queued(torch, lambda i: torch.mv(
                 Xt.index_select(0, idxs[i % 32]), r), 50),
             nbytes=kappa * m * 4 + m * 4 + kappa * 12, flops=2 * kappa * m,
             digest=digest(fw.sampled_scores(Xt, r, idxs[0], 1)))
    record("sampled_scores", t, f" [kappa={kappa}, m={m}, width 1; library: torch.mv on "
                                "Xt.index_select]")
    tail_times("step_tail_dense", Xt, p, m, 4 * m * 4 + 64, f" [dense, m={m}, no renorm]")

    # ---- the lasso's lane argmax and lane tail, 13 lanes ------------------------
    L = cs.LANE_WIDTH
    ids = torch.arange(L, dtype=torch.int32, device=dev)
    lblk = torch.stack([TorchSampler(50 + k, dev).uniform(kappa, p) for k in range(L)])
    lscores = fw.sampled_scores_lanes(Xt, y.float().expand(L, m).contiguous(), lblk, 1, ids)
    t = dict(ms=cs._time_queued(torch, lambda i: fw.vertex_argmax_lanes(lscores, lblk, 1, p, ids),
                                400),
             plain_ms=cs._time_queued(torch, lambda i: fw.argmax_lanes_plain(lscores, lblk, 1, p,
                                                                             ids), 5),
             nbytes=L * (kappa * 12 + 12), flops=3 * L * kappa,
             digest=digest(fw.vertex_argmax_lanes(lscores, lblk, 1, p, ids)))
    record("vertex_argmax_lanes", t, f" [{L} lanes, n = kappa = {kappa} a lane]")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    lbeta, largs = cs._lane_tail_state(torch, gen, p, m, torch.float32, L)
    largs = (torch.full((L,), 0.9, device=dev),) + largs[1:]  # no renorm
    tcfg = FWConfig(delta=20.0)
    first = digest(st.step_tail_lanes(Xt, lbeta.clone(), *largs, ids, tcfg))
    t = dict(ms=cs._time_queued(torch, lambda i: st.step_tail_lanes(Xt, lbeta, *largs, ids, tcfg),
                                400),
             # ~75 launches a lane: one call of 13 lanes fills the launch queue
             plain_ms=cs._time_queued(torch, lambda i: st.step_tail_lanes_plain(
                 Xt, lbeta, *largs, ids, tcfg), 1),
             nbytes=L * (4 * m * 4 + 64), flops=5 * L * m, digest=first)
    record("step_tail_lanes_dense", t, f" [{L} lanes, m={m}, no renorm]")
    del lbeta, largs, lscores
    stats = engine.precompute_colstats(Xt, y, cs.main_config(p, "kernels"))
    chunk_times("dense_fused_chunk", fs.dense_fused_chunk, fs.dense_fused_chunk_plain, (Xt,), y,
                stats, TorchSampler(11, dev), m,
                lambda c: kappa * m * 4 + kappa * 16 + 3 * m * 4, lambda c: 2 * kappa * m,
                f" [one chunk of K={K} steps, kappa={kappa}, m={m}]")
    dcfg = cs.main_config(p, "kernels")
    out["dense_unfused_step_wall_ms"] = cs.unfused_step_wall_ms(
        torch, Xt, y, stats, dcfg, torch.tensor(50.0, device=dev))
    print(f"[{args.tag}] dense unfused step: {out['dense_unfused_step_wall_ms']:.4f} ms wall "
          "per iteration (300 steps)")
    del Xt
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
