"""The lanes' support bitmap of the elastic-net's shifted lane argmax, on the
CPU.

On the card the shifted lane argmax (``vertex_argmax_shifted_lanes``) reads
``beta[idx]`` only where the lane's bitmap (``fw_grad.pack_support``) has
bit idx set, and takes ``|raw|`` where it is clear; then it sets the
winner's bit in place. These tests hold the pieces of that claim that the
CPU can reach:

- the bit-pack against numpy's ``packbits`` (p not a multiple of 32, -0.0,
  bf16, several lanes) and the winner's bit update;
- the skip rule itself, emulated in torch on the plain version's inputs:
  where the bitmap is a superset of beta's nonzeros and a lane's scale is
  finite, the emulation's winner, raw score and selected score (recomputed
  from beta at the winner) are the plain version's bits; a lane with an
  infinite or NaN scale reads beta everywhere;
- the invariant the batched engine relies on: through a plain elastic-net
  ``fw_path_batched`` (warm starts from chunk to chunk, renorms forced by
  ``renorm_threshold=0.5``) whose points match the JAX reference's, a
  bitmap built from each chunk's warm starts and updated at each step's
  winner covers every nonzero of beta after every step;
- the engine's plumbing: a batched loop started with a bitmap carries it
  through every step, and the CPU wrapper updates it as the kernel does.

Tolerances: the path's integer facts exact, objectives and l1 at rtol 1e-6
(``test_torch_batched.py``'s); every other comparison is bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ENOracle as RefEN
from repro.core import FWConfig as RefConfig
from repro.core import path as ref_path

from repro_torch import convert
from repro_torch.core import (LASSO, ENOracle, FWConfig, LaneStreamSampler, engine, path,
                              vertex)
from repro_torch.kernels import fw_grad as fw

KAPPA, L2, MAX_ITERS = 60, 1.0, 400


def _words(bits: np.ndarray) -> np.ndarray:
    """(L, n) bools to int32 words, bit i % 32 of word i // 32, padded with
    zero words to a multiple of 4 (16 bytes)."""
    L, n = bits.shape
    padded = np.zeros((L, -(-n // 128) * 128), dtype=bool)
    padded[:, :n] = bits
    return np.packbits(padded, axis=1, bitorder="little").view("<u4").view(np.int32)


def _numpy_pack(nonzero: np.ndarray) -> np.ndarray:
    """The two-level bitmap of (L, p) nonzero flags: the fine words, then the
    summary words (a bit for each 64 coefficients, set where any is)."""
    L, p = nonzero.shape
    groups = -(-p // 64)
    padded = np.zeros((L, groups * 64), dtype=bool)
    padded[:, :p] = nonzero
    return np.concatenate([_words(nonzero), _words(padded.reshape(L, groups, 64).any(-1))], 1)


def _unpack(support: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """(L, n) bools: bits 0..n of the words from word ``start``."""
    words = support[:, start:].contiguous()
    bits = (words.view(torch.uint8).view(words.shape[0], -1, 1)
            >> torch.arange(8, dtype=torch.uint8, device=words.device)) & 1
    return bits.reshape(words.shape[0], -1)[:, :n].bool()


def _covered(support: torch.Tensor, beta: torch.Tensor) -> bool:
    """Whether every nonzero of beta (L, p) has its fine and summary bits."""
    p = beta.shape[1]
    fine = _unpack(support, p)
    summary = _unpack(support, -(-p // 64), fw.support_fine_words(p))
    summary = summary.repeat_interleave(64, dim=1)[:, :p]
    return bool(torch.all((fine & summary) | (beta == 0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1, 31, 32, 33, 1000])
@pytest.mark.parametrize("L", [1, 4])
def test_pack_support_matches_numpy(L, p, dtype):
    rng = np.random.default_rng(p + L)
    beta = rng.standard_normal((L, p)).astype(np.float32)
    beta[np.abs(beta) < 0.9] = 0.0
    beta[:, ::7] = -0.0  # a zero of either sign clears its bit
    if p > 31:
        beta[:, 31] = 2.5  # the words' sign bit
    b = torch.from_numpy(beta).to(getattr(torch, dtype))
    got = fw.pack_support(b)
    assert got.dtype == torch.int32 and got.shape == (L, fw.support_words(p))
    np.testing.assert_array_equal(got.numpy(), _numpy_pack((b != 0).numpy()))
    assert _covered(got, b)


def test_mark_support_sets_only_real_winners():
    support = torch.zeros((4, fw.support_words(64)), dtype=torch.int32)
    fw.mark_support(support, torch.tensor([31, -1, 63, 64]), 64)  # frozen, masked skipped
    want = np.zeros((4, 64), dtype=bool)
    want[0, 31] = want[2, 63] = True
    np.testing.assert_array_equal(support.numpy(), _numpy_pack(want))
    fw.mark_support(support, torch.tensor([31, 0, 5, 40]), 64)  # a repeat keeps its bit
    want[1, 0] = want[2, 5] = want[3, 40] = True
    np.testing.assert_array_equal(support.numpy(), _numpy_pack(want))


def _emulated_kernel(scores, blk, bs, p_valid, lanes, shift):
    """The lane kernel's rule on the CPU: |raw| where a finite-scale lane's
    bit is clear, |sel| where it is set (or the lane's scale is not
    finite), masked indices -1; the first max; g_sel recomputed from beta
    at the winner (at p_valid - 1 when it is masked)."""
    L = scores.shape[0]
    i_star = torch.full((L,), -1, dtype=torch.int64)
    g_raw, g_sel = torch.zeros(L), torch.zeros(L)
    for lane in fw.lane_list(lanes):
        one = shift.lane(lane)
        idx = fw.block_indices(fw.lane_blk(blk, lane).long(), bs)
        clip = idx.clamp_max(p_valid - 1)
        sel = scores[lane] + one(clip)
        row = shift.support[lane]
        fine = (row.index_select(0, clip >> 5) >> (clip & 31)) & 1
        group = clip // 64
        summary = (row.index_select(0, fw.support_fine_words(p_valid) + (group >> 5))
                   >> (group & 31)) & 1
        bits = fine & summary
        use_map = bool(torch.isfinite(one.scale.float())) and np.isfinite(shift.l2)
        read = (bits == 1) | (not use_map)
        mag = torch.where(idx < p_valid, torch.where(read, sel.abs(), scores[lane].abs()), -1.0)
        j = int(torch.argmax(mag))
        i_star[lane] = idx[j]
        g_raw[lane] = scores[lane, j]
        g_sel[lane] = scores[lane, j] + one(clip[j:j + 1])[0]
    return i_star, g_raw, g_sel


CASES = ["exact", "superset", "minus zero", "scale inf", "scale nan", "raw zero",
         "all masked", "bf16 beta", "full"]


@pytest.mark.parametrize("case", CASES)
def test_skipping_clear_bits_keeps_the_plain_bits(case):
    """The bitmap rule gives the plain version's (i_star, g_raw, g_sel)
    bits: a bitmap exactly beta's support or a strict superset; beta's zeros
    -0.0; a lane of infinite or NaN scale (its zeros shift to NaN, which
    must win); raw scores all zero (the shift alone decides); every index
    masked; bf16 beta; 'full' sampling's shared ids in blocks of 32."""
    g = torch.Generator().manual_seed(CASES.index(case))
    L, p, n = 4, 300, 120
    bs = 32 if case in ("full", "all masked") else 1
    if case == "full":
        blk = torch.arange(-(-p // bs))  # the last block runs past p
        n = blk.numel() * bs
    elif case == "all masked":
        blk, n = torch.tensor([9, 9]), 64  # indices 288..319, every one past p = 288
        p = 288
    else:
        blk = torch.randint(0, p, (L, n), generator=g)
    beta = torch.zeros((L, p))
    nz = torch.randint(0, p, (L, 40), generator=g)
    beta.scatter_(1, nz, torch.randn((L, 40), generator=g) * 3)
    if case == "minus zero":
        beta[beta == 0] = -0.0
    scores = torch.randn((L, n), generator=g)
    if case == "raw zero":
        scores.zero_()
    scale = torch.rand(L, generator=g) + 0.5
    if case == "scale inf":
        scale[1] = float("inf")
    if case == "scale nan":
        scale[2] = float("nan")
    if case == "bf16 beta":
        beta = beta.bfloat16()
        scale = scale.bfloat16()
    support = fw.pack_support(beta)
    if case == "superset":
        support |= fw.pack_support(torch.rand((L, p), generator=g) < 0.3)
    shift = fw.ScoreShift(beta, scale, L2, support)
    lanes = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    want = fw.argmax_shifted_lanes_plain(scores, blk, bs, p, lanes, shift)
    got = _emulated_kernel(scores, blk, bs, p, lanes, shift)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), case
    if case in ("scale inf", "scale nan"):
        assert torch.isnan(want[2][1 if case == "scale inf" else 2])


def test_cpu_wrapper_sets_the_winners_bits():
    """On CPU tensors the lane wrapper is the plain version, then the
    kernel's in-place update of the bitmap: the winners' bits, a frozen
    lane's untouched."""
    g = torch.Generator().manual_seed(3)
    L, p, n = 3, 200, 50
    scores, blk = torch.randn((L, n), generator=g), torch.randint(0, p, (L, n), generator=g)
    beta = torch.zeros((L, p))
    shift = fw.ScoreShift(beta, torch.ones(L), L2, fw.pack_support(beta))
    lanes = torch.tensor([0, 2], dtype=torch.int32)
    i_star, _, _ = fw.vertex_argmax_shifted_lanes(scores, blk, 1, p, lanes, shift)
    want = np.zeros((L, p), dtype=bool)
    want[0, int(i_star[0])] = want[2, int(i_star[2])] = True
    assert int(i_star[1]) == -1
    np.testing.assert_array_equal(shift.support.numpy(), _numpy_pack(want))


def test_lane_support_only_for_a_shift_on_the_card():
    """The engine builds the bitmap only for an oracle with a score shift
    whose lanes run on the card's kernels; CPU lanes and the lasso get
    none."""
    cfg = FWConfig(delta=1.0, backend="kernels")
    state = engine.EngineState(beta=torch.zeros((2, 10)), scale=torch.ones(2), co=(),
                               maxabs=None, step_inf=None, stall=None, n_dots=[0, 0], k=[0, 0],
                               i_star=torch.full((2,), -1))
    Xt = torch.zeros((10, 3))
    for oracle in (ENOracle(l2=L2), LASSO):
        assert vertex.lane_support(Xt, cfg, oracle.score_extra(state.beta, state.scale)) is None
    assert state.support is None


def _lane_streams(n_chunks, lane_width, p):
    """The reference fw_path_batched's per-lane streams, chunk by chunk."""
    with jax.threefry_partitionable(False):
        def draw(key):
            def body(k, _):
                k, sub = jax.random.split(k)
                return k, jax.random.randint(sub, (KAPPA,), 0, p)

            return np.asarray(jax.lax.scan(body, key, None, length=MAX_ITERS)[1])

        key, chunks = jax.random.PRNGKey(0), []
        for _ in range(n_chunks):
            key, *subs = jax.random.split(key, lane_width + 1)
            chunks.append([draw(s) for s in subs])
    return chunks


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    return np.ascontiguousarray(ds.X.T), ds.y


@pytest.mark.parametrize("backend,ref_backend", [("kernels", "pallas"), ("sparse", "sparse")])
def test_bitmap_covers_beta_through_en_lanes(prob, backend, ref_backend):
    """A plain elastic-net path in lanes of 4 (the second chunk warm-started
    from the first's densest point, renorms forced by renorm_threshold=0.5):
    its points are the reference's, and a bitmap packed from each chunk's
    warm starts, with each step's winners' bits set, covers every nonzero
    of beta after every step."""
    from repro.sparse import SparseBlockMatrix as RefMatrix

    Xt, y = prob
    if backend == "sparse":
        ref_mat = RefMatrix.from_dense(Xt, block_size=64)
        ref_design = ref_mat
        design = convert.sparse_from_reference(
            np.asarray(ref_mat.values), np.asarray(ref_mat.rows), ref_mat.p, ref_mat.m,
            ref_mat.block_size, ref_mat.nnz_max, "cpu")
    else:
        ref_design, design = jnp.asarray(Xt), torch.from_numpy(Xt)
    p = Xt.shape[0]
    deltas = np.geomspace(3.0, 30.0, 8)
    kw = dict(delta=1.0, sampling="uniform", kappa=KAPPA, max_iters=MAX_ITERS, tol=1e-5,
              renorm_threshold=0.5)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path_batched(ref_design, jnp.asarray(y), deltas,
                                       RefConfig(backend=ref_backend, **kw), seed=0, lane_width=4,
                                       oracle=RefEN(l2=L2))
    streams = _lane_streams(2, 4, p)
    seen = dict(steps=0, renorms=0, warm=0, bits=0, nonzeros=0)

    def solve_checked(oracle, X, yy, cfg, sampler, alpha0s, d_arr):
        support = fw.pack_support(alpha0s)
        seen["warm"] += int(torch.count_nonzero(alpha0s))
        last_scale = torch.ones(alpha0s.shape[0])

        def on_step(state, active):
            fw.mark_support(support, state.i_star, p)
            assert _covered(support, state.beta), f"step {seen['steps']}"
            act = torch.tensor(active)
            seen["renorms"] += int(torch.sum(act & (state.scale == 1.0) & (last_scale < 1.0)))
            last_scale.copy_(state.scale)
            seen["steps"] += 1

        out = engine.solve_batched_prepared(oracle, X, yy, cfg, sampler, alpha0s, d_arr,
                                            on_step=on_step)
        fine = support[:, :fw.support_fine_words(p)].reshape(-1).tolist()
        seen["bits"] += sum(bin(w & 0xFFFFFFFF).count("1") for w in fine)
        seen["nonzeros"] += int(torch.count_nonzero(out[0].alpha))
        return out

    res = path.fw_path_batched(
        design, torch.from_numpy(y), deltas, FWConfig(backend=backend, **kw), lane_width=4,
        oracle=ENOracle(l2=L2), device="cpu", solve_batched_fn=solve_checked,
        lane_sampler_fn=lambda c: convert.lane_streams_from_reference(streams[c], "cpu"))
    assert seen["steps"] > 0 and seen["renorms"] > 0 and seen["warm"] > 0
    assert seen["bits"] >= seen["nonzeros"] > 0
    for got, want in zip(res.points, ref.points):
        assert (got.iterations, got.n_dots, got.active) == (
            want.iterations, want.n_dots, want.active)
        np.testing.assert_array_equal(got.alpha_nnz_idx, want.alpha_nnz_idx)
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
        np.testing.assert_allclose(got.l1, want.l1, rtol=1e-6)


def test_batched_loop_carries_the_bitmap(prob):
    """A batched EN loop on the kernels' backend started with a bitmap (the
    CPU wrapper updates it as the kernel does): every batched step's state
    carries the same tensor, and it covers beta at every step; a lane's
    warm start with -0.0 entries packs no bit for them."""
    Xt, y = prob
    X, yt = torch.from_numpy(Xt), torch.from_numpy(y)
    p = Xt.shape[0]
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=60, tol=0.0, patience=10**9,
                   renorm_threshold=0.5, backend="kernels")
    rng = np.random.default_rng(4)
    alpha0s = torch.zeros((3, p))
    alpha0s[1, rng.choice(p, 5, replace=False)] = torch.randn(5, dtype=torch.float32)
    alpha0s[2, :10] = -0.0
    states0 = engine.stack_states([engine.init_state(ENOracle(l2=L2), X, yt, alpha0s[l], cfg)
                                   for l in range(3)])
    support = fw.pack_support(states0.beta)
    assert int(torch.count_nonzero(support[2])) == 0
    states0 = states0._replace(support=support)
    stats = engine.precompute_colstats(X, yt, cfg)
    draws = [torch.from_numpy(rng.integers(0, p, (60, KAPPA))) for _ in range(3)]

    steps = []

    def on_step(state, active):
        assert state.support is support
        assert _covered(support, state.beta)
        steps.append(state.i_star.clone())

    final, _ = engine.batched_loop(ENOracle(l2=L2), X, yt, stats, states0, cfg,
                                   torch.tensor([2.0, 10.0, 30.0]), 10**9,
                                   LaneStreamSampler(draws), on_step=on_step)
    assert len(steps) == 60 and final.support is support and _covered(support, final.beta)
    want = fw.pack_support(alpha0s)  # the warm starts' bits ...
    for i_star in steps:  # ... and every winner's
        fw.mark_support(want, i_star, p)
    assert torch.equal(support, want)
