"""The screened CD sweep's plain version (``kernels/cd_sweep``: the score
pass's headroom, the walk, the re-bases) against the unscreened plain loop
on the CPU, bit for bit (alpha up to a zero's sign, R and max |d|
bitwise), where the screen is most likely to be wrong: rows whose |z_j . R|
lies within a few ulps of lam, or within the screen's own margin of it,
before and after earlier moves. The card's versions of these checks are in
``chip_smoke.py`` (phase 2) and ``tests/test_torch_gpu.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st  # skips @given tests when hypothesis is missing
from repro_torch.kernels import cd_sweep as cdk
from repro_torch.kernels.colstats import colstats

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card's near-tie cases, run here on the CPU)


def _same(a, b):
    """alpha equal (a zero's sign aside), R and max |d| bit for bit."""
    (a1, r1, m1), (a2, r2, m2) = a, b
    return (torch.equal(a1, a2) and torch.equal(r1.view(torch.int32), r2.view(torch.int32))
            and torch.equal(m1.view(torch.int32), m2.view(torch.int32)))


def _both(X, zn2, alpha0, R0, lam, order, rebase_after=None):
    a1, r1 = alpha0.clone(), R0.clone()
    m1 = cdk.cd_sweep_plain(X, a1, r1, zn2, lam, order)
    cdk.STATS.reset()
    a2, r2 = alpha0.clone(), R0.clone()
    m2 = cdk.cd_sweep_screened_plain(X, a2, r2, zn2, lam, order, rebase_after=rebase_after)
    return (a1, r1, m1), (a2, r2, m2), cdk.STATS.snapshot()


def _boundary_case(seed, m, p, dtype, stochastic):
    """Rows around the screen's boundary: movers (rows 10-14, far above lam)
    and general rows (15-29) on the first half of the coordinates, the other
    rows on the second half (exactly orthogonal to every move of the first),
    each scaled in f64 so that z_j . y = +-lam (1 - eps_j), eps_j of either
    sign with |eps_j| log-uniform on [1e-9, 3e-2]: some a hair above lam,
    some just inside the screen's margin, some well inside it."""
    rng = np.random.default_rng(seed)
    h = m // 2
    X = rng.standard_normal((p, m))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    first = np.zeros(p, bool)
    first[10:30] = True
    X[first, h:] = 0.0
    X[~first, :h] = 0.0
    y = 0.1 * rng.standard_normal(m)
    y[:h] += 3.0 * X[10:15, :h].sum(0)
    lam = float(np.float32(0.3 * np.abs(X[10:15] @ y).max()))
    ties = np.flatnonzero(~first)
    eps = rng.choice([-1.0, 1.0], ties.size) * 10.0 ** rng.uniform(-9, np.log10(3e-2), ties.size)
    sign = rng.choice([-1.0, 1.0], ties.size)
    X[ties] *= (sign * lam * (1 - eps) / (X[ties] @ y))[:, None]
    Xt = torch.from_numpy(X.astype(np.float32)).to(dtype)
    Y = torch.from_numpy(y.astype(np.float32))
    order = None
    if stochastic:  # the tie rows again after the movers, a repeat back to back
        o = rng.integers(0, p, p)
        o[:30] = np.arange(30)
        o[30:30 + 20] = ties[:20]
        o[31] = o[30]
        order = torch.from_numpy(o)
    return Xt, Y, lam, order


@given(seed=st.integers(0, 2**31 - 1), m=st.sampled_from([16, 74, 130]),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]), stochastic=st.booleans())
@settings(max_examples=60, deadline=None)
def test_screen_never_skips_a_row_that_moves(seed, m, dtype, stochastic):
    """Pins rho: the screened sweep equals the unscreened loop bit for bit
    around the screen's boundary, with the cost model's re-bases and one
    after every idle survivor; the score pass's headroom is safe for the
    chain's dot in any summation order (every row it would skip at B = 0 has
    |z_j . R| <= lam summed forwards, backwards and pairwise in f32)."""
    p = 120
    X, Y, lam, order = _boundary_case(seed, m, p, dtype, stochastic)
    _, zn2 = colstats(X, Y)
    alpha0 = torch.zeros(p)
    skipped = 0
    for limit in (None, 1):
        want, got, stats = _both(X, zn2, alpha0, Y, lam, order, limit)
        assert _same(want, got), (seed, m, dtype, stochastic, limit)
        skipped += stats["positions"] - stats["survivors"]
    assert skipped > 0  # the screen did skip rows (the test is not vacuous)
    head, _, _, _ = cdk.cd_score_plain(X, Y, zn2, torch.zeros(p), lam)
    Xf = X.float().numpy()
    y32 = Y.numpy()
    for j in np.flatnonzero(head.numpy() >= 0.0):
        prods = (Xf[j] * y32).astype(np.float32)
        fwd = np.float32(0)
        for v in prods:
            fwd = np.float32(fwd + v)
        bwd = np.float32(0)
        for v in prods[::-1]:
            bwd = np.float32(bwd + v)
        for dot in (fwd, bwd, np.sum(prods, dtype=np.float32), torch.dot(X[j].float(), Y)):
            assert abs(float(dot)) <= lam, (j, float(dot), lam)


@pytest.mark.parametrize("m", [74, 800])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stochastic", [False, True])
def test_card_tie_cases_on_the_cpu(m, dtype, stochastic):
    """``chip_smoke._cd_tie_case`` (phase 2's near-ties, |z_j . R| within
    ulps of lam before and after the moves) through the plain versions: the
    screened sweep bit for bit the unscreened loop."""
    g = torch.Generator()
    g.manual_seed(m + (7 if stochastic else 0))
    X, zn2, alpha0, R0, lam, order, _ = chip_smoke._cd_tie_case(
        torch, g, torch.device("cpu"), m, 200, dtype, stochastic)
    for limit in (None, 1):
        want, got, stats = _both(X, zn2, alpha0, R0, lam, order, limit)
        assert _same(want, got)
        assert stats["survivors"] < stats["positions"]


@pytest.mark.parametrize("stochastic", [False, True])
def test_forced_rebases_give_the_same_bits_sweep_after_sweep(stochastic):
    """Ten sweeps of a solve, each re-based after 1, 3 or the cost model's
    idle survivors, or never: every sweep's alpha, R and max |d| the same
    (zeros' signs aside), and the re-bases counted (walks = sweeps +
    re-bases)."""
    rng = np.random.default_rng(11)
    p, m = 300, 40
    X = torch.from_numpy(rng.standard_normal((p, m)).astype(np.float32))
    Y = torch.from_numpy((X[:8].sum(0).numpy() * 2 + rng.standard_normal(m)).astype(np.float32))
    _, zn2 = colstats(X, Y)
    lam = float((X @ Y).abs().max()) / 8
    orders = [torch.from_numpy(rng.integers(0, p, p)) if stochastic else None for _ in range(10)]
    runs = {}
    for limit in (1, 3, None, 0):
        alpha, R = torch.zeros(p), Y.clone()
        cdk.STATS.reset()
        out = []
        for o in orders:
            md = cdk.cd_sweep(X, alpha, R, zn2, lam, o, rebase_after=limit)
            out.append((alpha.clone(), R.clone(), md))
        st_ = cdk.STATS.snapshot()
        assert st_["sweeps"] == 10 and st_["walks"] == 10 + st_["rebases"]
        if limit == 0:
            assert st_["rebases"] == 0
        if limit == 1:
            assert st_["rebases"] > 0
        runs[limit] = out
    for limit in (3, None, 0):
        assert all(_same(a, b) for a, b in zip(runs[1], runs[limit]))


def test_rebase_threshold_follows_the_score_pass_cost():
    """The cost model: at least 16 idle survivors, more as the score pass's
    bytes grow (Pyrim's shape, then the paper's dense width)."""
    small = cdk.rebase_threshold(201_376, 74)
    big = cdk.rebase_threshold(4_272_227, 800)
    assert 16 <= small < big
    assert 16 <= cdk.rebase_threshold(10, 10) <= small
    assert cdk.rebase_threshold(4_272_227, 800, torch.bfloat16) < big


def test_score_plain_flags_what_may_not_be_skipped():
    """A non-finite zn2 makes the row's headroom NaN (it always runs), a row
    with a_j != 0 makes its chunk's least headroom -inf, lam = 0 leaves no
    headroom, and the norm bound is at least the row's norm."""
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((600, 30)).astype(np.float32))
    Y = torch.from_numpy(rng.standard_normal(30).astype(np.float32))
    _, zn2 = colstats(X, Y)
    zn2[3] = float("inf")
    alpha = torch.zeros(600)
    alpha[300] = 1.0
    lam = float((X @ Y).abs().max()) * 2
    head, nz, rn, cmin = cdk.cd_score_plain(X, Y, zn2, alpha, lam)
    assert torch.isnan(head[3]) and int(torch.isnan(head).sum()) == 1
    assert cmin.shape == (3,) and float(cmin[0]) == -float("inf")  # the NaN row's chunk
    assert float(cmin[1]) == -float("inf") and float(cmin[2]) > 0  # a_300 != 0
    assert bool(torch.all(nz.double() >= torch.linalg.vector_norm(X.double(), dim=1)))
    assert rn >= float(torch.linalg.vector_norm(Y.double()))
    h0, _, _, _ = cdk.cd_score_plain(X, Y, torch.ones(600), alpha, 0.0)
    assert bool(torch.all(h0 < 0))
