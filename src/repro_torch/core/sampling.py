"""Sampling-size rules from paper §4.5.

Two regimes:
  * percentile rule (Theorem 1, Schölkopf & Smola 6.33): kappa independent
    of p — e.g. kappa = 194 gives a top-2% vertex w.p. >= 0.98;
  * confidence rule (eq. 12): kappa >= ln(1-rho)/ln(1-s/p) guarantees the
    sample hits the optimal active set S* w.p. >= rho. For s/p -> 0 this
    degrades to kappa ~ (-ln(1-rho)/s) * p (eq. 13).
"""
from __future__ import annotations

import math


def kappa_percentile(top_fraction: float, confidence: float) -> int:
    """Smallest kappa s.t. max of the sample is in the top ``top_fraction``
    of all p values with probability >= ``confidence`` (independent of p)."""
    if not (0.0 < top_fraction < 1.0 and 0.0 < confidence < 1.0):
        raise ValueError("top_fraction and confidence must lie in (0, 1)")
    return int(math.ceil(math.log(1.0 - confidence) / math.log(1.0 - top_fraction)))


def kappa_confidence(p: int, n_relevant: int, rho: float) -> int:
    """Paper eq. (12): sample hits at least one of the ``n_relevant`` optimal
    features with probability >= rho."""
    if n_relevant <= 0:
        raise ValueError("n_relevant must be positive")
    if n_relevant >= p:
        return 1
    kappa = math.log(1.0 - rho) / math.log(1.0 - n_relevant / p)
    return max(1, min(p, int(math.ceil(kappa))))


def kappa_fraction(p: int, fraction: float) -> int:
    """The paper's large-scale default (§5.2, Table 3): |S| = fraction * p."""
    return max(1, int(math.ceil(fraction * p)))


def kappa_blocks(kappa: int, block_size: int, p: int | None = None) -> int:
    """Round a target kappa up to a whole number of aligned blocks.

    When ``p`` is given the count is clamped to the ceil(p / block_size)
    blocks that actually exist — the same clamp the solver applies before
    its draw without replacement (`vertex.sample_blocks`), so a
    kappa request larger than p can never imply more blocks than exist.
    """
    nblocks = max(1, math.ceil(kappa / block_size))
    if p is not None:
        if p <= 0:
            raise ValueError("p must be positive")
        nblocks = min(nblocks, math.ceil(p / block_size))
    return nblocks * block_size
