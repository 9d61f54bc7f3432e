"""Synthetic regression data (paper §5: scikit-learn make_regression clone).

The paper generates Synthetic-10000 / Synthetic-50000 with
sklearn.datasets.make_regression (m=200 train + 200 test, p=10000/50000,
32/100 and 158/500 informative features). We reproduce that generator in
numpy: standard-normal X, a sparse ground-truth coefficient vector with
uniform(0, 100) nonzero entries, and additive Gaussian noise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Dataset(NamedTuple):
    X: np.ndarray  # (m, p) float32, standardized columns (unit l2 norm)
    y: np.ndarray  # (m,) float32, centered
    X_test: Optional[np.ndarray]
    y_test: Optional[np.ndarray]
    coef: Optional[np.ndarray]  # ground-truth coefficients, if known
    name: str


def make_regression(
    m: int,
    p: int,
    n_informative: int,
    noise: float = 1.0,
    m_test: int = 0,
    seed: int = 0,
    name: str = "synthetic",
) -> Dataset:
    rng = np.random.default_rng(seed)
    n = m + m_test
    X = rng.standard_normal((n, p)).astype(np.float32)
    coef = np.zeros(p, np.float32)
    support = rng.choice(p, size=n_informative, replace=False)
    coef[support] = rng.uniform(0.0, 100.0, size=n_informative).astype(np.float32)
    y = X @ coef + noise * rng.standard_normal(n).astype(np.float32)
    X_tr, y_tr = X[:m], y[:m]
    X_te = X[m:] if m_test else None
    y_te = y[m:] if m_test else None
    return Dataset(X_tr, y_tr.astype(np.float32), X_te, y_te, coef, name)


def standardize(ds: Dataset) -> Dataset:
    """Center y; scale each predictor to unit l2 norm (paper §4.1 assumption).

    Test data is transformed with the training statistics.
    """
    X = ds.X.astype(np.float64)
    mu = X.mean(axis=0)
    Xc = X - mu
    norms = np.sqrt((Xc * Xc).sum(axis=0))
    norms[norms < 1e-12] = 1.0
    Xs = (Xc / norms).astype(np.float32)
    y_mu = ds.y.mean()
    ys = (ds.y - y_mu).astype(np.float32)

    X_te, y_te = ds.X_test, ds.y_test
    if X_te is not None:
        X_te = ((X_te - mu) / norms).astype(np.float32)
        y_te = (ds.y_test - y_mu).astype(np.float32)
    coef = None if ds.coef is None else (ds.coef * norms).astype(np.float32)
    return Dataset(Xs, ys, X_te, y_te, coef, ds.name)


def paper_synthetic(p: int, n_informative: int, seed: int = 0) -> Dataset:
    """The paper's synthetic configurations: m = t = 200."""
    return standardize(
        make_regression(
            m=200,
            p=p,
            n_informative=n_informative,
            noise=1.0,
            m_test=200,
            seed=seed,
            name=f"synthetic-{p}-{n_informative}",
        )
    )


def make_wide_problem(p: int, m: int, n_rel: int, seed: int = 0, device="cuda"):
    """The paper-scale dense proxy of ``examples/lasso_fullpath_4m.py``
    (``make_wide_problem`` there), drawn on ``device`` with a
    ``torch.Generator`` so the (p, m) design is never built in host numpy.

    Returns ``(Xt, y, coef)``: the feature-major design ``Xt (p, m)`` f32
    with zero-mean unit-norm features, centered targets ``y (m,)`` and the
    ``n_rel``-sparse ground-truth coefficients ``coef (p,)``. The draws
    differ from the numpy example's; the construction is the same.
    """
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    Xt = torch.randn((p, m), generator=g, device=device, dtype=torch.float32)
    Xt -= Xt.mean(dim=1, keepdim=True)
    Xt /= (torch.linalg.vector_norm(Xt, dim=1, keepdim=True) + 1e-12)
    coef = torch.zeros(p, dtype=torch.float32, device=device)
    support = torch.randperm(p, generator=g, device=device)[:n_rel]
    coef[support] = torch.randn(n_rel, generator=g, device=device) * 10
    y = coef @ Xt + 0.05 * torch.randn(m, generator=g, device=device)
    return Xt, y - y.mean(), coef
