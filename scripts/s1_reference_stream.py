"""The reference's half of the sparse-PARTAN witness (ROADMAP.md S1), on
the CPU: the acceptance design of ``tests/test_step_rules.py:42-61`` (m =
300, p = 120, seed 11) in the reference's block-ELL layout (blocks of 32),
the reference engine's index stream from ``PRNGKey(1)`` in legacy threefry
mode (1,500 steps of 48 draws), and the reference's own sparse PARTAN solve
on it (iterations, objective, certified gap). Writes them to one ``.npz``
that ``scripts/s1_partan_replay.py`` replays through the port, on the
card or the CPU, without JAX:

    PYTHONPATH=src python scripts/s1_reference_stream.py --out build/s1_stream.npz
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import LASSO, FWConfig, engine
from repro.sparse import SparseBlockMatrix

DELTA, KAPPA, MAX_ITERS, BLOCK, SEED = 40.0, 48, 1500, 32, 1


def corr_design():
    """``tests/test_step_rules.py:_corr_design`` (seed 11)."""
    rng = np.random.default_rng(11)
    m, p, rho = 300, 120, 0.6
    Z = rng.standard_normal((m, p)).astype(np.float32)
    X = np.empty_like(Z)
    X[:, 0] = Z[:, 0]
    for j in range(1, p):
        X[:, j] = rho * X[:, j - 1] + np.sqrt(1 - rho**2) * Z[:, j]
    coef = np.zeros(p, np.float32)
    coef[rng.choice(p, 10, replace=False)] = rng.standard_normal(10).astype(np.float32) * 50.0
    y = X @ coef + 1.0 * rng.standard_normal(m).astype(np.float32)
    return X.T.copy(), y.astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the .npz to write")
    args = ap.parse_args(argv)
    Xt, y = corr_design()
    mat = SparseBlockMatrix.from_dense(Xt, block_size=BLOCK)
    cfg = FWConfig(delta=DELTA, kappa=KAPPA, sampling="uniform", max_iters=MAX_ITERS, tol=1e-4,
                   patience=20, step_rule="partan", backend="sparse")
    with jax.threefry_partitionable(False):
        def body(key, _):  # the engine's stream: key, sub = split(key); randint(sub)
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (KAPPA,), 0, Xt.shape[0])

        _, draws = jax.lax.scan(body, jax.random.PRNGKey(SEED), None, length=MAX_ITERS)
        res = engine.solve(LASSO, mat, jnp.asarray(y), cfg, jax.random.PRNGKey(SEED))
        gap = float(LASSO.gap(mat, jnp.asarray(y), res.alpha, jnp.asarray(DELTA), cfg))
    obj = float(res.objective)
    print(f"reference sparse PARTAN: {int(res.iterations)} iterations, converged "
          f"{bool(res.converged)}, objective {obj!r}, certified gap {gap!r}, bar 1e-4 * "
          f"objective = {1e-4 * obj!r}: {'met' if gap <= 1e-4 * obj else 'MISSED'}")
    np.savez(args.out, Xt=Xt, y=y, values=np.asarray(mat.values), rows=np.asarray(mat.rows),
             shape=np.array([mat.p, mat.m, mat.block_size, mat.nnz_max]),
             draws=np.asarray(draws).astype(np.int64), ref_iterations=int(res.iterations),
             ref_objective=obj, ref_gap=gap, delta=DELTA)


if __name__ == "__main__":
    main()
