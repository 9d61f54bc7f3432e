"""The port's regularization path (``repro_torch.core.path``) against the JAX
reference on the CPU, on the ``small_problem`` geometry.

Each grid point of the reference draws from its own key, split off the
path's key; the port replays those per-point streams through
``sampler_fn``. Integer facts per point (iterations, n_dots, active) are
exact; objectives and l1 norms at rtol 1e-6, the reference goldens'
tolerance for summation-order differences (the warm start's l1 rescale
and every score are sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import FWConfig as RefConfig
from repro.core import path as ref_path

from repro_torch import convert
from repro_torch.core import FWConfig, path

KAPPA, MAX_ITERS, SEED = 60, 2000, 0
PAIRS = [("torch", "xla"), ("kernels", "pallas")]


@pytest.fixture(scope="module")
def prob(small_problem):
    ds = small_problem[2]
    return np.ascontiguousarray(ds.X.T), ds.y


def _point_streams(n_points, p):
    """The reference fw_path's per-point index streams."""
    with jax.threefry_partitionable(False):
        def step(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.randint(sub, (KAPPA,), 0, p)

        streams, key = [], jax.random.PRNGKey(SEED)
        for _ in range(n_points):
            key, sub = jax.random.split(key)
            _, draws = jax.lax.scan(step, sub, None, length=MAX_ITERS)
            streams.append(np.asarray(draws))
    return streams


def test_grids_match_reference(prob):
    Xt, y = prob
    np.testing.assert_array_equal(path.delta_grid(150.0, 7), ref_path.delta_grid(150.0, 7))
    X, yt = convert.problem_from_numpy(Xt, y, "cpu")
    np.testing.assert_allclose(path.lambda_grid(X, yt, 5),
                               ref_path.lambda_grid(jnp.asarray(Xt), jnp.asarray(y), 5),
                               rtol=1e-6)


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_fw_path_matches_reference(prob, backend, ref_backend):
    Xt, y = prob
    deltas = ref_path.delta_grid(150.0, n_points=5)
    cfg = RefConfig(delta=1.0, kappa=KAPPA, max_iters=MAX_ITERS, tol=1e-4,
                    backend=ref_backend, report_gap=True)
    with jax.threefry_partitionable(False):
        ref = ref_path.fw_path(jnp.asarray(Xt), jnp.asarray(y), deltas, cfg, seed=SEED)
    streams = _point_streams(len(deltas), Xt.shape[0])
    res = path.fw_path(
        Xt, y, deltas,
        FWConfig(delta=1.0, kappa=KAPPA, max_iters=MAX_ITERS, tol=1e-4, backend=backend,
                 report_gap=True),
        device="cpu",
        sampler_fn=lambda g: convert.stream_from_reference(streams[g], "cpu"),
    )
    assert len(res.points) == len(ref.points) == 5
    for got, want in zip(res.points, ref.points):
        assert (got.iterations, got.n_dots, got.active) == (
            want.iterations, want.n_dots, want.active)
        np.testing.assert_array_equal(got.alpha_nnz_idx, want.alpha_nnz_idx)
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
        np.testing.assert_allclose(got.l1, want.l1, rtol=1e-6)
        assert got.l1 <= got.reg * (1 + 1e-4)
        # the certified gap: a small difference of large terms (see
        # test_torch_engine), so compared to 1e-6 of delta * ||X^T y||_inf
        assert abs(got.gap - want.gap) <= 1e-6 * got.reg * float(np.abs(Xt @ y).max())
    assert (res.total_iters, res.total_dots) == (ref.total_iters, ref.total_dots)


def test_default_sampler_path_on_cpu(prob):
    """Without a stream the path draws from per-point TorchSamplers: the
    same seed gives the same path, and every point stays in its l1 ball."""
    Xt, y = prob
    deltas = path.delta_grid(100.0, n_points=4)
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=MAX_ITERS, tol=1e-4, backend="kernels")
    a = path.fw_path(Xt, y, deltas, cfg, seed=3, device="cpu")
    b = path.fw_path(Xt, y, deltas, cfg, seed=3, device="cpu")
    assert [pt.iterations for pt in a.points] == [pt.iterations for pt in b.points]
    assert [pt.objective for pt in a.points] == [pt.objective for pt in b.points]
    for pt in a.points:
        assert pt.l1 <= pt.reg * (1 + 1e-4)
    assert a.points[-1].objective < a.points[0].objective


def test_checkpointing_is_not_ported(prob, tmp_path):
    """Checkpointing is ported now (ROADMAP.md item 12; the test keeps its
    name): fw_path takes checkpoint_dir and leaves its last snapshot there,
    and resuming from it runs nothing more (tests/test_torch_resilience.py
    holds kill and resume against the uninterrupted run)."""
    Xt, y = prob
    cfg = FWConfig(delta=1.0, kappa=KAPPA, max_iters=50)
    done = path.fw_path(Xt, y, [1.0, 2.0], cfg, device="cpu", checkpoint_dir=str(tmp_path))
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_0000000001", "step_0000000002"]
    again = path.fw_path(Xt, y, [1.0, 2.0], cfg, device="cpu", resume_from=str(tmp_path))
    assert [pt.objective for pt in again.points] == [pt.objective for pt in done.points]
    assert again.total_dots == done.total_dots
