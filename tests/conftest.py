"""Shared fixtures. NOTE: device count stays 1 here — only launch/dryrun.py
sets XLA_FLAGS=--xla_force_host_platform_device_count (per DESIGN.md)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.data import make_regression, standardize


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one"
    )


@pytest.fixture(scope="session")
def small_problem():
    """Standardized regression problem, feature-major design matrix."""
    ds = standardize(make_regression(m=80, p=300, n_informative=10, noise=0.5, seed=0))
    return jnp.asarray(ds.X.T.copy()), jnp.asarray(ds.y), ds


@pytest.fixture(scope="session")
def medium_problem():
    ds = standardize(
        make_regression(m=150, p=2000, n_informative=40, noise=1.0, seed=1)
    )
    return jnp.asarray(ds.X.T.copy()), jnp.asarray(ds.y), ds


@pytest.fixture()
def rng_key():
    return jax.random.PRNGKey(42)
