"""The reference's public names against the port's (ROADMAP.md Queue 3 F4):
``repro.core.__all__``, ``repro.distributed.__all__``, and the public names
of ``repro.sparse.ops`` and of ``repro.core``'s ``fw_lasso``, ``vertex``,
``step_rule``, ``engine``, ``path``, ``fw_elasticnet`` and ``fw_logistic``,
each found in its port module, less the names recorded as having no port
(``NO_PORT``, with the reason; ROADMAP.md's "Reference pieces that get no
port" records the same). The LM stack's: ``repro.models.__all__``,
``repro.training.__all__`` and the public names of ``repro.configs`` and
``repro.models``' ``model``, ``attention``, ``layers``, ``ssm`` and ``moe``,
and the training slice's: ``repro.training.optimizers``, ``repro.runtime``,
``repro.compression``, ``repro.parallel``, ``repro.utils`` and
``repro.data.lm_pipeline``, and the last LM slice's (item 15c):
``repro.models.sharding``, ``repro.launch`` (``cells``, ``mesh``, and
``dryrun`` read from its source, since importing it sets ``XLA_FLAGS``),
``repro.analysis`` and its ``roofline``. Typing helpers and imported
modules are not names of the API and are left out on both sides.
"""
import types
import typing

import pytest

import repro.core
import repro.core.engine
import repro.core.fw_elasticnet
import repro.core.fw_lasso
import repro.core.fw_logistic
import repro.core.path
import repro.core.step_rule
import repro.core.vertex
import repro.distributed
import repro.sparse.ops
import repro.configs
import repro.models
import repro.models.attention
import repro.models.layers
import repro.models.model
import repro.models.moe
import repro.models.ssm
import repro.training
import repro.training.optimizers
import repro.runtime
import repro.compression
import repro.compression.topk
import repro.parallel
import repro.utils
import repro.data.lm_pipeline
import repro.analysis
import repro.analysis.roofline
import repro.launch
import repro.launch.cells
import repro.launch.mesh
import repro.models.sharding

import repro_torch.configs
import repro_torch.training.optimizers
import repro_torch.runtime
import repro_torch.compression
import repro_torch.compression.topk
import repro_torch.parallel
import repro_torch.utils
import repro_torch.data.lm_pipeline
import repro_torch.analysis
import repro_torch.analysis.roofline
import repro_torch.launch
import repro_torch.launch.cells
import repro_torch.launch.dryrun
import repro_torch.launch.mesh
import repro_torch.models.sharding
import repro_torch.models
import repro_torch.models.attention
import repro_torch.models.layers
import repro_torch.models.model
import repro_torch.models.moe
import repro_torch.models.ssm
import repro_torch.training
import repro_torch.core
import repro_torch.core.engine
import repro_torch.core.fw_elasticnet
import repro_torch.core.fw_lasso
import repro_torch.core.fw_logistic
import repro_torch.core.path
import repro_torch.core.step_rule
import repro_torch.core.vertex
import repro_torch.distributed
import repro_torch.sparse.ops

# name -> why the port has none
NO_PORT = {
    "repro.core.vertex": {
        "pad_backend_matrix": "the port never copies Xt: its kernels score a row past p as 0",
        "resolve_gather_mode": "gather_mode is a TPU lowering knob, read by nothing in the port",
        "use_interpret": "interpret is Pallas' CPU mode; the port's CPU path is the plain twin",
    },
    "repro.core.engine": {
        "dot_dtype": "the n_dots counter's JAX dtype; the port counts dots in Python ints (R6)",
    },
    "repro.analysis.roofline": {
        "V5E": "a TPU's figures; the port's roofline takes the H100's (H100)",
    },
    "repro.analysis": {
        "V5E": "a TPU's figures; the port's roofline takes the H100's (H100)",
    },
    "repro.models.sharding": {
        "Mesh": "jax's mesh type; the port's mesh is a torch DeviceMesh",
        "NamedSharding": "jax's sharding type; the port's sharding is a DTensor placement list",
        "P": "jax's PartitionSpec; the port's spec is a plain tuple of the same content",
    },
    "repro.core.path": {
        "batched_solver_cache_size": "the reference caches its jitted batched solvers; the port "
                                     "compiles none",
        "clear_batched_solver_cache": "the same cache",
    },
}

def _public(mod) -> set:
    """A module's public names: not underscored, not an imported module,
    not a typing or dataclasses construct."""
    out = set()
    for name in dir(mod):
        if name.startswith("_") or name == "annotations":
            continue
        obj = getattr(mod, name)
        if isinstance(obj, types.ModuleType):
            continue
        if getattr(obj, "__module__", None) in ("typing", "dataclasses") or obj in (typing.Callable,
                                                                   typing.Optional):
            continue
        if name[0].isupper() and getattr(obj, "__origin__", None) is not None:
            continue  # a typing alias such as ExtraFn
        out.add(name)
    return out


@pytest.mark.parametrize("ref,port", [
    (repro.core, repro_torch.core),
    (repro.distributed, repro_torch.distributed),
])
def test_all_lists_carry_across(ref, port):
    missing = set(ref.__all__) - set(port.__all__)
    assert not missing, f"{port.__name__}.__all__ lacks {sorted(missing)}"
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("ref,port", [
    (repro.sparse.ops, repro_torch.sparse.ops),
    (repro.core.fw_lasso, repro_torch.core.fw_lasso),
    (repro.core.vertex, repro_torch.core.vertex),
    (repro.core.step_rule, repro_torch.core.step_rule),
    (repro.core.engine, repro_torch.core.engine),
    (repro.core.path, repro_torch.core.path),
    (repro.core.fw_elasticnet, repro_torch.core.fw_elasticnet),
    (repro.core.fw_logistic, repro_torch.core.fw_logistic),
])
def test_module_names_carry_across(ref, port):
    recorded = NO_PORT.get(ref.__name__, {})
    missing = _public(ref) - _public(port) - set(recorded)
    assert not missing, f"{port.__name__} lacks {sorted(missing)}"
    for name in recorded:
        assert not hasattr(port, name), f"{name} is recorded as having no port but exists"


@pytest.mark.parametrize("ref,port", [
    (repro.models, repro_torch.models),
    (repro.training, repro_torch.training),
    (repro.runtime, repro_torch.runtime),
    (repro.compression, repro_torch.compression),
    (repro.parallel, repro_torch.parallel),
    (repro.utils, repro_torch.utils),
    (repro.launch, repro_torch.launch),
    (repro.analysis, repro_torch.analysis),
])
def test_lm_all_lists_carry_across(ref, port):
    recorded = NO_PORT.get(ref.__name__, {})
    missing = set(ref.__all__) - set(port.__all__) - set(recorded)
    assert not missing, f"{port.__name__}.__all__ lacks {sorted(missing)}"
    for name in port.__all__:
        assert hasattr(port, name), name
    for name in recorded:
        assert not hasattr(port, name), f"{name} is recorded as having no port but exists"


@pytest.mark.parametrize("ref,port", [
    (repro.configs, repro_torch.configs),
    (repro.models.model, repro_torch.models.model),
    (repro.models.attention, repro_torch.models.attention),
    (repro.models.layers, repro_torch.models.layers),
    (repro.models.ssm, repro_torch.models.ssm),
    (repro.models.moe, repro_torch.models.moe),
    (repro.training.optimizers, repro_torch.training.optimizers),
    (repro.compression.topk, repro_torch.compression.topk),
    (repro.data.lm_pipeline, repro_torch.data.lm_pipeline),
    (repro.models.sharding, repro_torch.models.sharding),
    (repro.launch.cells, repro_torch.launch.cells),
    (repro.launch.mesh, repro_torch.launch.mesh),
    (repro.analysis.roofline, repro_torch.analysis.roofline),
])
def test_lm_module_names_carry_across(ref, port):
    recorded = NO_PORT.get(ref.__name__, {})
    missing = _public(ref) - _public(port) - set(recorded)
    assert not missing, f"{port.__name__} lacks {sorted(missing)}"
    for name in recorded:
        assert not hasattr(port, name), f"{name} is recorded as having no port but exists"


def test_the_dry_runs_names_carry_across():
    """``repro.launch.dryrun``'s top-level functions and constants (read from
    its source: importing it sets ``XLA_FLAGS`` for the whole process) are
    the port's, its underscored helpers too."""
    import ast
    from pathlib import Path

    src = Path(repro.launch.__file__).with_name("dryrun.py").read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    assert {"_opt_shardings", "_serve_rules", "_dp_axes", "lower_cell", "_probe_costs",
            "run_cell", "main", "OUT_DIR"} <= names
    missing = {n for n in names if not hasattr(repro_torch.launch.dryrun, n)}
    assert not missing, f"repro_torch.launch.dryrun lacks {sorted(missing)}"


def test_aliases_are_their_kernels_counterparts():
    from repro_torch.kernels import sparse_colstats, sparse_grad

    ops = repro_torch.sparse.ops
    assert ops.sparse_sampled_scores is sparse_grad.sparse_sampled_scores
    assert ops.sparse_sampled_scores_ref is sparse_grad.sparse_sampled_scores_plain
    assert ops.sparse_colstats_fused is sparse_colstats.sparse_colstats
    assert repro_torch.core.FWResult is repro_torch.core.engine.SolveResult
    assert repro_torch.core.fw_lasso.FWResult is repro_torch.core.engine.SolveResult


@pytest.mark.parametrize("backend,ref_backend", [("torch", "xla"), ("kernels", "pallas"),
                                                 ("sparse", "sparse")])
def test_apply_column_update_is_the_references(backend, ref_backend):
    """``vertex.apply_column_update`` (F4) against the reference's on the same
    inputs: eq. 10 on each backend, and the logistic's margin form (y_vec =
    0, -delta_t)."""
    import numpy as np
    import jax.numpy as jnp
    import torch

    from repro.core.solver_config import FWConfig as RefConfig
    from repro.sparse.matrix import SparseBlockMatrix as RefSparse
    from repro_torch.core import FWConfig
    from repro_torch.sparse import SparseBlockMatrix

    g = np.random.default_rng(5)
    X = g.standard_normal((60, 40)).astype(np.float32)
    X[np.abs(X) < 0.8] = 0.0
    v, y = g.standard_normal(40).astype(np.float32), g.standard_normal(40).astype(np.float32)
    if backend == "sparse":
        mat, ref_mat = SparseBlockMatrix.from_dense(X, block_size=16), RefSparse.from_dense(
            X, block_size=16)
    else:
        mat, ref_mat = torch.from_numpy(X), jnp.asarray(X)
    for y_vec, dt in ((y, -3.0), (np.zeros_like(y), 3.0)):
        got = repro_torch.core.vertex.apply_column_update(
            mat, torch.from_numpy(v), torch.from_numpy(y_vec), torch.tensor(17),
            torch.tensor(0.25), torch.tensor(dt), FWConfig(delta=1.0, backend=backend))
        want = repro.core.vertex.apply_column_update(
            ref_mat, jnp.asarray(v), jnp.asarray(y_vec), jnp.asarray(17), jnp.float32(0.25),
            jnp.float32(dt), RefConfig(delta=1.0, backend=ref_backend, interpret=True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [5, 63])
def test_sf_update_is_the_references(k):
    """``fw_lasso.sf_update`` (F4) against the reference's: the S/F
    recursions at a winner, and at k = 63 the exact refresh from the
    residual (refresh_every 64)."""
    import numpy as np
    import jax.numpy as jnp
    import torch

    from repro.core import fw_lasso as ref_fw_lasso
    from repro.core.engine import ColStats as RefStats
    from repro.core.solver_config import FWConfig as RefConfig
    from repro_torch.core import FWConfig
    from repro_torch.core.engine import ColStats

    g = np.random.default_rng(6)
    zty, zn2 = g.standard_normal(30).astype(np.float32), g.random(30).astype(np.float32) + 0.5
    resid, y = g.standard_normal(20).astype(np.float32), g.standard_normal(20).astype(np.float32)
    s, f, lam, dt, g_lin = 3.0, 1.2, 0.3, -2.0, 0.7
    got = repro_torch.core.fw_lasso.sf_update(
        ColStats(torch.from_numpy(zty), torch.from_numpy(zn2), torch.tensor(1.0)),
        torch.tensor(s), torch.tensor(f), torch.from_numpy(resid), torch.from_numpy(y),
        torch.tensor(11), torch.tensor(lam), torch.tensor(dt), torch.tensor(g_lin), k,
        FWConfig(delta=1.0))
    want = ref_fw_lasso.sf_update(
        RefStats(jnp.asarray(zty), jnp.asarray(zn2), jnp.float32(1.0)), jnp.float32(s),
        jnp.float32(f), jnp.asarray(resid), jnp.asarray(y), 11, jnp.float32(lam),
        jnp.float32(dt), jnp.float32(g_lin), k, RefConfig(delta=1.0))
    np.testing.assert_allclose([float(got[0]), float(got[1])],
                               [float(want[0]), float(want[1])], rtol=1e-6)
    assert got[2] == bool(want[2]) == (k == 63)
