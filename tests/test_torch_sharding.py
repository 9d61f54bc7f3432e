"""The port's sharding rules (``repro_torch.models.sharding``) against the
reference's: the reference's ``TestShardingRules`` on the port, then
``spec_for``, ``param_specs`` (fsdp on and off; the default rules, the
serving rules of ``SERVE_MLP_DATA`` and the weight-stationary MoE rules),
``batch_specs`` and ``cache_specs`` for the ten full configs on stand-in
meshes of (16, 16), (2, 16, 16), (2, 4) and (1, 1): the spec functions
read only the mesh's axis sizes, so neither package needs a device of
the mesh. A port spec is a tuple with the content of the reference's
``PartitionSpec``; a block's parameter has the reference's stacked leaf's
spec without its leading None. Last, the placements of specs on a fake
(2, 4) group (this module's fixture, destroyed at its teardown) give the
specs' local shapes.
"""
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.launch import cells as ref_cells
from repro.models import sharding as ref_sh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import cells as cell_lib
from repro_torch.models import sharding as sh
from repro_torch.training import optimizers as opt_lib

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "1x1": {"data": 1, "model": 1},
}


def _stand_in(sizes):
    return types.SimpleNamespace(shape=dict(sizes))


def _serve_rules(ref: bool):
    """The dry run's serving rules (``dryrun._serve_rules`` of a
    ``SERVE_MLP_DATA`` arch), built from either package's defaults."""
    rules = dict((ref_sh if ref else sh).DEFAULT_RULES)
    rules["mlp"] = "data"
    rules["moe_mlp"] = "data"
    return rules


RULE_SETS = {
    "default": (False, lambda ref: None),
    "fsdp": (True, lambda ref: None),
    "serve": (False, _serve_rules),
    "moe_ws": (True, lambda ref: (ref_sh if ref else sh).weight_stationary_moe_rules()),
    "moe_ws_no_fsdp_dense": (False, lambda ref: (ref_sh if ref else sh)
                             .weight_stationary_moe_rules(fsdp_dense=False)),
}


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in p): tuple(s)
            for p, s in flat}


class TestShardingRules:
    def test_param_axes_cover_all_archs(self):
        """Every parameter in every arch gets a rank-matching axis tuple."""
        for arch in ("deepseek_7b", "kimi_k2_1t_a32b", "hymba_1_5b", "seamless_m4t_medium",
                     "mamba2_130m"):
            params = cell_lib.params_spec_for(get_config(arch).reduced())
            axes = sh.logical_axes(params)
            for name, p in params.named_parameters():
                assert len(axes[name]) == p.dim(), name

    def test_divisibility_fallback(self):
        """25 heads on a 16-way axis must fall back to replication."""
        spec = sh.spec_for((25, 64), ("heads", "embed"), _stand_in(MESHES["1x1"]),
                           sh.DEFAULT_RULES)
        assert spec == (None, None)
        spec = sh.spec_for((25 * 64, 64), ("heads", "embed"), _stand_in(MESHES["16x16"]),
                           sh.DEFAULT_RULES)
        assert spec == ("model", None)
        spec = sh.spec_for((25, 64), ("heads", "embed"), _stand_in(MESHES["16x16"]),
                           sh.DEFAULT_RULES)
        assert spec == (None, None)

    def test_constrain_noop_without_mesh(self):
        x = torch.ones((4, 4))
        out = sh.constrain(x, "batch", "embed")
        assert out is x


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_is_the_references(mesh):
    m = _stand_in(MESHES[mesh])
    rules = dict(sh.DEFAULT_RULES, seq="model", act_embed="data")
    cases = [((256, 4096), ("batch", None)), ((32, 4096, 4096), ("batch", "seq", "act_embed")),
             ((1, 524288), ("batch", None)), ((25 * 64, 4096), ("heads", "embed")),
             ((24, 64, 64), ("heads", "heads", None)), ((128, 8, 128), ("batch", "kv_heads", None)),
             ((384, 7168, 2048), ("experts", "moe_embed", "moe_mlp")), ((7,), (None,))]
    for shape, axes in cases:
        for r in (sh.DEFAULT_RULES, rules):
            assert sh.spec_for(shape, axes, m, r) == tuple(ref_sh.spec_for(shape, axes, m, r)), (
                shape, axes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references(arch):
    params = cell_lib.params_spec_for(get_config(arch))
    ref_params = ref_cells.params_spec_for(ref_config(arch))
    groups = opt_lib.leaf_groups(params)
    for mesh, sizes in MESHES.items():
        m = _stand_in(sizes)
        for label, (fsdp, rules) in RULE_SETS.items():
            got = sh.param_specs(params, m, fsdp=fsdp, rules=rules(False))
            want = _ref_specs(ref_sh.param_specs(ref_params, m, fsdp=fsdp, rules=rules(True)))
            assert set(groups) == set(want)
            for path, (names, stacked) in groups.items():
                for n in names:
                    assert ((None,) if stacked else ()) + got[n] == want[path], (
                        mesh, label, n)
            placements_ok = all(len(s) == params.get_parameter(n).dim() for n, s in got.items())
            assert placements_ok


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_are_the_references(arch):
    cfg, ref = get_config(arch), ref_config(arch)
    for mesh, sizes in MESHES.items():
        m = _stand_in(sizes)
        for shape in ("train_4k", "prefill_32k"):
            got = sh.batch_specs(cell_lib.batch_specs_for(cfg, cell_lib.SHAPES[shape]), m)
            want = _ref_specs(ref_sh.batch_specs(
                ref_cells.batch_specs_for(ref, ref_cells.SHAPES[shape]), m))
            assert got == want, (mesh, shape)
        for shape in ("decode_32k", "long_500k"):
            _, cache = cell_lib.decode_inputs_for(cfg, cell_lib.SHAPES[shape])
            _, ref_cache = ref_cells.decode_inputs_for(ref, ref_cells.SHAPES[shape])
            got = sh.cache_specs(cache, m)
            want = _ref_specs(ref_sh.cache_specs(ref_cache, m))
            assert got == want, (mesh, shape)


def test_logical_axes_of_a_reference_tree_by_path():
    """A dict of tensors keyed by reference paths reads the same patterns:
    a stacked leaf gets the leading None."""
    tree = {"layers/attn/wq": torch.empty(3, 8, 16, device="meta"),
            "embed/tok": torch.empty(32, 8, device="meta"),
            "layers/ssm/conv_w": torch.empty(3, 4, 16, device="meta"),
            "something/else": torch.empty(2, 2, device="meta")}
    assert sh.logical_axes(tree) == {"layers/attn/wq": (None, "embed", "heads"),
                                     "embed/tok": ("vocab", "embed"),
                                     "layers/ssm/conv_w": (None, None, "mlp"),
                                     "something/else": (None, None)}


# ---------------------------------------------------------------------------
# Placements on a fake (2, 4) group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    with dryrun.fake_world(8):
        yield make_host_mesh(2, 4, device="cpu")


@pytest.mark.parametrize("shape,spec,local", [
    ((16, 64), ("data", "model"), (8, 16)),
    ((16, 64), ("model", None), (4, 64)),
    ((8, 12, 64), (None, "data", "model"), (8, 6, 16)),
    ((16, 64), (("data", "model"), None), (2, 64)),
    ((16, 64), (None, None), (16, 64)),
])
def test_placements_give_the_specs_local_shapes(mesh, shape, spec, local):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor

    with FakeTensorMode():
        d = distribute_tensor(torch.empty(shape), mesh, sh.placements(spec, mesh),
                              src_data_rank=None)
        z = sh.zeros(shape, torch.float32, "cpu", mesh, spec)
    assert tuple(d.to_local().shape) == local
    assert tuple(z.to_local().shape) == local and tuple(z.shape) == shape
    assert tuple(z.placements) == tuple(d.placements)


def test_a_models_parameters_distributed_by_their_specs(mesh):
    """``distribute_params`` on fake parameters: each local shard is the
    spec's, and the model's names and global shapes stay."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    cfg = get_config("deepseek_7b").reduced()
    with FakeTensorMode():
        params = cell_lib.params_spec_for(cfg)
        shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
        specs = sh.param_specs(params, mesh, fsdp=True)
        sh.distribute_params(params, mesh, fsdp=True)
    sizes = sh.mesh_shape(mesh)
    for n, p in params.named_parameters():
        assert isinstance(p, DTensor) and tuple(p.shape) == shapes[n]
        want = list(shapes[n])
        for d, entry in enumerate(specs[n]):
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                want[d] //= sizes[a]
        assert tuple(p.to_local().shape) == tuple(want), n
