"""The port's ten architecture configs (``repro_torch.configs``) against
the reference's, field for field: each config, its ``reduced()`` (the CPU
tests' size) and ``reduced(ssm_chunk=8)``, every property the stack reads,
the registry's ids, aliases and ``all_configs``.
"""
import dataclasses

import pytest

import repro.configs as ref_configs
from repro.models.config import ModelConfig as RefConfig

import repro_torch.configs as configs
from repro_torch.models.config import ModelConfig

PROPS = ("resolved_head_dim", "q_dim", "kv_dim", "d_inner", "ssm_heads", "is_attention_free",
         "supports_long_context")


def test_registry_matches():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs._ALIAS == ref_configs._ALIAS
    assert list(configs.all_configs()) == list(ref_configs.all_configs())
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(RefConfig)]


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("size", ["full", "reduced", "reduced_chunk8"])
def test_config_matches_field_for_field(arch, size):
    mine, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert configs.get_config(arch.replace("_", "-")) == mine
    if size == "reduced":
        mine, ref = mine.reduced(), ref.reduced()
    elif size == "reduced_chunk8":
        mine, ref = mine.reduced(ssm_chunk=8), ref.reduced(ssm_chunk=8)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for prop in PROPS:
        assert getattr(mine, prop) == getattr(ref, prop), prop
    n = mine.n_layers
    assert [mine.pattern_for_layer(i) for i in range(n)] == [ref.pattern_for_layer(i)
                                                             for i in range(n)]
    assert [mine.is_moe_layer(i) for i in range(n)] == [ref.is_moe_layer(i) for i in range(n)]
