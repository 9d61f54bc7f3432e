"""The port's roofline (``repro_torch.analysis.roofline``) against the
reference's: the reference's ``TestHLOParsing`` and ``TestModelFlops`` on
the port, ``model_flops``/``active_params``/``total_params`` for the ten
configs x four shapes, ``roofline_terms`` on the same cost and figures;
then the port's own counting on a fake (2, 4) group: the collectives that
DTensor issues (``tally_collectives``) and one rank's FLOPs of a
tensor-parallel product. The fake group lives in this module's fixture and
is destroyed at its teardown.
"""
import pytest
import torch

from repro.analysis import roofline as ref_rf
from repro.configs import ARCH_IDS, get_config as ref_config
from repro.launch import cells as ref_cells
from repro_torch.analysis import roofline as rf
from repro_torch.configs import get_config

HLO = """
  %ar = f32[128,256]{1,0} all-reduce(%x), replica_groups={}
  %ag = bf16[64,512]{1,0} all-gather(%y), dimensions={0}
  %rs = f32[32]{0} reduce-scatter(%z), dimensions={0}
  %a2a = (f32[16,16]{1,0}, f32[16,16]{1,0}) all-to-all(%a, %b)
  %cp = u32[8]{0} collective-permute(%c), source_target_pairs={{0,1}}
  %dot = f32[128,128]{1,0} dot(%p, %q)
"""


class TestHLOParsing:
    def test_parse_collectives_counts_and_bytes(self):
        t = rf.parse_collectives(HLO)
        assert t["all-reduce"]["count"] == 1
        assert t["all-reduce"]["result_bytes"] == 128 * 256 * 4
        assert t["all-reduce"]["wire_bytes"] == 2 * 128 * 256 * 4
        assert t["all-gather"]["count"] == 1
        assert t["all-gather"]["wire_bytes"] == 64 * 512 * 2
        assert t["reduce-scatter"]["count"] == 1
        assert t["all-to-all"]["result_bytes"] == 2 * 16 * 16 * 4
        assert t["collective-permute"]["wire_bytes"] == 8 * 4

    def test_async_start_variants_counted(self):
        t = rf.parse_collectives("%ar = f32[64]{0} all-reduce-start(%x)\n")
        assert t["all-reduce"]["count"] == 1

    def test_non_collective_lines_ignored(self):
        hlo = "%d = f32[1024,1024]{1,0} dot(%a, %b)\n%c = f32[4]{0} constant({1,2,3,4})\n"
        t = rf.parse_collectives(hlo)
        assert all(v["count"] == 0 for v in t.values())

    def test_the_references_tallies_and_bytes(self):
        assert rf.parse_collectives(HLO) == ref_rf.parse_collectives(HLO)
        assert rf.collective_bytes(HLO) == ref_rf.collective_bytes(HLO)


class TestModelFlops:
    def test_train_flops_formula(self):
        cfg = get_config("deepseek_7b")
        f = rf.model_flops(cfg, "train", 4096, 256)
        n = rf.active_params(cfg)
        assert f == pytest.approx(6 * n * 4096 * 256)

    def test_decode_flops_per_token(self):
        cfg = get_config("qwen2_72b")
        f = rf.model_flops(cfg, "decode", 32768, 128)
        n = rf.active_params(cfg)
        assert f == pytest.approx(2 * n * 128)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_params_are_the_references(arch):
    cfg, ref = get_config(arch), ref_config(arch)
    assert rf.active_params(cfg) == ref_rf.active_params(ref)
    assert rf.total_params(cfg) == ref_rf.total_params(ref)
    for shape in ref_cells.SHAPES.values():
        assert (rf.model_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
                == ref_rf.model_flops(ref, shape.kind, shape.seq_len, shape.global_batch))


def test_roofline_terms_are_the_references():
    cost = {"flops": 3.25e15, "bytes accessed": 7.5e12}
    got = rf.roofline_terms(cost, HLO, rf.H100)
    want = ref_rf.roofline_terms(cost, HLO, rf.H100)
    assert got.to_dict() == want.to_dict()
    assert got.bound_s == want.bound_s
    assert got.compute_s == 3.25e15 / 989e12
    assert got.memory_s == 7.5e12 / 3.35e12


def test_h100_figures_and_no_tpu_figures():
    assert rf.H100 == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 50e9}
    assert not hasattr(rf, "V5E")


# ---------------------------------------------------------------------------
# Counting on a fake (2, 4) group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    with dryrun.fake_world(8):
        yield make_host_mesh(2, 4, device="cpu")


def _fake(shape, dtype, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.empty(shape, dtype=dtype), mesh, placements,
                             src_data_rank=None)


def test_partial_to_replicate_is_one_all_reduce(mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate

    with FakeTensorMode():
        local = torch.empty((128, 256), dtype=torch.float32)
        x = DTensor.from_local(local, mesh, [Partial(), Replicate()], run_check=False)
        out, t = rf.tally_collectives(x.redistribute, mesh, [Replicate(), Replicate()])
    assert out.placements == (Replicate(), Replicate())
    assert t["all-reduce"] == {"count": 1, "result_bytes": 128 * 256 * 4.0,
                               "wire_bytes": 2 * 128 * 256 * 4.0}
    assert all(v["count"] == 0 for k, v in t.items() if k != "all-reduce")


def test_shard_gathered_is_one_all_gather(mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    with FakeTensorMode():
        x = _fake((64, 512), torch.bfloat16, mesh, [Shard(0), Replicate()])
        _, t = rf.tally_collectives(x.full_tensor)
    assert t["all-gather"] == {"count": 1, "result_bytes": 64 * 512 * 2.0,
                               "wire_bytes": 64 * 512 * 2.0}
    assert all(v["count"] == 0 for k, v in t.items() if k != "all-gather")


def test_a_tensor_parallel_product_counts_one_ranks_flops(mesh):
    """x replicated, w's columns over the 4-way "model" axis: each rank
    multiplies (m, k) by (k, n/4), and the global product's shape
    propagation is not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    m, k, n = 256, 4096, 11008
    with FakeTensorMode():
        x = _fake((m, k), torch.bfloat16, mesh, [Replicate(), Replicate()])
        w = _fake((k, n), torch.bfloat16, mesh, [Replicate(), Shard(1)])
        with rf.CostMode() as mode:
            y = x @ w
    assert y.placements == (Replicate(), Shard(1))
    assert mode.flops == 2 * m * k * n / 4
    assert mode.bytes == (m * k + k * n // 4 + m * n // 4) * 2
    assert all(v["count"] == 0 for v in mode.tallies.values())
    terms = mode.terms()
    assert terms.compute_s == mode.flops / rf.H100["peak_flops"]
    assert terms.dominant == "memory"
