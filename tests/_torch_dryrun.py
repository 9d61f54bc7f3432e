"""Shared by the dry run's tests (``test_torch_dryrun_*.py``): the reduced
configs' cells on 8 fake ranks through ``scripts/torch_debug_dryrun_small.py``
and the reference's record layout.

Each test starts its own fake group and destroys it (``dryrun.fake_world``),
so that no group outlives the test in its worker.
"""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

ROOT = Path(__file__).resolve().parents[1]


def small_script():
    spec = importlib.util.spec_from_file_location(
        "torch_debug_dryrun_small", ROOT / "scripts" / "torch_debug_dryrun_small.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the keys of the reference's record (``repro.launch.dryrun.run_cell``)
RECORD_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s", "probe_s", "memory",
               "roofline", "model_flops_total", "hlo_flops_total", "useful_flops_ratio",
               "hbm_per_device_gb", "total_s"}
MEMORY_KEYS = {"argument_size", "output_size", "temp_size", "generated_code_size"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "flops_per_device", "bytes_per_device",
                 "wire_bytes_per_device", "dominant", "collectives"}
META_KEYS = {"train": {"microbatches", "fsdp"}, "prefill": {"fsdp", "serve_rules"},
             "decode": {"fsdp", "serve_rules"}}


def small_records(archs, data=2, model=4):
    """The reduced ``archs`` x {train, prefill, decode} on a (data, model)
    mesh of fake ranks, at the small script's shapes."""
    with dryrun.fake_world(data * model):
        mesh = make_host_mesh(data, model, device="cpu")
        return small_script().small_cells(archs, ["train", "prefill", "decode"], mesh, "cpu")


def check_record(rec, n_chips=8):
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert RECORD_KEYS | META_KEYS[rec["shape"]] <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert ROOFLINE_KEYS <= set(rec["roofline"])
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["argument_size"] > 0 and rec["memory"]["temp_size"] > 0
    assert rec["hlo_flops_total"] == pytest.approx(r["flops_per_device"] * n_chips)
    assert set(r["collectives"]) == {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                     "collective-permute"}
