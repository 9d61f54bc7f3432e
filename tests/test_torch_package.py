"""Package rules of the port (``src/repro_torch``):

  * neither the package nor chip_smoke.py (nor the card-only tests)
    imports JAX or the reference;
  * the entry points run on the card by default, and raise without one;
  * the reference's options that the port does not run yet raise
    NotImplementedError naming their ROADMAP.md item (a telemetry spec
    that is not a TelemetrySpec raises TypeError); the 'sparse' backend
    runs, on a SparseBlockMatrix only, and the sparse reader/writer
    (``sparse/io.py``) is ported;
  * the fused K-step chunk runs, and says so, where the reference's does.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import (ENOracle, FWConfig, StreamSampler, TorchSampler, en_solve, engine,
                              fw_path, fw_solve, logistic_solve)
from repro_torch.core.fw_lasso import LASSO, LassoOracle
from repro_torch.sparse import SparseBlockMatrix

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
        ROOT / "scripts" / "port_kernel_ab.py", ROOT / "scripts" / "rule_step_ab.py",
        ROOT / "scripts" / "cd_sweep_breakdown.py", ROOT / "scripts" / "s1_partan_replay.py",
        ROOT / "examples" / "torch_train_lm.py", ROOT / "examples" / "torch_fw_feature_selection.py",
        ROOT / "examples" / "torch_compressed_dp.py", ROOT / "scripts" / "torch_debug_dryrun_small.py",
        ROOT / "scripts" / "serve_decode_ab.py", ROOT / "tests" / "_torch_mesh_ranks.py"]
    assert len(files) > 10
    assert {"matrix.py", "ops.py"} <= {f.name for f in files if f.parent.name == "sparse"}
    assert "step_rule.py" in {f.name for f in files if f.parent.name == "core"}
    assert {"faults.py", "guards.py", "checkpoint.py", "validate.py"} <= {
        f.name for f in files if f.parent.name == "resilience"}
    assert "io.py" in {f.name for f in files if f.parent.name == "sparse"}
    assert "manager.py" in {f.name for f in files if f.parent.name == "checkpoint"}
    assert {"optimizers.py", "trainer.py", "topk.py", "pipeline.py", "trees.py", "lm_pipeline.py",
            "train.py"} <= {f.name for f in files}
    assert {"sharding.py", "cells.py", "dryrun.py", "mesh.py", "roofline.py",
            "torch_debug_dryrun_small.py"} <= {f.name for f in files}
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN) for f in files}
    assert not {f: r for f, r in bad.items() if r}


def _problem():
    rng = np.random.default_rng(0)
    return rng.standard_normal((40, 12)).astype(np.float32), rng.standard_normal(12).astype(np.float32)


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device is usable")
    Xt, y = _problem()
    cfg = FWConfig(delta=1.0, kappa=5, max_iters=3)
    sampler = TorchSampler(0, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fw_solve(Xt, y, cfg, sampler)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.solve(LASSO, Xt, y, cfg, sampler)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fw_path(Xt, y, [0.5, 1.0], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        en_solve(Xt, y, cfg, 1.0, sampler)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        logistic_solve(Xt, np.sign(y), cfg, sampler)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.problem_from_numpy(Xt, y)
    mat = SparseBlockMatrix.from_dense(Xt, block_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.sparse_from_reference(mat.values.numpy(), mat.rows.numpy(), 40, 12, 16,
                                      mat.nnz_max)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fw_solve(mat, y, dataclasses.replace(cfg, backend="sparse"), sampler)
    res = fw_solve(Xt, y, cfg, sampler, device="cpu")
    assert res.iterations == 3 and res.alpha.device.type == "cpu"


@pytest.mark.parametrize("change,error,match", [
    # telemetry is ported (ROADMAP.md item 11): only a spec of another type is
    # refused; the case keeps its id
    pytest.param(dict(telemetry=object()), TypeError, "TelemetrySpec", id="change0-item 11"),
    # the distributed backend is ported (ROADMAP.md item 13): as the reference's,
    # a plain tensor with backend='distributed' is refused; the case keeps its id
    pytest.param(dict(backend="distributed"), ValueError, "only runs inside",
                 id="change1-item 13"),
])
def test_unported_options_raise(change, error, match):
    Xt, y = _problem()
    cfg = dataclasses.replace(FWConfig(delta=1.0, kappa=5, max_iters=3), **change)
    with pytest.raises(error, match=match):
        fw_solve(Xt, y, cfg, TorchSampler(0, "cpu"), device="cpu")
    with pytest.raises(error, match=match):
        fw_path(Xt, y, [1.0], cfg, device="cpu")


def test_telemetry_runs_and_the_obs_modules_are_in_the_import_check():
    """A solve with a TelemetrySpec runs (no refusal); the import check
    walks the obs and utils packages."""
    from repro_torch.obs import TelemetrySpec

    Xt, y = _problem()
    res = fw_solve(Xt, y, FWConfig(delta=1.0, kappa=5, max_iters=3,
                                   telemetry=TelemetrySpec(capacity=4)),
                   TorchSampler(0, "cpu"), device="cpu")
    assert res.telemetry.cursor == 3
    walked = {f.parent.name for f in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert {"obs", "utils"} <= walked


def test_sparse_io_is_not_ported_yet():
    """The sparse reader/writer is ported now (ROADMAP.md item 12; the test
    keeps its name): ``sparse.io`` exists, the package exports it, and its
    docstring names the item."""
    import repro_torch.sparse as sparse

    assert (ROOT / "src" / "repro_torch" / "sparse" / "io.py").exists()
    assert sparse.load_svmlight is sparse.io.load_svmlight
    assert "item 12" in sparse.__doc__ and "item 7a" not in sparse.__doc__


@pytest.mark.parametrize("sparse_kernel", [None, True, False])
def test_sparse_backend_runs_on_a_sparse_matrix(sparse_kernel):
    Xt, y = _problem()
    mat = SparseBlockMatrix.from_dense(Xt, block_size=16)
    cfg = FWConfig(delta=1.0, kappa=5, max_iters=3, backend="sparse",
                   sparse_kernel=sparse_kernel)
    res = fw_solve(mat, y, cfg, TorchSampler(0, "cpu"), device="cpu")
    assert res.iterations == 3 and res.alpha.shape == (40,)
    assert len(fw_path(mat, y, [0.5, 1.0], cfg, device="cpu").points) == 2


@pytest.mark.parametrize("matrix,backend,msg", [
    ("sparse", "kernels", "use FWConfig"),
    ("sparse", "torch", "use FWConfig"),
    ("dense", "sparse", "needs a repro_torch.sparse.SparseBlockMatrix"),
])
def test_matrix_and_backend_must_agree(matrix, backend, msg):
    Xt, y = _problem()
    X = SparseBlockMatrix.from_dense(Xt, block_size=16) if matrix == "sparse" else Xt
    cfg = FWConfig(delta=1.0, kappa=5, max_iters=3, backend=backend)
    with pytest.raises(ValueError, match=msg):
        fw_solve(X, y, cfg, TorchSampler(0, "cpu"), device="cpu")
    with pytest.raises(ValueError, match=msg):
        fw_path(X, y, [1.0], cfg, device="cpu")


@pytest.mark.parametrize("backend", ["torch", "kernels", "sparse"])
def test_fused_chunk_runs_and_reports_its_width(backend):
    Xt, y = _problem()
    cfg = FWConfig(delta=1.0, kappa=5, max_iters=21, tol=0.0, patience=10**9,
                   backend=backend, fuse_steps=8)
    if backend == "sparse":
        Xt = SparseBlockMatrix.from_dense(Xt, block_size=16)
    res = fw_solve(Xt, y, cfg, TorchSampler(0, "cpu"), device="cpu")
    assert (res.iterations, res.effective_fuse_steps) == (21, 8)
    pts = fw_path(Xt, y, [0.5, 1.0], cfg, device="cpu").points
    assert [pt.iterations for pt in pts] == [21, 21]


@pytest.mark.parametrize("change", [dict(sampling="block", block_size=8),
                                    dict(sampling="full")])
def test_fused_chunk_falls_back_where_the_stream_cannot_be_drawn_ahead(change):
    Xt, y = _problem()
    cfg = FWConfig(delta=1.0, kappa=8, max_iters=5, fuse_steps=8, **change)
    res = fw_solve(Xt, y, cfg, TorchSampler(0, "cpu"), device="cpu")
    assert res.effective_fuse_steps == 1 and res.iterations <= 5


def test_fused_chunk_with_live_alpha_scores_is_not_ported():
    """An oracle whose chunk needs live alpha values: the elastic-net's now
    chunks through K4 with the alpha ledger (its plain version on the CPU),
    K steps a turn; an oracle whose fused algebra is neither the lasso's nor
    the elastic-net's is refused by the chunk itself."""

    class AlphaOracle(LassoOracle):
        fused_needs_alpha = True

    Xt, y = _problem()
    cfg = FWConfig(delta=1.0, kappa=5, max_iters=3, fuse_steps=8)
    res = engine.solve(ENOracle(l2=1.0), Xt, y, cfg, TorchSampler(0, "cpu"), device="cpu")
    assert (res.iterations, res.effective_fuse_steps) == (3, 8)
    with pytest.raises(NotImplementedError, match="lasso's and the elastic-net's"):
        engine.solve(AlphaOracle(), Xt, y, cfg, TorchSampler(0, "cpu"), device="cpu")
    res = engine.solve(AlphaOracle(), Xt, y, dataclasses.replace(cfg, fuse_steps=1),
                       TorchSampler(0, "cpu"), device="cpu")
    assert res.iterations == 3


def test_config_validates_and_defaults_to_the_kernels():
    assert FWConfig(delta=1.0).backend == "kernels"
    with pytest.raises(ValueError, match="unknown backend"):
        FWConfig(delta=1.0, backend="xla")
    with pytest.raises(ValueError, match="unknown step_rule"):
        FWConfig(delta=1.0, step_rule="greedy")
    assert convert.config_from_reference({"delta": 2.0, "backend": "xla"}).backend == "torch"
    assert convert.config_from_reference({"delta": 2.0, "backend": "pallas"}).backend == "kernels"
    assert convert.config_from_reference({"delta": 2.0, "backend": "sparse"}).backend == "sparse"
    dcfg = convert.config_from_reference(
        {"delta": 2.0, "backend": "distributed",
         "dist": {"n_data": 2, "n_model": 2, "data_axis": "data", "model_axis": "model"}})
    assert dcfg.backend == "distributed" and (dcfg.dist.n_data, dcfg.dist.n_model) == (2, 2)
    with pytest.raises(ValueError, match="carry across"):
        convert.config_from_reference({"delta": 2.0, "backend": "tpu"})


def test_stream_sampler_checks_its_stream():
    draws = torch.tensor([[0, 3], [1, 2]])
    s = StreamSampler(draws)
    assert s.uniform(2, 4).tolist() == [0, 3] and s.uniform(2, 4).tolist() == [1, 2]
    with pytest.raises(RuntimeError, match="ran out"):
        s.uniform(2, 4)
    assert StreamSampler(draws).uniform_chunk(2, 2, 4).tolist() == [[0, 3], [1, 2]]
    with pytest.raises(RuntimeError, match="ran out"):
        StreamSampler(draws).uniform_chunk(3, 2, 4)
    with pytest.raises(ValueError, match="lie in"):
        StreamSampler(draws).uniform(2, 3)
    with pytest.raises(ValueError, match="hold 2 draws"):
        StreamSampler(draws).uniform(5, 4)


def test_torch_sampler_chunk_is_its_unfused_stream():
    a, b = TorchSampler(3, "cpu"), TorchSampler(3, "cpu")
    chunk = a.uniform_chunk(4, 6, 50)
    assert chunk.shape == (4, 6)
    assert torch.equal(chunk, torch.stack([b.uniform(6, 50) for _ in range(4)]))
