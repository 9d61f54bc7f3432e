"""The training slice's entry points on the CPU at small sizes (a file of
their own, beside ``test_torch_entry_points.py``, whose imports and
card-by-default checks cover them too): ``python -m
repro_torch.launch.train`` with its checkpoint and resume,
``examples/torch_train_lm.py``, ``examples/torch_fw_feature_selection.py``
(its solve a direct ``fw_solve`` of the same features, bit for bit) and
``examples/torch_compressed_dp.py`` (4 gloo ranks).
"""
import numpy as np
import torch

from test_torch_entry_points import _load

def test_train_launcher_runs_and_resumes_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch mamba2_130m --reduced
    --device cpu``: 3 steps with a checkpoint at the end; run again, it
    resumes at step 3 with nothing left to do; both checkpoints are kept."""
    from repro_torch.launch import train

    argv = ["--arch", "mamba2_130m", "--reduced", "--device", "cpu", "--steps", "3", "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    rc, out = train.main(argv)
    assert rc == 0 and out["start"] == 0 and out["steps"] == 3 and out["card"] == "cpu"
    assert all(np.isfinite(out["history"]))
    rc, again = train.main(argv)
    assert rc == 0 and again["start"] == 3 and again["steps"] == 0
    assert sorted(p.name for p in (tmp_path / "mamba2_130m").glob("step_*")) == [
        "step_0000000002", "step_0000000003"]


def test_train_example_runs_on_cpu(tmp_path):
    """``examples/torch_train_lm.py`` at a small size: the loss falls on the
    copy-motif stream, checkpoints at steps 10 and 12."""
    rc, out = _load("train_lm").main(["--device", "cpu", "--steps", "12", "--batch", "4",
                                      "--seq", "32", "--d-model", "64", "--layers", "2",
                                      "--ckpt-dir", str(tmp_path)])
    assert rc == 0 and out["steps"] == 12 and out["checkpoints"] == 2
    assert out["history"][-1] < out["history"][0]


def test_feature_selection_example_runs_on_cpu():
    """``examples/torch_fw_feature_selection.py``: features from the port's
    LM, then FW on the kernels' backend (its plain versions here, so no
    launch is counted); its alpha is a direct ``fw_solve`` of the same
    features, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core import FWConfig, TorchSampler, fw_solve
    from repro_torch.core.sampling import kappa_percentile
    from repro_torch.data.synthetic import Dataset, standardize
    from repro_torch.models import model as M

    mod = _load("fw_probe")
    rc, out = mod.main(["--device", "cpu", "--max-iters", "300"])
    assert rc == 0 and (out["m"], out["p"]) == (400, 1024) and out["active"] > 0
    assert out["launches"] == {k: 0 for k in mod.LAUNCHES}
    cfg = get_config("deepseek_7b").reduced(d_model=256, n_layers=4, vocab_size=2048)
    X, y = mod.features(cfg, M.init_params(0, cfg, "cpu"), torch.device("cpu"))
    ds = standardize(Dataset(X, y, None, None, None, "probe"))
    Xt, yv = torch.from_numpy(np.ascontiguousarray(ds.X.T)), torch.from_numpy(ds.y)
    res = fw_solve(Xt, yv, FWConfig(delta=float(torch.max(torch.abs(Xt @ yv))) * 0.02,
                                    kappa=min(1024, kappa_percentile(0.02, 0.98)),
                                    max_iters=300, tol=1e-4, backend="kernels"),
                   TorchSampler(0, "cpu"), device="cpu")
    assert torch.equal(res.alpha, out["alpha"])


def test_compressed_dp_example_runs_on_cpu():
    """``examples/torch_compressed_dp.py``: 4 gloo ranks, one all-reduce of
    the sparse gradients a step; every rank ends on the same weights, which
    reach the least-squares solution (the reference's run prints the same
    falling errors)."""
    rc, out = _load("compressed_dp").main(["--device", "cpu"])
    assert rc == 0 and out["ranks_agree"]
    assert out["rel_err"]["600"] < 1e-3
    assert (out["dense_bytes"], out["compressed_bytes"]) == (2048, 200)
