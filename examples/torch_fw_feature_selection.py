"""FW-Lasso on LM internals with the PyTorch port: sparse linear probing
of LM hidden states, the paper's p >> m regime (``examples/
fw_feature_selection.py``'s run, on the card).

Collects per-token activations from a small LM (windows of 4 positions),
then uses stochastic FW on the kernels' backend (K1's column statistics,
K2's sampled scores and its argmax, the step's tail: one launch each a
step) to select a sparse set of features that linearly predict the
next-token logit of a target token.

    PYTHONPATH=src python examples/torch_fw_feature_selection.py
    PYTHONPATH=src python examples/torch_fw_feature_selection.py --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FWConfig, TorchSampler, fw_solve  # noqa: E402
from repro_torch.core.engine import resolve_device  # noqa: E402
from repro_torch.core.sampling import kappa_percentile  # noqa: E402
from repro_torch.data.lm_pipeline import batch_at_step  # noqa: E402
from repro_torch.data.synthetic import Dataset, standardize  # noqa: E402
from repro_torch.launch.serve import set_matmul_precision  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

LAUNCHES = ("colstats", "sampled_scores", "vertex_argmax", "step_tail")


def features(cfg, params, dev, n_batches=8, B=4, S=64, target_token=7):
    """(X (400, 4 * d_model), y (400,)) in numpy: windows of 4 positions of
    the logits' first d_model channels, and the target token's logit 4
    positions on."""
    feats, targets = [], []
    with torch.no_grad():
        for i in range(n_batches):
            batch = batch_at_step(cfg, i, batch=B, seq_len=S, seed=1)
            tokens = torch.from_numpy(batch["tokens"][:, :-1]).to(dev)
            logits = M.forward(params, {"tokens": tokens}, cfg)  # (B, S, V)
            h = logits[..., :cfg.d_model]  # proxy features from the logit space
            window = torch.cat([h[:, j:S - 4 + j, :] for j in range(4)], -1)
            feats.append(window.reshape(-1, window.shape[-1]).cpu().numpy())
            targets.append(logits[:, 4:, target_token].reshape(-1).cpu().numpy())
    return np.concatenate(feats)[:400], np.concatenate(targets)[:400]


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-iters", type=int, default=5000)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        set_matmul_precision()
    cfg = get_config("deepseek_7b").reduced(d_model=256, n_layers=4, vocab_size=2048)
    params = M.init_params(0, cfg, dev)
    X, y = features(cfg, params, dev)
    p = X.shape[1]
    print(f"[probe] m={X.shape[0]} samples, p={p} features (p >> m after windowing)")

    ds = standardize(Dataset(X.astype(np.float32), y.astype(np.float32), None, None, None,
                             "probe"))
    Xt = torch.from_numpy(np.ascontiguousarray(ds.X.T)).to(dev)
    yv = torch.from_numpy(ds.y).to(dev)

    kappa = min(p, kappa_percentile(0.02, 0.98))
    delta = float(torch.max(torch.abs(Xt @ yv))) * 0.02
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = fw_solve(Xt, yv, FWConfig(delta=delta, kappa=kappa, max_iters=args.max_iters,
                                    tol=1e-4, backend="kernels"), TorchSampler(0, dev),
                   device=dev)
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    r2 = 1.0 - 2 * float(res.objective) / float(torch.sum(yv ** 2))
    active = int(res.active)
    print(f"[probe] FW fit in {dt:.2f}s: {active} / {p} features selected, "
          f"train R^2={r2:.3f}, {res.iterations} steps")
    idx = torch.nonzero(res.alpha).reshape(-1).cpu().tolist()
    print(f"[probe] selected feature ids (first 12): {idx[:12]}")
    print("[probe] launches: " + ", ".join(f"{k} {counts[k]}" for k in LAUNCHES)
          + f" ({'the kernels' if dev.type == 'cuda' else 'their plain versions on the CPU'})")
    if dev.type == "cuda" and not all(counts[k] for k in LAUNCHES):
        raise RuntimeError(f"the solve on the card skipped a kernel: {counts}")
    return 0, dict(p=p, m=X.shape[0], active=active, r2=r2, iterations=res.iterations,
                   seconds=dt, launches={k: counts[k] for k in LAUNCHES}, alpha=res.alpha.cpu())


if __name__ == "__main__":
    sys.exit(main()[0])
