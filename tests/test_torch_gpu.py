"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips itself without a card.

This file imports neither JAX nor the reference, so it also runs where
only the port is installed; on such a machine run it without the repo's
conftest (which builds JAX fixtures):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: dot products summed in another order than the plain version
(cuBLAS) differ by rounding, within RTOL_SUM of their Cauchy-Schwarz
scale; the argmax, the residual update and the fused chunk's replay are
bit-exact. The fused chunk's records: vertices and stall flags exact (the
inputs have no near-ties), lam within RTOL_SUM, the residual within
RTOL_SUM of ||y||.
"""
import pytest
import torch

from repro_torch.core import LASSO, FWConfig
from repro_torch.kernels import colstats as cs
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import fw_grad as fw
from repro_torch.kernels import launch_counts
from repro_torch.kernels import residual_update as ru

RTOL_SUM = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["colstats", "fw_vertex", "residual_update",
                                    "dense_fused_chunk", "fused_replay"])
def test_kernel_matches_plain_on_the_card(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    before = launch_counts()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    X = torch.randn((1000, 803), generator=g, device="cuda")
    r = torch.randn(803, generator=g, device="cuda")
    scale = float(torch.linalg.vector_norm(X, dim=1).max() * torch.linalg.vector_norm(r))
    if kernel == "colstats":
        for got, want in zip(cs.colstats(X, r), cs.colstats_plain(X, r)):
            assert float((got - want).abs().max()) <= RTOL_SUM * scale
    elif kernel == "fw_vertex":
        blk = torch.randint(0, 8, (4,), generator=g, device="cuda")
        got = fw.sampled_scores(X, r, blk, 128)
        assert float((got - fw.sampled_scores_plain(X, r, blk, 128)).abs().max()) <= RTOL_SUM * scale
        i, v = fw.vertex_argmax(got, blk, 128, 1000)
        i_p, v_p = fw.argmax_plain(got, blk, 128, 1000)
        assert int(i) == int(i_p) and float(v) == float(v_p)
    elif kernel == "residual_update":
        lam, dt = torch.tensor(0.3, device="cuda"), torch.tensor(-2.0, device="cuda")
        assert torch.equal(ru.residual_update(r, r * 2, r * 3, lam, dt),
                           ru.residual_update_plain(r, r * 2, r * 3, lam, dt))
    elif kernel == "dense_fused_chunk":
        X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
        idx = torch.randint(0, 1000, (8, 300), generator=g, device="cuda")
        zero = torch.zeros((), device="cuda")
        args = (X, r, r, (zero, zero, zero), idx, (X @ r)[idx], (X * X).sum(1)[idx], 60,
                torch.tensor(20.0, device="cuda"))
        kw = dict(oracle=LASSO, eps_den=1e-12, gap_rtol=1e-6, refresh_every=64,
                  max_iters=66)
        got, want = fs.dense_fused_chunk(*args, **kw), fs.dense_fused_chunk_plain(*args, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
        assert float((got[1] - want[1]).abs().max()) <= RTOL_SUM
        assert float((got[4] - want[4]).abs().max()) <= RTOL_SUM * float(
            torch.linalg.vector_norm(r))
    else:
        cfg = FWConfig(delta=20.0, max_iters=100)
        beta = torch.randn(1000, generator=g, device="cuda")
        recs = (torch.randint(0, 1000, (8,), generator=g, device="cuda"),
                torch.linspace(0.1, 0.8, 8, device="cuda"),
                torch.full((8,), -20.0, device="cuda"), torch.rand(8, device="cuda") < 0.5)
        start = (torch.tensor(3e-6, device="cuda"), torch.tensor(0.5, device="cuda"),
                 torch.tensor(0.1, device="cuda"), torch.tensor(1, dtype=torch.int32,
                                                                 device="cuda"))
        got = fs.fused_replay(beta.clone(), *start, *recs, 0, cfg)
        want = fs.fused_replay_plain(beta.clone(), *start, *recs, 0, cfg)
        assert all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(got, want))
    launched = {k: n - before[k] for k, n in launch_counts().items()}
    assert sum(launched.values()) >= 1  # the kernel ran, not the plain version
