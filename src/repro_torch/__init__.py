"""PyTorch port of the stochastic Frank-Wolfe lasso (``src/repro`` is the
JAX reference). The hot loop runs on an NVIDIA Hopper card through the
hand-written CUDA kernels of ``repro_torch.kernels``; every entry point
takes ``device=`` (default ``'cuda'``) and runs the kernels' plain PyTorch
versions when given ``device='cpu'``.
"""
from repro_torch.core import (
    LASSO,
    LOGISTIC,
    ENOracle,
    FWConfig,
    LaneSampler,
    LogisticOracle,
    StreamSampler,
    TorchSampler,
    delta_grid,
    en_solve,
    fw_path,
    fw_path_batched,
    fw_solve,
    fw_solve_with_history,
    logistic_solve,
    solve,
)

__all__ = [
    "ENOracle", "FWConfig", "LASSO", "LOGISTIC", "LaneSampler", "LogisticOracle",
    "StreamSampler", "TorchSampler", "delta_grid", "en_solve", "fw_path", "fw_path_batched",
    "fw_solve", "fw_solve_with_history", "logistic_solve", "solve",
]
