"""PyTorch port of the stochastic Frank-Wolfe lasso (``src/repro`` is the
JAX reference). The hot loop runs on an NVIDIA Hopper card through the
hand-written CUDA kernels of ``repro_torch.kernels``; every entry point
takes ``device=`` (default ``'cuda'``) and runs the kernels' plain PyTorch
versions when given ``device='cpu'``. The paper's baselines
(``baselines.cd_solve``, ``baselines.fista_solve``, ``cd_path``,
``fista_path``) run on the device of the tensors they are given (the card
for numpy inputs); coordinate descent sweeps through the screened
``cd_sweep`` (a score pass and the walker kernel).
"""
from repro_torch.core import (
    LASSO,
    LOGISTIC,
    CDConfig,
    ENOracle,
    FISTAConfig,
    FWConfig,
    LaneSampler,
    LogisticOracle,
    StreamSampler,
    TorchSampler,
    baselines,
    cd_path,
    delta_grid,
    en_solve,
    fista_path,
    fw_path,
    fw_path_batched,
    fw_solve,
    fw_solve_with_history,
    logistic_solve,
    projections,
    solve,
)

__all__ = [
    "CDConfig", "ENOracle", "FISTAConfig", "FWConfig", "LASSO", "LOGISTIC", "LaneSampler",
    "LogisticOracle", "StreamSampler", "TorchSampler", "baselines", "cd_path", "delta_grid", "en_solve",
    "fista_path", "fw_path", "fw_path_batched", "fw_solve", "fw_solve_with_history",
    "logistic_solve", "projections", "solve",
]
