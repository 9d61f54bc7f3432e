"""The port's solver core: config, engine, lasso oracle, path driver."""
from repro_torch.core import engine, path, vertex
from repro_torch.core.engine import ColStats, EngineState, SolveResult, solve
from repro_torch.core.fw_lasso import LASSO, LassoCo, LassoOracle, fw_solve
from repro_torch.core.path import PathPoint, PathResult, delta_grid, fw_path, lambda_grid
from repro_torch.core.solver_config import DistSpec, FWConfig
from repro_torch.core.vertex import StreamSampler, TorchSampler

__all__ = [
    "ColStats", "DistSpec", "EngineState", "FWConfig", "LASSO", "LassoCo",
    "LassoOracle", "PathPoint", "PathResult", "SolveResult", "StreamSampler",
    "TorchSampler", "delta_grid", "engine", "fw_path", "fw_solve",
    "lambda_grid", "path", "solve", "vertex",
]
