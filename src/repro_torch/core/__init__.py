"""The port's solver core: config, engine, the step rules, the lasso,
elastic-net and logistic oracles, path drivers."""
from repro_torch.core import engine, path, step_rule, vertex
from repro_torch.core.engine import (ColStats, EngineState, SolveResult, history_patience,
                                     precompute_colstats, solve, solve_batched,
                                     solve_with_history)
from repro_torch.core.fw_elasticnet import ENCo, ENOracle, en_solve
from repro_torch.core.fw_lasso import (LASSO, FWState, LassoCo, LassoOracle, duality_gap,
                                       fw_solve, fw_solve_with_history, fw_step, init_state,
                                       objective)
from repro_torch.core.fw_logistic import LOGISTIC, LogisticCo, LogisticOracle, logistic_solve
from repro_torch.core.path import (PathPoint, PathResult, delta_grid, fw_path,
                                   fw_path_batched, lambda_grid)
from repro_torch.core.solver_config import DistSpec, FWConfig
from repro_torch.core.step_rule import DirStep, get_rule
from repro_torch.core.vertex import LaneSampler, LaneStreamSampler, StreamSampler, TorchSampler

__all__ = [
    "ColStats", "DirStep", "DistSpec", "ENCo", "ENOracle", "EngineState", "FWConfig", "FWState",
    "LASSO",
    "LOGISTIC", "LaneSampler", "LaneStreamSampler", "LassoCo", "LassoOracle", "LogisticCo",
    "LogisticOracle", "PathPoint", "PathResult", "SolveResult", "StreamSampler", "TorchSampler",
    "delta_grid", "duality_gap", "en_solve", "engine", "fw_path", "fw_path_batched", "fw_solve",
    "fw_solve_with_history", "fw_step", "get_rule", "history_patience", "init_state", "lambda_grid",
    "logistic_solve", "objective", "path", "precompute_colstats", "solve", "solve_batched",
    "solve_with_history", "step_rule", "vertex",
]
