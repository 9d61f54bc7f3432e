"""The port's solver core: config, engine, the step rules, the lasso,
elastic-net and logistic oracles, path drivers, and the paper's baselines
(``baselines``: coordinate descent and FISTA; ``projections``). As in the
reference, ``SolveResult`` here is the engine's; the baselines' is
``baselines.SolveResult``."""
from repro_torch.core import baselines, engine, path, projections, sampling, step_rule, vertex
from repro_torch.core.engine import (ColStats, EngineState, SolveResult, history_patience,
                                     precompute_colstats, solve, solve_batched,
                                     solve_with_history)
from repro_torch.core.fw_elasticnet import ENCo, ENOracle, en_solve
from repro_torch.core.fw_lasso import (LASSO, FWResult, FWState, LassoCo, LassoOracle, duality_gap,
                                       fw_solve, fw_solve_with_history, fw_step, init_state,
                                       objective)
from repro_torch.core.fw_logistic import LOGISTIC, LogisticCo, LogisticOracle, logistic_solve
from repro_torch.core.path import (PathPoint, PathResult, cd_path, delta_grid, fista_path,
                                   fw_path, fw_path_batched, lambda_grid)
from repro_torch.core.solver_config import CDConfig, DistSpec, FISTAConfig, FWConfig
from repro_torch.core.step_rule import DirStep, get_rule
from repro_torch.core.vertex import LaneSampler, LaneStreamSampler, StreamSampler, TorchSampler

__all__ = [
    "CDConfig", "ColStats", "DirStep", "DistSpec", "FISTAConfig", "ENCo", "ENOracle", "EngineState", "FWConfig", "FWResult", "FWState",
    "LASSO",
    "LOGISTIC", "LaneSampler", "LaneStreamSampler", "LassoCo", "LassoOracle", "LogisticCo",
    "LogisticOracle", "PathPoint", "PathResult", "SolveResult", "StreamSampler", "TorchSampler",
    "baselines", "cd_path", "delta_grid", "duality_gap", "en_solve", "engine", "fista_path", "fw_path", "fw_path_batched", "fw_solve",
    "fw_solve_with_history", "fw_step", "get_rule", "history_patience", "init_state", "lambda_grid",
    "logistic_solve", "objective", "path", "precompute_colstats", "projections", "sampling", "solve", "solve_batched",
    "solve_with_history", "step_rule", "vertex",
]
