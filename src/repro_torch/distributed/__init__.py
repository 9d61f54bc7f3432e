"""The distributed backend (the reference's ``repro.distributed``) on
``torch.distributed``: mesh-placed sparse and dense design matrices and a
shard-aware 'distributed' backend that runs the SAME engine loop (every
oracle, step rule, both path drivers, lane pruning and the guarded solve)
on every rank of a ``(data, model)`` mesh of ranks.

    torch.distributed.init_process_group("nccl", init_method="tcp://localhost:29500",
                                         world_size=1, rank=0)   # or gloo on the CPU
    mesh = distributed.fw_mesh(n_data=1, n_model=1)
    op = distributed.shard_sparse(mat, y, mesh)   # or shard_dense /
                                                  # load_sharded_matrix
    res = distributed.solve(LASSO, op, cfg, TorchSampler(0))

Every rank calls the same entry points with samplers of the same stream.
"""
from repro_torch.distributed import backend, driver, shard
from repro_torch.distributed.driver import (
    DispatchTimeoutError,
    certified_gap,
    dispatch_policy,
    dist_config,
    fw_path,
    fw_path_batched,
    solve,
    solve_batched,
    solve_with_history,
)
from repro_torch.distributed.shard import (
    Mesh,
    ShardedOperand,
    fw_mesh,
    load_sharded_matrix,
    mesh_spec,
    shard_dense,
    shard_sparse,
)

__all__ = [
    "ShardedOperand",
    "backend",
    "certified_gap",
    "dist_config",
    "driver",
    "fw_mesh",
    "fw_path",
    "fw_path_batched",
    "load_sharded_matrix",
    "mesh_spec",
    "shard",
    "shard_dense",
    "shard_sparse",
    "solve",
    "solve_batched",
    "solve_with_history",
]
