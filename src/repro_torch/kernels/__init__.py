"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the code path for CPU tensors) and a launch counter.

colstats:         K1, fused z^T y and ||z||^2 setup pass
fw_grad:          K2, sampled row scores + masked first-max argmax
residual_update:  K3, fused R <- (1-lam) R + lam (y - dt z)
fused_step:       K4, K fused FW iterations per launch (a cooperative grid),
                  and the one-block replay of its records into beta

The CUDA sources are in ``csrc/`` and build on first use (``_build``).
"""
from repro_torch.kernels import colstats, fused_step, fw_grad, residual_update

_WRAPPERS = {
    "colstats": colstats.colstats,
    "sampled_scores": fw_grad.sampled_scores,
    "vertex_argmax": fw_grad.vertex_argmax,
    "residual_update": residual_update.residual_update,
    "dense_fused_chunk": fused_step.dense_fused_chunk,
    "fused_replay": fused_step.fused_replay,
}


def launch_counts() -> dict:
    """Launches of each kernel since the counts were last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
