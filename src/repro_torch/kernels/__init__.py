"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the code path for CPU tensors) and a launch counter.

colstats:         K1, fused z^T y and ||z||^2 setup pass
fw_grad:          K2, sampled row scores + masked first-max argmax
residual_update:  K3, fused R <- (1-lam) R + lam (y - dt z)
step_tail:        the unfused lasso step after its argmax in one launch
                  (eq. 6, 8, the coefficient update, eq. 10 and the S/F
                  recursions): K3's counterpart on the path; and the away
                  and pairwise rules' direction tail (``dir_tail``, the
                  port's own: XLA in the reference)
fused_step:       K4 and K7, K fused FW iterations per launch on the dense
                  and the block-ELL layout (one cooperative grid skeleton),
                  and the one-block replay of their records into beta
sparse_grad:      K5, sampled scores over the block-ELL layout
sparse_colstats:  K6, the block-ELL setup pass z^T y and ||z||^2
cd_sweep:         a sweep of the baselines' coordinate descent (the port's
                  own: an XLA fori_loop in the reference): the screened
                  sweep's score pass and walker (``cd_score``, ``cd_walk``)
                  and the unscreened one-launch sweep (``cd_sweep_unscreened``)
health:           the guarded solve's NaN/Inf check of beta, scale and the
                  co-state in one launch (the port's own: XLA in the
                  reference's watchdog)

The distributed backend's instantiations (``*_owned``: K2's and K5's
scores on a rank's tile, +0.0 for an unowned id; ``owned_column[_lanes]``:
the winner's column on the tile; ``*_given``: the tails with that column
given, completed across the ranks) have wrappers of their own too.

K2's scores and argmax, the step's tail, the direction tail and K5 also
take L delta lanes in one launch (``*_lanes``, the batched engine's), each
with a count of its own.
The elastic-net's instantiations (the argmax with its score shift, the tail
with its line search and Q, K4 and K7 with the alpha ledger) have wrappers
of their own (``*_shifted``, ``*_en``), and so have the instantiations that
write the telemetry ring's record (``*_tel``: the step tail's four and the
replay's). Every wrapper counts the launches of its kernel in its
``launches`` attribute.

The CUDA sources are in ``csrc/`` and build on first use (``_build``).
"""
from repro_torch.kernels import (
    cd_sweep,
    colstats,
    fused_step,
    fw_grad,
    health,
    residual_update,
    sparse_colstats,
    sparse_grad,
    step_tail,
)

_WRAPPERS = {
    "colstats": colstats.colstats,
    "sampled_scores": fw_grad.sampled_scores,
    "vertex_argmax": fw_grad.vertex_argmax,
    "residual_update": residual_update.residual_update,
    "step_tail": step_tail.step_tail,
    "dense_fused_chunk": fused_step.dense_fused_chunk,
    "fused_replay": fused_step.fused_replay,
    "sparse_sampled_scores": sparse_grad.sparse_sampled_scores,
    "sparse_colstats": sparse_colstats.sparse_colstats,
    "sparse_fused_chunk": fused_step.sparse_fused_chunk,
    "sampled_scores_lanes": fw_grad.sampled_scores_lanes,
    "vertex_argmax_lanes": fw_grad.vertex_argmax_lanes,
    "step_tail_lanes": step_tail.step_tail_lanes,
    "sparse_sampled_scores_lanes": sparse_grad.sparse_sampled_scores_lanes,
    "vertex_argmax_shifted": fw_grad.vertex_argmax_shifted,
    "vertex_argmax_shifted_lanes": fw_grad.vertex_argmax_shifted_lanes,
    "step_tail_en": step_tail.step_tail_en,
    "step_tail_en_lanes": step_tail.step_tail_en_lanes,
    "dense_fused_chunk_en": fused_step.dense_fused_chunk_en,
    "sparse_fused_chunk_en": fused_step.sparse_fused_chunk_en,
    "dir_tail": step_tail.dir_tail,
    "dir_tail_en": step_tail.dir_tail_en,
    "cd_sweep_unscreened": cd_sweep.cd_sweep_unscreened,
    "cd_score": cd_sweep.cd_score,
    "cd_walk": cd_sweep.cd_walk,
    "step_tail_tel": step_tail.step_tail_tel,
    "step_tail_en_tel": step_tail.step_tail_en_tel,
    "step_tail_lanes_tel": step_tail.step_tail_lanes_tel,
    "step_tail_en_lanes_tel": step_tail.step_tail_en_lanes_tel,
    "fused_replay_tel": fused_step.fused_replay_tel,
    "health_flags": health.health_flags,
    "sampled_scores_owned": fw_grad.sampled_scores_owned,
    "sampled_scores_lanes_owned": fw_grad.sampled_scores_lanes_owned,
    "sparse_sampled_scores_owned": sparse_grad.sparse_sampled_scores_owned,
    "sparse_sampled_scores_lanes_owned": sparse_grad.sparse_sampled_scores_lanes_owned,
    "owned_column": step_tail.owned_column,
    "owned_column_lanes": step_tail.owned_column_lanes,
    "step_tail_given": step_tail.step_tail_given,
    "step_tail_given_tel": step_tail.step_tail_given_tel,
    "step_tail_en_given": step_tail.step_tail_en_given,
    "step_tail_en_given_tel": step_tail.step_tail_en_given_tel,
    "step_tail_lanes_given": step_tail.step_tail_lanes_given,
    "step_tail_lanes_given_tel": step_tail.step_tail_lanes_given_tel,
    "step_tail_en_lanes_given": step_tail.step_tail_en_lanes_given,
    "step_tail_en_lanes_given_tel": step_tail.step_tail_en_lanes_given_tel,
    "dir_tail_given": step_tail.dir_tail_given,
    "dir_tail_en_given": step_tail.dir_tail_en_given,
    "dir_tail_lanes": step_tail.dir_tail_lanes,
    "dir_tail_en_lanes": step_tail.dir_tail_en_lanes,
    "dir_tail_lanes_given": step_tail.dir_tail_lanes_given,
    "dir_tail_en_lanes_given": step_tail.dir_tail_en_lanes_given,
}


def launch_counts() -> dict:
    """Launches of each kernel since the counts were last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
