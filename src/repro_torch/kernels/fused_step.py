"""K4: K fused FW iterations per launch on the dense layout, and the replay
of its step records into the coefficient state.

``dense_fused_chunk`` runs K = ``idx.shape[0]`` lasso FW iterations: each
scores its kappa pregathered rows of ``Xt`` against the live residual,
takes the first max of ``|score|`` in sample order, runs the closed-form
line search (eq. 8), updates the residual (eq. 10) and the S/F recursions
with the exact refresh every ``refresh_every`` steps; steps at
``k0 + s >= max_iters`` write their record but change no state. It
returns ``(i_star (K,), lam (K,), delta_t (K,), no_progress (K,),
resid_out (m,), (S, F, Q))``. ``fused_replay`` then applies the records to
``beta`` and the stopping statistics with ``engine.apply_coeff_update``'s
op sequence.

Replaces the Pallas kernel ``_fused_kernel`` at
``src/repro/kernels/fused_step/fused_step.py:259`` (entry
``dense_fused_chunk`` at :310), in its lasso form: the elastic-net's
alpha ledger (:137-139, :158-162, :226-230) waits for ROADMAP.md Queue 1
item 8. ``fused_replay`` replaces the reference's XLA ``fori_loop``
``_fused_replay`` (``src/repro/core/engine.py:387``).

Bound on an H100: bytes. A step reads its kappa rows once, their indices
and pregathered statistics, and y, the residual and the winner's row:
kappa*m*4 + kappa*16 + 3*m*4 bytes, 137.4 MB at the paper size (kappa =
42,723, m = 800), 41.0 us at 3.35 TB/s; a chunk of K = 8 about 0.33 ms,
plus one grid barrier per step. The replay moves a few bytes per record
(and 2*p*4 on the rare renorm), so it is bound by its launch.

Design. The TPU runs the (K, kappa) grid in order on one core and carries
the winner and the residual in VMEM. Hopper blocks run in no order and
carry nothing, and one block cannot read 137 MB a step. So the kernel is
one persistent cooperative grid (every block resident, sized by the
occupancy calculator, launched with ``cudaLaunchCooperativeKernel``) with
one grid sync per step: each block scores its share of the rows (one warp
per row, K2's ``warp_row_score``) against its own shared-memory copy of
the residual, keeps a first-max carry (K2's comparator: NaN largest, ties
to the first in sample order) and writes it to a partial buffer indexed by
step parity; after the sync every block reduces all partials in the same
order, so every block holds the same winner, computes the line search and
the S/F recursions redundantly with ``_rn`` intrinsics in the op order of
``core/fw_lasso.py`` (identical scalars everywhere), reads the winner's
row and updates its own residual (K3's op order). The double-buffered
partials need no second sync. Block 0 writes the records, the final
residual and (S, F, Q). ``m`` is capped by shared memory (two (m,) f32
vectors a block): ``M_MAX``.

``fused_replay`` is one block launched once per chunk: thread 0 walks the
K records in order with ``_rn`` intrinsics, and the whole block multiplies
``beta`` only when the scale underflows (the unfused step multiplies it by
exactly 1 on every other step). It matches its plain version, the loop
over ``apply_coeff_update``, bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fw_grad import sampled_scores_plain
from repro_torch.kernels.residual_update import residual_update_plain

M_MAX = 24_576  # two (m,) f32 vectors in a block's shared memory: 192 KB
REC = 8  # record row: lam, delta_t, raw, sel, stall flag, 0, 0, 0
PARTIAL_BYTES = 16  # one block's (|score|, score, position) per step parity

_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# (X, y, r0, s0, f0, q0, delta, idx, zty_s, zn2_s, p, m, K, kappa, k0, max_iters,
#  refresh_every, eps_den, gap_rtol, i_star, recs, no_prog, r_out, s_out, partials,
#  blocks, stream)
_CHUNK_ARGTYPES = ([_PTR] * 10 + [_I64, _I32, _I32, _I64, _I64, _I64, _I32, _F32, _F32]
                   + [_PTR] * 6 + [_I32, _PTR])
# (beta, p, scale, maxabs, step_inf, stall, i_star, lam, lam_stride, dt, dt_stride,
#  no_prog, K, k0, max_iters, renorm_threshold, eps_den, tol, f_out, stall_out, stream)
_REPLAY_ARGTYPES = ([_PTR, _I64] + [_PTR] * 6 + [_I64, _PTR, _I64, _PTR, _I32, _I64, _I64]
                    + [_F32] * 3 + [_PTR] * 3)

_grid_blocks: Dict[Tuple[int, int], int] = {}


def _f32(x: float) -> float:
    """A config constant as the f32 that torch's f32 ops compare with."""
    return float(np.float32(x))


def _check_lasso(oracle) -> None:
    if getattr(oracle, "fused_kind", None) != "lasso" or oracle.fused_needs_alpha:
        raise NotImplementedError(
            "the fused chunk runs the lasso's algebra only; the elastic-net's "
            "alpha ledger is ROADMAP.md Queue 1 item 8"
        )


def _check_chunk(Xt, y, resid, idx, zty_s, zn2_s):
    if Xt.dim() != 2 or y.shape != (Xt.shape[1],) or resid.shape != y.shape:
        raise ValueError(
            f"need Xt (p, m), y (m,), resid (m,), got {tuple(Xt.shape)}, "
            f"{tuple(y.shape)}, {tuple(resid.shape)}"
        )
    if idx.dim() != 2 or idx.numel() == 0 or zty_s.shape != idx.shape or zn2_s.shape != idx.shape:
        raise ValueError(
            f"need idx, zty_s, zn2_s of one shape (K, kappa), got {tuple(idx.shape)}, "
            f"{tuple(zty_s.shape)}, {tuple(zn2_s.shape)}"
        )


def dense_fused_chunk_plain(Xt, y, resid, scal, idx, zty_s, zn2_s, k0: int, delta, *,
                            oracle, eps_den, gap_rtol, refresh_every: int, max_iters: int):
    """The plain PyTorch version (reference ``kernels/fused_step/ref.py``):
    the same per-step ops as the unfused step on the 'kernels' backend
    (its scores, its argmax, the oracle's scalar algebra, eq. 10), so a
    chunk on CPU tensors replays fuse_steps=1 bit for bit."""
    K = idx.shape[0]
    y = y.float()
    resid = resid.float()
    delta = torch.as_tensor(delta, dtype=torch.float32, device=y.device)
    scal3 = tuple(scal)
    recs = []
    for s in range(K):
        ids = idx[s]
        raw = sampled_scores_plain(Xt, resid, ids, 1)
        j = torch.argmax(raw.abs()).view(1)
        i_star = ids.index_select(0, j).view(())
        g = raw.index_select(0, j).view(())
        zty_i = zty_s[s].index_select(0, j).view(())
        zn2_i = zn2_s[s].index_select(0, j).view(())
        delta_t = -delta * torch.sign(g)
        lam, no_progress, g_lin = oracle.fused_line_search(
            scal3, g, g, None, delta_t, zty_i, zn2_i, eps_den, gap_rtol
        )
        recs.append((i_star, lam, delta_t, no_progress))
        k = k0 + s
        if k < max_iters:
            z = Xt.index_select(0, i_star.view(1)).view(-1)
            resid = residual_update_plain(resid, y, z, lam, delta_t)
            s_quad, f_lin, q = oracle.fused_scalar_update(
                scal3, g_lin, None, lam, delta_t, zty_i, zn2_i
            )
            if k % refresh_every == refresh_every - 1:  # exact S/F refresh
                v = y - resid
                s_quad, f_lin = torch.dot(v, v), torch.dot(v, y)
            scal3 = (s_quad, f_lin, q)
    i_stars, lams, delta_ts, no_progs = (torch.stack(c) for c in zip(*recs))
    return i_stars, lams, delta_ts, no_progs, resid, scal3


def _blocks(dev: torch.device, m: int) -> int:
    key = (dev.index, m)
    if key not in _grid_blocks:
        fn = _build.function("fused_step", "dense_fused_chunk_blocks", [_I32, _PTR])
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = fn(m, ctypes.addressof(out))
        _build.check("fused_step", err, "dense_fused_chunk occupancy query")
        _grid_blocks[key] = out.value
    return _grid_blocks[key]


def dense_fused_chunk(Xt: torch.Tensor, y: torch.Tensor, resid: torch.Tensor, scal,
                      idx: torch.Tensor, zty_s: torch.Tensor, zn2_s: torch.Tensor, k0: int,
                      delta, *, oracle, eps_den: float, gap_rtol: float, refresh_every: int,
                      max_iters: int):
    """K fused FW steps over the dense feature-major ``Xt``. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (or raises).
    ``scal`` is the chunk-start (S, F, Q) as 0-d tensors, ``delta`` a 0-d
    tensor, ``k0`` the global iteration count at the chunk start."""
    _check_chunk(Xt, y, resid, idx, zty_s, zn2_s)
    _check_lasso(oracle)
    kw = dict(oracle=oracle, eps_den=eps_den, gap_rtol=gap_rtol,
              refresh_every=refresh_every, max_iters=max_iters)
    if Xt.device.type == "cpu":
        return dense_fused_chunk_plain(Xt, y, resid, scal, idx, zty_s, zn2_s, k0, delta, **kw)
    p, m = Xt.shape
    K, kappa = idx.shape
    if m > M_MAX:
        raise ValueError(
            f"the fused chunk keeps two (m,) f32 vectors in shared memory: m <= {M_MAX}, "
            f"got {m}"
        )
    if any(t.dtype != torch.float32 for t in (Xt, y, resid, zty_s, zn2_s)):
        raise TypeError("the fused chunk runs in float32")
    dev = Xt.device
    s0, f0, q0 = (torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(()) for x in scal)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev).reshape(())
    idx = idx.long()
    _build.require_cuda(Xt, y, resid, s0, f0, q0, delta, idx, zty_s, zn2_s)
    blocks = _blocks(dev, m)
    i_star = torch.empty(K, dtype=torch.int64, device=dev)
    recs = torch.empty((K, REC), dtype=torch.float32, device=dev)
    no_prog = torch.empty(K, dtype=torch.bool, device=dev)
    r_out = torch.empty(m, dtype=torch.float32, device=dev)
    s_out = torch.empty(3, dtype=torch.float32, device=dev)
    partials = torch.empty(2 * blocks * PARTIAL_BYTES, dtype=torch.uint8, device=dev)
    fn = _build.function("fused_step", "dense_fused_chunk_launch", _CHUNK_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), y.data_ptr(), resid.data_ptr(), s0.data_ptr(), f0.data_ptr(),
                 q0.data_ptr(), delta.data_ptr(), idx.data_ptr(), zty_s.data_ptr(),
                 zn2_s.data_ptr(), p, m, K, kappa, int(k0), int(max_iters),
                 int(refresh_every), _f32(eps_den), _f32(gap_rtol), i_star.data_ptr(),
                 recs.data_ptr(), no_prog.data_ptr(), r_out.data_ptr(), s_out.data_ptr(),
                 partials.data_ptr(), blocks, _build.stream(dev))
        dense_fused_chunk.launches += 1
    _build.check("fused_step", err, "dense_fused_chunk (cooperative)")
    return i_star, recs[:, 0], recs[:, 1], no_prog, r_out, (s_out[0], s_out[1], s_out[2])


def fused_replay_plain(beta, scale, maxabs, step_inf, stall, i_stars, lams, delta_ts,
                       no_progs, k0: int, cfg):
    """The plain version: the unfused step's own ``apply_coeff_update``,
    record by record, skipping records at k >= cfg.max_iters. Updates
    ``beta`` in place; returns ``(beta, scale, maxabs, step_inf, stall)``."""
    from repro_torch.core.engine import apply_coeff_update  # core imports kernels

    for t in range(min(i_stars.shape[0], cfg.max_iters - k0)):
        i_star = i_stars[t]
        a_star = scale * beta.index_select(0, i_star.view(1)).view(())
        beta, scale, maxabs, step_inf, stall = apply_coeff_update(
            beta, scale, maxabs, stall, a_star, i_star, lams[t], delta_ts[t], no_progs[t], cfg
        )
    return beta, scale, maxabs, step_inf, stall


def fused_replay(beta: torch.Tensor, scale: torch.Tensor, maxabs: torch.Tensor,
                 step_inf: torch.Tensor, stall: torch.Tensor, i_stars: torch.Tensor,
                 lams: torch.Tensor, delta_ts: torch.Tensor, no_progs: torch.Tensor,
                 k0: int, cfg):
    """Apply a chunk's records to ``beta`` (in place) and the stopping
    statistics; ``cfg`` gives max_iters, renorm_threshold, eps_den and tol.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel. Returns ``(beta, scale, maxabs, step_inf, stall)``."""
    K = i_stars.shape[0]
    if (beta.dim() != 1 or i_stars.dim() != 1 or lams.shape != (K,)
            or delta_ts.shape != (K,) or no_progs.shape != (K,)):
        raise ValueError("need beta (p,) and records i_stars, lams, delta_ts, no_progs (K,)")
    if beta.device.type == "cpu":
        return fused_replay_plain(beta, scale, maxabs, step_inf, stall, i_stars, lams,
                                  delta_ts, no_progs, k0, cfg)
    if beta.dtype != torch.float32 or lams.dtype != torch.float32 or delta_ts.dtype != torch.float32:
        raise TypeError("the replay runs in float32")
    dev = beta.device
    scale, maxabs, step_inf = (t.float().reshape(()) for t in (scale, maxabs, step_inf))
    stall = stall.to(torch.int32).reshape(())
    i_stars = i_stars.long().contiguous()
    no_progs = no_progs.to(torch.bool).contiguous()
    _build.require_cuda(beta, scale, maxabs, step_inf, stall, i_stars, no_progs)
    if lams.device != dev or delta_ts.device != dev:
        raise ValueError("the records must lie on beta's device")
    f_out = torch.empty(3, dtype=torch.float32, device=dev)
    stall_out = torch.empty((), dtype=torch.int32, device=dev)
    fn = _build.function("fused_step", "fused_replay_launch", _REPLAY_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(beta.data_ptr(), beta.shape[0], scale.data_ptr(), maxabs.data_ptr(),
                 step_inf.data_ptr(), stall.data_ptr(), i_stars.data_ptr(), lams.data_ptr(),
                 lams.stride(0), delta_ts.data_ptr(), delta_ts.stride(0), no_progs.data_ptr(),
                 K, int(k0), int(cfg.max_iters), _f32(cfg.renorm_threshold), _f32(cfg.eps_den),
                 _f32(cfg.tol), f_out.data_ptr(), stall_out.data_ptr(), _build.stream(dev))
        fused_replay.launches += 1
    _build.check("fused_step", err, "fused_replay")
    return beta, f_out[0], f_out[1], f_out[2], stall_out


dense_fused_chunk.launches = 0
fused_replay.launches = 0
