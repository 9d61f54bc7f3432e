"""The unfused lasso step's tail in one launch: everything a step does
after its argmax; and the away and pairwise rules' direction tail.

From the winner ``i_star`` and its score ``g``, ``step_tail`` computes, in
the op order of its plain version ``step_tail_plain``, which this module
builds from the lasso's step algebra (the plain ops that every backend's
tail runs, and that ``core.engine`` and ``core.fw_lasso`` import from
here):

- eq. 6, ``delta_t = -delta * sign(g)``, and ``a_star = scale * beta[i_star]``;
- eq. 8, ``ls_closed_form``: ``lam`` and ``no_progress``;
- ``apply_coeff_update``: ``beta`` in place (the renorm only when the
  scale underflows), the new scale, ``maxabs``, ``step_inf``, ``stall``;
- eq. 10 into a new residual: on a dense ``Xt``, K3's op order over the
  row ``Xt[i_star]``; on the block-ELL layout, ``(1 - lam) r + lam y`` over
  m and then ``(-lam * delta_t) * value`` added at the winner's slots
  (``sparse_residual_update``);
- ``sf_recursion``, the S/F recursions before the periodic exact refresh,
  which stays the caller's host branch (``fw_lasso.LassoOracle.tail``).

The elastic-net's tail (``step_tail_en`` with ``ENTail(g_sel, q_norm, l2)``, the reference's
``ENOracle.line_search`` and ``update_co``, ``src/repro/core/fw_elasticnet.py:
113-143``) is the same step with the shifted score ``g_sel`` setting eq. 6's
sign, ``en_ls_closed_form`` in place of eq. 8 (``g`` is then the linear part
``g_raw``) and the Q = ||alpha||^2 recursion ``q_recursion`` beside S and F;
Q's exact refresh is the caller's host branch too
(``fw_elasticnet.ENOracle.tail``). Its kernel is an instantiation of its
own (``EN``), so a lasso launch compiles none of it. Each instantiation has
its own wrapper (``step_tail``, ``step_tail_en``, ``step_tail_lanes``,
``step_tail_en_lanes``), whose ``launches`` attribute counts its launches.

Every scalar is computed in f32; the state (``beta``, its scalars, the
residual) keeps its storage dtype, f32 or bf16, each value rounded once
when it is stored.

Replaces, on the unfused path, the Pallas kernel ``residual_update`` at
``src/repro/kernels/residual_update/residual_update.py:45`` (eq. 10 alone;
``kernels/residual_update.py`` keeps its one-to-one port) together with the
~75 eager ops around it that each were a launch of their own.

Bound on an H100: bytes. Dense: read the residual, y and the winner's row
and write the new residual, 4*m*4 bytes (12.8 KB at m = 800, 4 ns at 3.35
TB/s), and a few scalars. Sparse: 3*m*4 + nnz_max*8 bytes (193 KB at m =
16,087). A renorm step adds p*2*4 (read and write ``beta``). So the
kernel is bound by its launch, as K3 was: its gain is the launches it
removes from the step.

Design: blocks of 1024 threads, each owning 4,096 rows of the residual
(one block at m = 800, four at m = 16,087), so no block reads what another
writes. Every thread issues all its loads first (its 4 rows of the
residual, y and, dense, the winner's row; sparse, one slot of the winner
and its row's inputs); meanwhile each block's thread 0 reads the scalars
and runs the line search (common.cuh's ``lasso_line_search``, shared with
the fused chunks' ``end_step`` and the replay: ``_rn`` intrinsics, no FMA
contraction). One barrier hands the block lam and delta_t; then it writes
its rows of the new residual. On the rare renorm step (the scale below
``renorm_threshold``) the grid also multiplies all of ``beta`` but
``beta[i_star]``, which the eager ops did on every step by a factor of
exactly 1. Sparse: after a second barrier each slot of the winner rewrites
its row, in the block that owns it, from the row's f32 value plus its term
(a feature's rows are distinct); the row-0 slots (the padding, and a
stored row 0) sum their terms in block 0's shared memory, of which at most
one is nonzero, so the result has the bits of the plain version's adds in
slot order. Block 0's thread 0 updates ``beta[i_star]`` (from its value
before the step, renormalized if need be), the stopping statistics and S,
F, into fresh outputs.

The direction tail (``dir_tail``, ``dir_tail_en``): the away and pairwise
step rules' step after their FW vertex and the active-set buffer's linear
scores (``core/step_rule.DirRule``), in one cooperative launch: the away
vertex over the buffer (the elastic-net's shift ``raw + l2 * (scale *
beta[buf])`` in the shifted argmax's ``_rn`` order), the away-or-FW choice,
``u = df z_f + da z_a``, the dots ``<y - R, u>``, ``<u, u>``, ``<u, y>``,
the line search on [0, g_max], ``apply_dir_update`` (the renorm only on
underflow, a drop step's exact zero), the residual ``(1 + g t) R - g t y -
g u``, the S/F (and Q) recursions, the exact S/F refresh when the host's k
asks for it, and ``insert_active``. Its plain version ``dir_tail_plain`` is
the composition of this module's ports of the reference's ops
(``away_vertex``, ``dir_choice``, ``dir_line_search`` over
``dir_ls_closed_form``, ``apply_dir_update``, ``dir_update_co`` over
``dir_co_recursion``, ``insert_active``); the
reference runs them as XLA ops (``src/repro/core/step_rule.py:117-153,
248-318``, ``fw_lasso.py:188-226``), outside any Pallas kernel, so the
kernel is the port's own. Q's exact refresh (an O(p) dot of ``beta``) stays
the caller's host branch, as for the classic tail.

Bound on an H100: bytes, and far below the launch. Dense: R, y, the two
rows and the new residual, 5*m*4 bytes, the buffer's ids and scores,
2*32*4, and the scalars (16.3 KB at m = 800); sparse: 3*m*4 + the two
features' slots 2*nnz_max*8 (194 KB at m = 16,087). Design: blocks of 1024
threads owning 4,096 residual rows each (one block at m = 800, four at m =
16,087), a cooperative grid so that the three dots, which the line search
needs before g is known (the classic tail's line search reads only
``zty`` and ``zn2``), can be summed grid-wide: each block adds its rows'
products in a fixed order (warp butterflies, then the warps in order),
writes its partials, and after one grid sync every block's thread 0 adds
the blocks' partials in block order; a refresh step sums the new residual's
two dots the same way behind a second sync. So two launches give the same
bits. The buffer's argmax and the choice are a few hundred flops that
every block recomputes (warp 0 over the slots, thread 0 for the choice);
the sparse layout scatters the two features' slots into shared memory for
the block's rows. Every read of ``beta`` comes before the first sync and
every write after it; ``insert_active`` reads the buffer's post-step
weights from their values before the step, renormalized or moved as the
step moves them, so no block reads what another writes.

Lanes (``step_tail_lanes``): the tail of L delta lanes of the batched
engine in one launch, a row of blocks a lane. A lane listed in ``lanes``
runs exactly the one-lane launch on its row of ``beta`` and of the
residual, its scalars, winner, score and delta (the renorm's share of
``beta`` stays in the lane's row; the sparse row-0 sum is a block's, so
a lane's); a lane not listed (frozen) copies its residual and scalars to
the outputs and leaves ``beta`` alone, so that the engine's swap of the
buffers keeps its state bit for bit. Bound: L times the one-lane bytes
(the copies of the frozen lanes included).

The direction tail's lanes (``dir_tail_lanes``, ``dir_tail_en_lanes`` and
their GIVEN forms ``dir_tail[_en]_lanes_given``; the LANES instantiations of
the same kernel): the batched engine's away and pairwise rules, a row of
blocks a lane in one cooperative launch. A listed lane runs exactly the
one-lane tail on its operands (its own buffer, scores, refresh flag, its
partial dots in its own scratch, summed over its own row of blocks, the
same ``_rn`` scalar functions), so it keeps the one-lane launch's bits; a
frozen lane copies its residual, buffer and scalars to the outputs, leaves
``beta`` alone and takes the grid syncs with the others (one, and a
second when any lane refreshes). The host passes the lanes' refresh flags
as an int32 vector made once a pattern. Bound: L times the one-lane bytes.
Its plain version ``dir_tail_lanes_plain`` is the one-lane plain tail once
a listed lane.

The telemetry ring's record (``step_tail_tel`` and its EN and lane
counterparts, each an instantiation of its own, ``TEL``; a ``TailRecord``
names the ring): the tail's block 0 thread 0, which holds the step's
scalars, writes the step's record (``obs/telemetry.py``'s storage) in the
same launch: k, i_star, ``EVENT_FW``, the new stall, lam, the new
step_inf, n_dots, and, with the objective on, the sampled gap ``<grad,
alpha> - delta_t * g_sel`` from the step's input scalars and the objective
``1/2 y.y + 1/2 S - F`` (``+ l2/2 Q``) from its outputs, each op rounded to
the state's dtype as the oracle's eager ops round it. The plain version
is the plain tail followed by the plain record (``write_record``); a
step whose S and F the caller then refreshes gets its objective amended
by the caller. Lanes: a stepping lane's slot, k and n_dots come from its
cursor on the device, which the kernel advances (k = cursor, a lane's
records being its steps; n_dots = (cursor + 1) * the dots a step), so a
batched step copies nothing to the card; a frozen lane records nothing.
Bound: one record adds 40 bytes written (and the 2-4 scalars read) to the
tail's bytes.

The distributed backend (``repro_torch.distributed``) runs these tails on a
rank's sample slice with the winner's column given (a ``GivenCol``, the
``GIVEN`` instantiations: ``step_tail_given`` and its EN, lane and TEL
siblings, ``dir_tail_given``, ``dir_tail_en_given``): ``owned_column``
(and ``owned_column_lanes``, one launch for several ids) writes the
columns on the rank's tile, zeros where the tile does not own the feature,
and an ``all_reduce`` over the ranks that split the feature axis completes
them. A dense column replays eq. 10 as the dense tail; a block-ELL one adds
``(-lam * delta_t) * z[k]`` at every row, which is the single-device sum on
the column's rows and ``out + (+-0)`` elsewhere, so a mesh with one sample
slice keeps the single-device bits. The direction tail reads ``(n_buf + 2,
m)`` columns (z_f, feature 0's, each slot's), since its away vertex is
chosen inside the launch; with the samples split across ranks it runs in
two launches around an ``all_reduce`` of its three dots (``complete``),
and S and F are refreshed on the host. Bound of ``owned_column``: the
owned column's bytes (m * itemsize read, or nnz_max * 8) plus m *
itemsize written an id.
"""
from __future__ import annotations

import ctypes

import torch

from typing import NamedTuple

from repro_torch.kernels import _build
from repro_torch.kernels.residual_update import residual_update_plain
from repro_torch.obs.telemetry import EVENT_FW, write_record

_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# (X, rows, nnz_max, beta, p, scale, maxabs, stall, s_quad, f_lin, resid, y, zty, zn2,
#  i_star, g, delta, m, renorm_threshold, eps_den, gap_rtol, tol, r_out, s_out, stall_out,
#  lane_ids, n_run, n_lanes, step_inf, dtype, g_sel, q_norm, l2, tel, tel_cap, tel_slot, tel_k,
#  tel_ndots, tel_cursor, yty, half_l2, stream)
_ARGTYPES = ([_PTR, _PTR, _I32, _PTR, _I64] + [_PTR] * 12 + [_I32] + [_F32] * 4
             + [_PTR] * 4 + [_I32, _I32, _PTR, _I32, _PTR, _PTR, _F32]
             + [_PTR, _I32, _I64, _I64, _I64, _PTR, _PTR, _F32, _PTR])


# (zcol, sparse, beta, p, ...): step_tail_launch's arguments from beta on
_GIVEN_ARGTYPES = [_PTR, _I32] + _ARGTYPES[3:]
# (X, rows, nnz_max, p_local, m, off, ids, n_ids, out, dtype, stream)
_COLUMN_ARGTYPES = [_PTR, _PTR, _I32, _I64, _I32, _I64, _PTR, _I32, _PTR, _I32, _PTR]


class GivenCol(NamedTuple):
    """The winner's column given in place of the matrix (the distributed
    backend's tail on a rank's sample slice): ``z`` ``(m,)``, or ``(L, m)``
    for lanes, in the state's dtype; ``sparse`` the layout whose eq. 10 the
    tail replays."""

    z: torch.Tensor
    sparse: bool


class ENTail(NamedTuple):
    """The elastic-net's operands of the tail: the winner's shifted score
    ``g_sel`` (0-d, or ``(L,)`` for lanes), Q = ||alpha||^2 in the state's
    dtype, and the l2 strength."""

    g_sel: torch.Tensor
    q_norm: torch.Tensor
    l2: float


class TailRecord(NamedTuple):
    """The telemetry ring record a tail writes (``obs/telemetry.py``'s
    storage). One lane: the record's ``slot``, the step's ``k`` and the dot
    count after it, ``n_dots``. Lanes: ``buf`` is ``(L, RING_WORDS * C)``,
    ``n_dots`` the dots a step, ``cursors`` the lanes' host cursors (the
    plain version's slots) and ``dev_cursor`` the same ``(L,)`` int64 on
    the device, which the kernel reads and advances (slot and k unused).
    ``objective`` asks for the gap and the objective (the lasso's and the
    elastic-net's from ``yty``, y.y as a 0-d tensor in the state's dtype);
    without it they are NaN."""

    buf: torch.Tensor
    capacity: int
    slot: int
    k: int
    n_dots: int
    objective: bool = False
    yty: torch.Tensor | None = None
    cursors: list | None = None
    dev_cursor: torch.Tensor | None = None

    def lane(self, lane: int) -> "TailRecord":
        """Lane ``lane``'s one-lane record of a lane record, at its host
        cursor (the caller then advances its device cursor)."""
        c = self.cursors[lane]
        return TailRecord(self.buf[lane], self.capacity, c % self.capacity, c,
                          (c + 1) * self.n_dots, self.objective, self.yty)


def _tail_gap_objective(tel, s_in, f_in, s_out, f_out, delta_t, g_sel, en, q_out):
    """The record's sampled gap ``<grad, alpha> - delta_t * g_sel`` (S, F, Q
    the step's inputs, in the state's dtype) and the objective ``0.5 y.y +
    0.5 S - F (+ 0.5 l2 Q)`` on its outputs, the oracles' eager ops (f32
    0-d results); NaN without an objective."""
    if not tel.objective:
        return float("nan"), float("nan")
    ga = s_in - f_in
    if en is not None:
        ga = ga + en.l2 * en.q_norm
    gap = ga.float() - delta_t * g_sel
    objective = 0.5 * tel.yty + 0.5 * s_out - f_out
    if en is not None:
        objective = objective + 0.5 * en.l2 * q_out
    return gap, objective.float()


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, as a 0-d tensor, without a host sync."""
    return x.index_select(0, i.view(1)).view(())


def ls_closed_form(s_quad, f_lin, g_sel, g_lin, delta_t, zn2_i, eps_den, gap_rtol):
    """The closed-form exact line search (eq. 8) as scalar algebra.
    Returns ``(lam, no_progress, num)``; ``num`` is the sampled duality gap,
    and a step whose gap is below the fp32 rounding floor of its own terms
    counts as a stall (``gap_rtol``)."""
    num = s_quad - delta_t * g_sel - f_lin
    den = s_quad - 2.0 * delta_t * g_lin + delta_t**2 * zn2_i
    lam = torch.clamp(num / torch.clamp_min(den, eps_den), 0.0, 1.0)
    gap_scale = s_quad + torch.abs(f_lin) + torch.abs(delta_t * g_sel)
    no_progress = num <= gap_rtol * gap_scale
    return lam, no_progress, num


def sf_recursion(s_quad, f_lin, g_lin, lam, delta_t, zty_i, zn2_i):
    """The O(1) S/F scalar recursions (paper, below eq. 8)."""
    one_m = 1.0 - lam
    s_quad = (
        one_m**2 * s_quad
        + 2.0 * delta_t * lam * one_m * g_lin
        + delta_t**2 * lam**2 * zn2_i
    )
    f_lin = one_m * f_lin + delta_t * lam * zty_i
    return s_quad, f_lin


def en_ls_closed_form(l2, s_quad, f_lin, q_norm, g_x, g_lin, a_star, delta_t, zn2_i, eps_den,
                      gap_rtol):
    """The elastic-net's closed-form line search (reference
    ``core/fw_elasticnet.py:45-63``) as scalar algebra, in its op order.
    ``g_x`` is the winner's linear score, ``a_star`` its alpha value.
    Returns ``(lam, no_progress)``; ``num`` is the sampled EN duality gap."""
    num = s_quad - delta_t * g_x - f_lin + l2 * (q_norm - delta_t * a_star)
    den = (
        s_quad - 2.0 * delta_t * g_lin + delta_t**2 * zn2_i
        + l2 * (q_norm - 2.0 * delta_t * a_star + delta_t**2)
    )
    lam = torch.clamp(num / torch.clamp_min(den, eps_den), 0.0, 1.0)
    gap_scale = (
        s_quad + torch.abs(f_lin) + torch.abs(delta_t * g_x)
        + l2 * (q_norm + torch.abs(delta_t * a_star))
    )
    no_progress = num <= gap_rtol * gap_scale
    return lam, no_progress


def q_recursion(q_norm, lam, delta_t, a_star):
    """The O(1) recursion of Q = ||alpha||^2 (reference
    ``core/fw_elasticnet.py:66-74``)."""
    one_m = 1.0 - lam
    return (
        one_m**2 * q_norm
        + 2.0 * lam * one_m * delta_t * a_star
        + lam**2 * delta_t**2
    )


def apply_coeff_update(beta, scale, maxabs, stall, a_star, i_star, lam,
                       delta_t, no_progress, cfg):
    """Step 5 + stopping statistics of the FW iteration: the scaled-iterate
    coefficient update with underflow renorm (``beta`` in place), and the
    ||alpha^{k+1}-alpha^k||_inf bound / stall bookkeeping (§Stopping).
    The scalars are computed in f32 (a bf16 state's are read in f32);
    ``beta`` keeps its dtype, each update an f32 op rounded once. Returns
    ``(beta, scale, maxabs, step_inf, stall)``, the scalars in f32."""
    scale, maxabs = scale.float(), maxabs.float()
    one_m = 1.0 - lam
    new_scale = scale * one_m
    # renormalize when the scale underflows: a device-side select, not a
    # host branch, so the step never waits on it. Without a renorm beta is
    # multiplied by exactly 1, which leaves it unchanged.
    need_renorm = new_scale < cfg.renorm_threshold
    factor = torch.where(need_renorm, new_scale, 1.0)
    scale = torch.where(need_renorm, 1.0, new_scale)
    coef = delta_t * lam / torch.clamp_min(scale, cfg.eps_den)
    if beta.dtype == torch.float32:
        beta.mul_(factor)
        beta.index_add_(0, i_star.view(1), coef.view(1))
    else:
        beta.copy_(beta.float().mul_(factor))
        new_bi = _take(beta, i_star).float() + coef
        beta.index_copy_(0, i_star.view(1), new_bi.to(beta.dtype).view(1))
    # stopping statistic: ||alpha_{k+1} - alpha_k||_inf upper bound
    alpha_istar_new = scale * _take(beta, i_star).float()
    step_inf = lam * torch.maximum(maxabs, torch.abs(delta_t - a_star))
    maxabs = torch.maximum(one_m * maxabs, torch.abs(alpha_istar_new))
    stall = torch.where((step_inf <= cfg.tol) | no_progress, stall + 1, 0)
    return beta, scale, maxabs, step_inf, stall


def sparse_residual_update(resid: torch.Tensor, y: torch.Tensor, col_vals: torch.Tensor,
                           col_rows: torch.Tensor, lam, delta_t) -> torch.Tensor:
    """Eq. 10 with a sparse z_star, R <- (1-lam) R + lam (y - delta_t
    z_star): the O(m) part as two vector ops, then the z_star term added at
    its ``nnz_max`` slots (a feature's rows are distinct; padded slots add
    0.0 at row 0). Computed in f32, stored in the residual's dtype."""
    out = (1.0 - lam) * resid.float() + lam * y.float()
    out.index_add_(0, col_rows, (-lam * delta_t) * col_vals.float())
    return out.to(resid.dtype)


def given_residual_update(resid, y, col: GivenCol, lam, delta_t):
    """Eq. 10 with the winner's column given: a dense column as
    ``residual_update_plain``; a block-ELL tile's column (zero off its
    rows) as ``(1 - lam) r + lam y + (-lam * delta_t) * z`` in f32, which is
    ``sparse_residual_update``'s sum on the column's rows and ``out +
    (+-0)`` elsewhere. Stored in the residual's dtype."""
    if not col.sparse:
        return residual_update_plain(resid, y, col.z, lam, delta_t)
    out = (1.0 - lam) * resid.float() + lam * y.float()
    return (out + (-lam * delta_t) * col.z.float()).to(resid.dtype)


def step_tail_plain(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2,
                    i_star, g, delta, cfg, en=None, tel=None):
    """The plain version, the lasso step's eager ops after its argmax in
    their order (with ``en``, the elastic-net's), with the scalars in f32,
    then with ``tel`` (a one-lane ``TailRecord``) the plain record: the
    tail of 'torch' and of the plain sparse ops on any device, and of the
    kernels' backends on the CPU. Arguments and returns are
    ``step_tail``'s."""
    dtype = beta.dtype
    s_in, f_in = s_quad, f_lin
    g = g.float()
    g_sel = g if en is None else en.g_sel.float()
    delta_t = -delta * torch.sign(g_sel)  # eq. 6
    a_star = scale.float() * _take(beta, i_star).float()
    zty_i, zn2_i = _take(zty, i_star).float(), _take(znorm2, i_star).float()
    g_lin = g + zty_i  # G_{i*} = z_{i*}^T (X alpha)
    s_quad, f_lin = s_quad.float(), f_lin.float()
    if en is None:
        lam, no_progress, _ = ls_closed_form(s_quad, f_lin, g, g_lin, delta_t, zn2_i,
                                             cfg.eps_den, cfg.gap_rtol)
    else:
        q_norm = en.q_norm.float()
        lam, no_progress = en_ls_closed_form(en.l2, s_quad, f_lin, q_norm, g, g_lin, a_star,
                                             delta_t, zn2_i, cfg.eps_den, cfg.gap_rtol)
    beta, scale, maxabs, step_inf, stall = apply_coeff_update(
        beta, scale, maxabs, stall, a_star, i_star, lam, delta_t, no_progress, cfg)
    if isinstance(mat, GivenCol):
        resid = given_residual_update(resid, y, mat, lam, delta_t)
    elif isinstance(mat, tuple):
        values, rows = mat
        nnz = values.shape[-1]
        col_vals = values.reshape(-1, nnz).index_select(0, i_star.view(1)).view(-1)
        col_rows = rows.reshape(-1, nnz).index_select(0, i_star.view(1)).view(-1)
        resid = sparse_residual_update(resid, y, col_vals, col_rows, lam, delta_t)
    else:
        resid = residual_update_plain(resid, y, mat.index_select(0, i_star.view(1)).view(-1),
                                      lam, delta_t)
    s_quad, f_lin = sf_recursion(s_quad, f_lin, g_lin, lam, delta_t, zty_i, zn2_i)
    out = (beta, scale.to(dtype), maxabs.to(dtype), step_inf.to(dtype), stall, resid,
           s_quad.to(dtype), f_lin.to(dtype))
    if en is not None:
        out += (q_recursion(q_norm, lam, delta_t, a_star).to(dtype),)
    if tel is not None:
        gap, objective = _tail_gap_objective(tel, s_in, f_in, out[6], out[7], delta_t, g_sel,
                                             en, out[8] if en is not None else None)
        write_record(tel.buf, tel.capacity, tel.slot, k=tel.k, i_star=i_star, event=EVENT_FW,
                     stall=stall, lam=lam, gap=gap, objective=objective, step_inf=step_inf,
                     n_dots=tel.n_dots)
    return out


def _check(mat, beta, resid, y, zty, znorm2):
    if isinstance(mat, GivenCol):
        if mat.z.shape != y.shape or mat.z.dtype != beta.dtype:
            raise ValueError(f"need the given column (m,) = ({y.shape[0]},) in the state's "
                             f"dtype, got {tuple(mat.z.shape)} {mat.z.dtype}")
    elif isinstance(mat, tuple):
        values, rows = mat
        if values.dim() != 3 or rows.shape != values.shape:
            raise ValueError(f"need values and rows (nblocks, bs, nnz_max), got "
                             f"{tuple(values.shape)}, {tuple(rows.shape)}")
    elif mat.dim() != 2 or mat.shape[1] != y.shape[0]:
        raise ValueError(f"need Xt (p, m) with m = {y.shape[0]}, got {tuple(mat.shape)}")
    if resid.shape != y.shape or y.dim() != 1:
        raise ValueError(f"need resid and y (m,), got {tuple(resid.shape)}, {tuple(y.shape)}")
    p = beta.shape[0]
    if beta.dim() != 1 or zty.shape != (p,) or znorm2.shape != (p,):
        raise ValueError(f"need beta, zty, znorm2 (p,), got {tuple(beta.shape)}, "
                         f"{tuple(zty.shape)}, {tuple(znorm2.shape)}")


def step_tail(mat, beta: torch.Tensor, scale: torch.Tensor, maxabs: torch.Tensor,
              stall: torch.Tensor, resid: torch.Tensor, s_quad: torch.Tensor,
              f_lin: torch.Tensor, y: torch.Tensor, zty: torch.Tensor, znorm2: torch.Tensor,
              i_star: torch.Tensor, g: torch.Tensor, delta: torch.Tensor, cfg, tel=None):
    """The step's tail from its winner ``i_star`` (0-d int64) and score ``g``
    (0-d). ``mat`` is the dense ``Xt (p, m)`` or the block-ELL ``(values,
    rows)`` pair; ``beta`` (updated in place), the scalars ``scale``,
    ``maxabs``, ``s_quad``, ``f_lin``, the residual, ``y`` and the column
    statistics share one dtype (f32 or bf16), ``stall`` is int32 and
    ``delta`` a 0-d f32; ``cfg`` gives renorm_threshold, eps_den, gap_rtol
    and tol. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (or raises). Returns ``(beta, scale, maxabs, step_inf,
    stall, resid, s_quad, f_lin)``, S and F before the periodic refresh.
    ``tel`` (a ``TailRecord``) adds the step's ring record, in the kernel's
    TEL instantiation (counted on ``step_tail_tel``)."""
    return _tail(step_tail if tel is None else step_tail_tel, mat, beta, scale, maxabs, stall,
                 resid, s_quad, f_lin, y, zty, znorm2, i_star, g, delta, cfg, None, tel)


def step_tail_tel(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2, i_star,
                  g, delta, cfg, tel):
    """``step_tail`` with the ring record ``tel`` (a ``TailRecord``): the tail
    kernel's TEL instantiation."""
    return step_tail(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2,
                     i_star, g, delta, cfg, tel)


def step_tail_en(mat, beta: torch.Tensor, scale: torch.Tensor, maxabs: torch.Tensor,
                 stall: torch.Tensor, resid: torch.Tensor, s_quad: torch.Tensor,
                 f_lin: torch.Tensor, y: torch.Tensor, zty: torch.Tensor, znorm2: torch.Tensor,
                 i_star: torch.Tensor, g: torch.Tensor, delta: torch.Tensor, cfg, en,
                 tel=None):
    """The elastic-net's tail, in the tail kernel's EN instantiation:
    ``step_tail``'s arguments, ``g`` the winner's linear score, and ``en``
    (an ``ENTail``: its selected score, Q in the state's dtype and l2).
    Returns ``step_tail``'s, then Q before its refresh. ``tel`` as
    ``step_tail``'s (counted on ``step_tail_en_tel``)."""
    return _tail(step_tail_en if tel is None else step_tail_en_tel, mat, beta, scale, maxabs,
                 stall, resid, s_quad, f_lin, y, zty, znorm2, i_star, g, delta, cfg, en, tel)


def step_tail_en_tel(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2,
                     i_star, g, delta, cfg, en, tel):
    """``step_tail_en`` with the ring record ``tel``: the EN TEL
    instantiation."""
    return step_tail_en(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2,
                        i_star, g, delta, cfg, en, tel)


# the one-lane ring last checked by ``_tel_args``: (its storage, y.y, (objective,
# dtype, capacity), (the storage's and y.y's pointers)); a solve writes a record
# every step into one ring, so its checks and pointers are taken once
_ring_checked = [None]


def _ring_seen(tel, dtype):
    """The pointers of a one-lane ring ``_tel_args`` has checked (None: not
    this ring)."""
    seen = _ring_checked[0]
    if (seen is not None and seen[0] is tel.buf and seen[1] is tel.yty
            and seen[2] == (tel.objective, dtype, tel.capacity)):
        return seen[3]
    return None


def _tel_args(tel, lanes: bool, en, dtype, ptrs=None):
    """The ring's trailing arguments of ``step_tail_launch`` (null pointers:
    no record); ``ptrs`` those ``_ring_seen`` found for a one-lane ring it
    has checked."""
    if tel is None:
        return None, 0, 0, 0, 0, None, None, 0.0
    half_l2 = 0.0 if en is None else _build.f32(0.5 * en.l2)
    if ptrs is not None:
        return (ptrs[0], tel.capacity, tel.slot, tel.k, tel.n_dots, None, ptrs[1], half_l2)
    if tel.buf.dtype != torch.int32 or tel.buf.shape[-1] != 10 * tel.capacity:
        raise ValueError("the ring's storage is int32, RING_WORDS * capacity words a lane")
    if tel.objective and (tel.yty is None or tel.yty.dtype != dtype):
        raise TypeError("a record with the objective needs y.y in the state's dtype")
    if lanes and (tel.dev_cursor is None or tel.dev_cursor.dtype != torch.int64):
        raise ValueError("a lane record needs the lanes' int64 cursors on the device")
    yty_ptr = tel.yty.data_ptr() if tel.objective else None
    if not lanes:
        _ring_checked[0] = (tel.buf, tel.yty, (tel.objective, dtype, tel.capacity),
                            (tel.buf.data_ptr(), yty_ptr))
    return (tel.buf.data_ptr(), tel.capacity, 0 if lanes else tel.slot, 0 if lanes else tel.k,
            tel.n_dots, tel.dev_cursor.data_ptr() if lanes else None, yty_ptr, half_l2)


def _tail(wrapper, mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2,
          i_star, g, delta, cfg, en, tel=None):
    """``step_tail`` (``en`` None) or ``step_tail_en``: the plain version on
    a CPU tensor, else one launch, counted on ``wrapper``."""
    _check(mat, beta, resid, y, zty, znorm2)
    if beta.device.type == "cpu":
        return step_tail_plain(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty,
                               znorm2, i_star, g, delta, cfg, en, tel)
    X, rows, head_fn = _matrix_head(mat)
    sparse = rows is not None
    dtype = beta.dtype
    q_norm = None if en is None else en.q_norm
    if any(t.dtype != dtype for t in (X, scale, maxabs, s_quad, f_lin, resid, y, zty, znorm2)
           + (() if en is None else (q_norm,))):
        raise TypeError(f"{wrapper.__name__} needs the matrix, beta, its scalars, the "
                        "residual, y and the column statistics in one dtype")
    if stall.dtype != torch.int32 or i_star.dtype != torch.int64 or delta.dtype != torch.float32:
        raise TypeError(f"{wrapper.__name__} needs stall int32, i_star int64 and delta float32")
    if sparse and rows.dtype != torch.int32:
        raise TypeError(f"the row slots must be int32, got {rows.dtype}")
    g = g.float()
    g_sel = None if en is None else en.g_sel.float()
    ptrs = None if tel is None else _ring_seen(tel, dtype)
    dev = _build.require_cuda(X, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty,
                              znorm2, i_star, g, delta, *(() if rows is None else (rows,)),
                              *(() if en is None else (g_sel, q_norm)),
                              *(() if ptrs is not None else _tel_tensors(tel)))
    m = y.shape[0]
    r_out = torch.empty(m, dtype=dtype, device=dev)
    s_out = torch.empty(5 if en is None else 6, dtype=dtype, device=dev)
    stall_out = torch.empty((), dtype=torch.int32, device=dev)
    fn = head_fn()
    with torch.cuda.device(dev):
        err = fn(*_head_args(mat), beta.data_ptr(), beta.shape[0],
                 scale.data_ptr(), maxabs.data_ptr(), stall.data_ptr(), s_quad.data_ptr(),
                 f_lin.data_ptr(), resid.data_ptr(), y.data_ptr(), zty.data_ptr(),
                 znorm2.data_ptr(), i_star.data_ptr(), g.data_ptr(), delta.data_ptr(), m,
                 _build.f32(cfg.renorm_threshold), _build.f32(cfg.eps_den),
                 _build.f32(cfg.gap_rtol), _build.f32(cfg.tol), r_out.data_ptr(), s_out.data_ptr(),
                 stall_out.data_ptr(),
                 None, 1, 1, None, _build.dtype_code(beta),
                 *_en_args(en, g_sel, q_norm), *_tel_args(tel, False, en, dtype, ptrs),
                 _build.stream(dev))
        wrapper.launches += 1
    _build.check("step_tail", err, wrapper.__name__)
    return (beta, *_outs(s_out, stall_out, r_out))


def _matrix_head(mat):
    """``(X, rows, entry)`` of a tail's matrix argument: the dense ``Xt``,
    the block-ELL ``(values, rows)`` or a ``GivenCol`` (its column as X, no
    rows), and the C entry point that takes it."""
    if isinstance(mat, GivenCol):
        return mat.z, None, lambda: _build.function("step_tail", "step_tail_given_launch",
                                                    _GIVEN_ARGTYPES)
    X, rows = mat if isinstance(mat, tuple) else (mat, None)
    return X, rows, lambda: _build.function("step_tail", "step_tail_launch", _ARGTYPES)


def _head_args(mat):
    """The leading arguments of the entry point ``_matrix_head`` names."""
    if isinstance(mat, GivenCol):
        return mat.z.contiguous().data_ptr(), int(mat.sparse)
    if isinstance(mat, tuple):
        values, rows = mat
        return values.data_ptr(), rows.data_ptr(), values.shape[-1]
    return mat.data_ptr(), None, 0


def _tel_tensors(tel):
    """The ring's tensors, for the device check (the caller skips a
    one-lane ring ``_tel_args`` has checked, whose device its first launch
    checked)."""
    if tel is None:
        return ()
    out = (tel.buf, tel.yty) if tel.objective else (tel.buf,)
    return out if tel.dev_cursor is None else out + (tel.dev_cursor,)


def _en_args(en, g_sel, q_norm):
    """The elastic-net's trailing arguments of ``step_tail_launch`` (null
    pointers: the lasso's tail)."""
    if en is None:
        return None, None, 0.0
    return g_sel.data_ptr(), q_norm.data_ptr(), _build.f32(en.l2)


def _outs(s_out, stall_out, r_out):
    """``(scale, maxabs, step_inf, stall, resid, s_quad, f_lin[, q_norm])``
    from the kernel's outputs (``s_out``'s fields along its first axis)."""
    new_scale, new_maxabs, step_inf, new_s, new_f, *q = s_out.unbind()
    return (new_scale, new_maxabs, step_inf, stall_out, r_out, new_s, new_f, *q)


# --------------------------------------------------------------------------
# Lanes: one launch for L delta lanes
# --------------------------------------------------------------------------


def step_tail_lanes_plain(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                          zty, znorm2, i_star, g, delta, lanes, cfg, en=None, tel=None):
    """The plain version: ``step_tail_plain`` once per listed lane, on its row
    of ``beta`` (in place) and copies of its residual row and scalars, with
    ``tel`` (a lane ``TailRecord``) its record at its host cursor and then
    its device cursor advanced; a lane not listed keeps its residual and
    scalars and records nothing. Arguments and returns are
    ``step_tail_lanes``'s."""
    fields = (scale, maxabs, step_inf, stall, resid, s_quad, f_lin)
    if en is not None:
        fields += (en.q_norm,)
    outs = [[t.clone() for t in f.unbind(0)] for f in fields]
    run = set(lanes.tolist() if isinstance(lanes, torch.Tensor) else lanes)
    for lane in sorted(run):
        en_l = None if en is None else ENTail(en.g_sel[lane].clone(), en.q_norm[lane].clone(),
                                              en.l2)
        tel_l = None if tel is None else tel.lane(lane)
        mat_l = GivenCol(mat.z[lane], mat.sparse) if isinstance(mat, GivenCol) else mat
        got = step_tail_plain(mat_l, beta[lane], scale[lane].clone(), maxabs[lane].clone(),
                              stall[lane].clone(), resid[lane].clone(), s_quad[lane].clone(),
                              f_lin[lane].clone(), y, zty, znorm2, i_star[lane].clone(),
                              g[lane].clone(), delta[lane].clone(), cfg, en_l, tel_l)
        for ts, t in zip(outs, got[1:]):
            ts[lane] = t
        if tel is not None:
            tel.dev_cursor[lane] += 1
    return (beta, *(torch.stack(ts) for ts in outs))


def step_tail_lanes(mat, beta: torch.Tensor, scale: torch.Tensor, maxabs: torch.Tensor,
                    step_inf: torch.Tensor, stall: torch.Tensor, resid: torch.Tensor,
                    s_quad: torch.Tensor, f_lin: torch.Tensor, y: torch.Tensor,
                    zty: torch.Tensor, znorm2: torch.Tensor, i_star: torch.Tensor,
                    g: torch.Tensor, delta: torch.Tensor, lanes: torch.Tensor, cfg, tel=None):
    """The step's tail for L lanes in one launch: ``beta (L, p)`` (updated
    in place), ``resid (L, m)``, the scalars ``scale``, ``maxabs``,
    ``step_inf``, ``stall``, ``s_quad``, ``f_lin``, the winners ``i_star``,
    their scores ``g`` and the deltas ``delta``, each ``(L,)``; ``mat``,
    ``y`` and the column statistics are shared, and the dtypes are
    ``step_tail``'s. ``lanes`` (int32) lists the lanes that step; the others
    are frozen (outputs equal to their inputs). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises). Returns
    ``(beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin)``, each
    lane-stacked, S and F before the periodic refresh. ``tel`` (a lane
    ``TailRecord``) adds each stepping lane's ring record, in the lane TEL
    instantiation (counted on ``step_tail_lanes_tel``)."""
    return _tail_lanes(step_tail_lanes if tel is None else step_tail_lanes_tel, mat, beta, scale,
                       maxabs, step_inf, stall, resid, s_quad, f_lin, y, zty, znorm2, i_star, g,
                       delta, lanes, cfg, None, tel)


def step_tail_lanes_tel(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, zty,
                        znorm2, i_star, g, delta, lanes, cfg, tel):
    """``step_tail_lanes`` with the lanes' ring records ``tel``: the lane TEL
    instantiation."""
    return step_tail_lanes(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                           zty, znorm2, i_star, g, delta, lanes, cfg, tel)


def step_tail_en_lanes(mat, beta: torch.Tensor, scale: torch.Tensor, maxabs: torch.Tensor,
                       step_inf: torch.Tensor, stall: torch.Tensor, resid: torch.Tensor,
                       s_quad: torch.Tensor, f_lin: torch.Tensor, y: torch.Tensor,
                       zty: torch.Tensor, znorm2: torch.Tensor, i_star: torch.Tensor,
                       g: torch.Tensor, delta: torch.Tensor, lanes: torch.Tensor, cfg, en,
                       tel=None):
    """The elastic-net's tail for L lanes in one launch of the tail kernel's
    EN lane instantiation: ``step_tail_lanes``' arguments and ``en`` (an
    ``ENTail`` of ``(L,)`` selected scores and Q). Returns
    ``step_tail_lanes``', then the lanes' Q. ``tel`` as
    ``step_tail_lanes``' (counted on ``step_tail_en_lanes_tel``)."""
    return _tail_lanes(step_tail_en_lanes if tel is None else step_tail_en_lanes_tel, mat, beta,
                       scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, zty, znorm2,
                       i_star, g, delta, lanes, cfg, en, tel)


def step_tail_en_lanes_tel(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                           zty, znorm2, i_star, g, delta, lanes, cfg, en, tel):
    """``step_tail_en_lanes`` with the lanes' ring records ``tel``: the EN
    lane TEL instantiation."""
    return step_tail_en_lanes(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                              zty, znorm2, i_star, g, delta, lanes, cfg, en, tel)


def _tail_lanes(wrapper, mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                zty, znorm2, i_star, g, delta, lanes, cfg, en, tel=None):
    """``step_tail_lanes`` (``en`` None) or ``step_tail_en_lanes``: the
    plain version on a CPU tensor, else one launch, counted on ``wrapper``."""
    if beta.dim() != 2 or resid.dim() != 2 or resid.shape[0] != beta.shape[0]:
        raise ValueError(f"need beta (L, p) and resid (L, m), got {tuple(beta.shape)}, "
                         f"{tuple(resid.shape)}")
    L = beta.shape[0]
    if any(t.shape != (L,) for t in (scale, maxabs, step_inf, stall, s_quad, f_lin, i_star, g,
                                     delta)):
        raise ValueError(f"need the lanes' scalars, winners, scores and deltas as ({L},)")
    if lanes.dim() != 1 or lanes.dtype != torch.int32:
        raise ValueError(f"need lanes, the int32 ids of the lanes that step, got {lanes}")
    if isinstance(mat, GivenCol):
        if mat.z.shape != resid.shape or mat.z.dtype != beta.dtype:
            raise ValueError(f"need the lanes' given columns {tuple(resid.shape)} in the "
                             f"state's dtype, got {tuple(mat.z.shape)} {mat.z.dtype}")
        _check(GivenCol(mat.z[0], mat.sparse), beta[0], resid[0], y, zty, znorm2)
    else:
        _check(mat, beta[0], resid[0], y, zty, znorm2)
    if beta.device.type == "cpu":
        return step_tail_lanes_plain(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad,
                                     f_lin, y, zty, znorm2, i_star, g, delta, lanes, cfg, en, tel)
    X, rows, head_fn = _matrix_head(mat)
    sparse = rows is not None
    dtype = beta.dtype
    q_norm = None if en is None else en.q_norm
    if en is not None and (q_norm.shape != (L,) or en.g_sel.shape != (L,)):
        raise ValueError(f"need the lanes' shifted scores and Q as ({L},)")
    if any(t.dtype != dtype for t in (X, scale, maxabs, step_inf, s_quad, f_lin, resid, y, zty,
                                      znorm2) + (() if en is None else (q_norm,))):
        raise TypeError(f"{wrapper.__name__} needs the matrix, beta, its scalars, the "
                        "residual, y and the column statistics in one dtype")
    if stall.dtype != torch.int32 or i_star.dtype != torch.int64 or delta.dtype != torch.float32:
        raise TypeError(f"{wrapper.__name__} needs stall int32, i_star int64 and delta float32")
    if sparse and rows.dtype != torch.int32:
        raise TypeError(f"the row slots must be int32, got {rows.dtype}")
    g = g.float()
    g_sel = None if en is None else en.g_sel.float()
    dev = _build.require_cuda(X, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                              zty, znorm2, i_star, g, delta, lanes,
                              *(() if rows is None else (rows,)),
                              *(() if en is None else (g_sel, q_norm)), *_tel_tensors(tel))
    m = y.shape[0]
    r_out = torch.empty((L, m), dtype=dtype, device=dev)
    s_out = torch.empty((5 if en is None else 6, L), dtype=dtype, device=dev)
    stall_out = torch.empty(L, dtype=torch.int32, device=dev)
    fn = head_fn()
    with torch.cuda.device(dev):
        err = fn(*_head_args(mat), beta.data_ptr(), beta.shape[1],
                 scale.data_ptr(), maxabs.data_ptr(), stall.data_ptr(), s_quad.data_ptr(),
                 f_lin.data_ptr(), resid.data_ptr(), y.data_ptr(), zty.data_ptr(),
                 znorm2.data_ptr(), i_star.data_ptr(), g.data_ptr(), delta.data_ptr(), m,
                 _build.f32(cfg.renorm_threshold), _build.f32(cfg.eps_den),
                 _build.f32(cfg.gap_rtol), _build.f32(cfg.tol), r_out.data_ptr(), s_out.data_ptr(),
                 stall_out.data_ptr(),
                 *_build.lane_ids_arg(lanes), L, step_inf.data_ptr(),
                 _build.dtype_code(beta), *_en_args(en, g_sel, q_norm),
                 *_tel_args(tel, True, en, dtype), _build.stream(dev))
        wrapper.launches += 1
    _build.check("step_tail", err, wrapper.__name__)
    return (beta, *_outs(s_out, stall_out, r_out))


# --------------------------------------------------------------------------
# The column given (the distributed backend)
# --------------------------------------------------------------------------


def step_tail_given(col: GivenCol, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty,
                    znorm2, i_star, g, delta, cfg, tel=None):
    """``step_tail`` with the winner's column ``col`` (a ``GivenCol`` of
    ``(m,)``) in place of the matrix: the tail kernel's ``GIVEN``
    instantiation (counted on ``step_tail_given``, with ``tel`` on
    ``step_tail_given_tel``); ``beta``, ``zty`` and ``znorm2`` are the
    replicated global ones, the residual and ``y`` the rank's sample slice."""
    return _tail(step_tail_given if tel is None else step_tail_given_tel, col, beta, scale,
                 maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2, i_star, g, delta, cfg,
                 None, tel)


def step_tail_given_tel(col, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2,
                        i_star, g, delta, cfg, tel):
    """``step_tail_given`` with the ring record ``tel``."""
    return step_tail_given(col, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2,
                           i_star, g, delta, cfg, tel)


def step_tail_en_given(col: GivenCol, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty,
                       znorm2, i_star, g, delta, cfg, en, tel=None):
    """``step_tail_en`` with the winner's column given (the EN ``GIVEN``
    instantiation)."""
    return _tail(step_tail_en_given if tel is None else step_tail_en_given_tel, col, beta, scale,
                 maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2, i_star, g, delta, cfg, en,
                 tel)


def step_tail_en_given_tel(col, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty, znorm2,
                           i_star, g, delta, cfg, en, tel):
    """``step_tail_en_given`` with the ring record ``tel``."""
    return step_tail_en_given(col, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, zty,
                              znorm2, i_star, g, delta, cfg, en, tel)


def step_tail_lanes_given(col: GivenCol, beta, scale, maxabs, step_inf, stall, resid, s_quad,
                          f_lin, y, zty, znorm2, i_star, g, delta, lanes, cfg, tel=None):
    """``step_tail_lanes`` with the lanes' columns given (``col.z`` ``(L,
    m)``; a frozen lane's is unused): the lane ``GIVEN`` instantiation."""
    return _tail_lanes(step_tail_lanes_given if tel is None else step_tail_lanes_given_tel, col,
                       beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, zty,
                       znorm2, i_star, g, delta, lanes, cfg, None, tel)


def step_tail_lanes_given_tel(col, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                              zty, znorm2, i_star, g, delta, lanes, cfg, tel):
    """``step_tail_lanes_given`` with the lanes' ring records ``tel``."""
    return step_tail_lanes_given(col, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin,
                                 y, zty, znorm2, i_star, g, delta, lanes, cfg, tel)


def step_tail_en_lanes_given(col: GivenCol, beta, scale, maxabs, step_inf, stall, resid, s_quad,
                             f_lin, y, zty, znorm2, i_star, g, delta, lanes, cfg, en, tel=None):
    """``step_tail_en_lanes`` with the lanes' columns given (the EN lane
    ``GIVEN`` instantiation)."""
    return _tail_lanes(step_tail_en_lanes_given if tel is None else step_tail_en_lanes_given_tel,
                       col, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, zty,
                       znorm2, i_star, g, delta, lanes, cfg, en, tel)


def step_tail_en_lanes_given_tel(col, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin,
                                 y, zty, znorm2, i_star, g, delta, lanes, cfg, en, tel):
    """``step_tail_en_lanes_given`` with the lanes' ring records ``tel``."""
    return step_tail_en_lanes_given(col, beta, scale, maxabs, step_inf, stall, resid, s_quad,
                                    f_lin, y, zty, znorm2, i_star, g, delta, lanes, cfg, en, tel)


def owned_column_plain(mat, ids: torch.Tensor, off: int, m: int) -> torch.Tensor:
    """The plain version of ``owned_column_lanes``: ``dense_columns`` of the
    local features ``ids - off`` (clipped into the tile), zero rows where
    the tile does not own the id."""
    if isinstance(mat, tuple):
        p_local = mat[0].shape[0] * mat[0].shape[1]
    else:
        p_local = mat.shape[0]
    own = (ids >= off) & (ids < off + p_local)
    cols = dense_columns(mat, (ids - off).clamp(0, p_local - 1), m)
    return torch.where(own[:, None], cols, torch.zeros((), dtype=cols.dtype, device=cols.device))


def owned_column_lanes(mat, ids: torch.Tensor, off: int, m: int) -> torch.Tensor:
    """The columns ``(A, m)`` of the global features ``ids`` (int64 ``(A,)``)
    on a rank's tile ``mat`` (dense ``(p_local, m)`` or the block-ELL
    ``(values, rows)``) of the global features ``[off, off + p_local)``:
    an owned id's dense column (its row, or its slots scattered into zeros
    as ``dense_columns``), zeros for any other (a frozen lane's -1 too), in
    the tile's dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches ``owned_column_kernel``, one block an id."""
    return _owned_column(owned_column_lanes, mat, ids, off, m)


def owned_column(mat, i_star: torch.Tensor, off: int, m: int) -> torch.Tensor:
    """``owned_column_lanes`` of the one id ``i_star`` (0-d): ``(m,)``."""
    return _owned_column(owned_column, mat, i_star.view(1), off, m).view(-1)


def _owned_column(wrapper, mat, ids, off, m):
    if ids.dim() != 1 or ids.numel() == 0 or ids.dtype != torch.int64:
        raise ValueError(f"need the ids as int64 (A >= 1,), got {ids.dtype} {tuple(ids.shape)}")
    X, rows = mat if isinstance(mat, tuple) else (mat, None)
    if X.device.type == "cpu":
        return owned_column_plain(mat, ids, off, m)
    if rows is not None and (rows.dtype != torch.int32 or rows.shape != X.shape):
        raise TypeError("the row slots must be int32, the values' shape")
    if rows is None and (X.dim() != 2 or X.shape[1] != m):
        raise ValueError(f"need the tile (p_local, m = {m}), got {tuple(X.shape)}")
    ids = ids.contiguous()
    dev = _build.require_cuda(X, ids, *(() if rows is None else (rows,)))
    p_local = X.shape[0] * X.shape[1] if rows is not None else X.shape[0]
    out = torch.empty((ids.numel(), m), dtype=X.dtype, device=dev)
    fn = _build.function("step_tail", "owned_column_launch", _COLUMN_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(X.data_ptr(), None if rows is None else rows.data_ptr(),
                 X.shape[-1] if rows is not None else 0, p_local, m, int(off), ids.data_ptr(),
                 ids.numel(), out.data_ptr(), _build.dtype_code(X), _build.stream(dev))
        wrapper.launches += 1
    _build.check("step_tail", err, wrapper.__name__)
    return out


step_tail.launches = 0
step_tail_en.launches = 0
step_tail_given.launches = 0
step_tail_given_tel.launches = 0
step_tail_en_given.launches = 0
step_tail_en_given_tel.launches = 0
step_tail_lanes_given.launches = 0
step_tail_lanes_given_tel.launches = 0
step_tail_en_lanes_given.launches = 0
step_tail_en_lanes_given_tel.launches = 0
owned_column.launches = 0
owned_column_lanes.launches = 0
step_tail_lanes.launches = 0
step_tail_en_lanes.launches = 0
step_tail_tel.launches = 0
step_tail_en_tel.launches = 0
step_tail_lanes_tel.launches = 0
step_tail_en_lanes_tel.launches = 0


# --------------------------------------------------------------------------
# The direction tail of the away and pairwise rules (core/step_rule.DirRule)
# --------------------------------------------------------------------------


class DirStep(NamedTuple):
    """One generalized FW direction d = t*alpha + df*e_{i_f} + da*e_{i_a}
    (the reference's ``core/step_rule.py:85-99``): f32 0-d scalars, int64
    0-d coordinates.

    classic FW: t = -1, df = delta_t, da = 0, g_max = 1; away: t = +1,
    df = 0, da = -sigma_a delta, g_max = w_a / (1 - w_a); pairwise: t = 0,
    df = delta_t, da = -sigma_a delta, g_max = w_a."""

    t: torch.Tensor  # alpha coefficient
    df: torch.Tensor  # FW-atom coefficient
    da: torch.Tensor  # away-atom coefficient
    i_f: torch.Tensor  # FW vertex coordinate
    i_a: torch.Tensor  # away vertex coordinate (a safe dummy when da == 0)
    a_f: torch.Tensor  # alpha[i_f]
    a_a: torch.Tensor  # alpha[i_a]
    sel_f: torch.Tensor  # selected score at i_f
    sel_a: torch.Tensor  # selected score at i_a
    same: torch.Tensor  # 1.0 when i_f == i_a else 0.0
    g_max: torch.Tensor  # step-size clip


class DirEN(NamedTuple):
    """The elastic-net's operands of the direction tail: its l2 strength and
    Q = ||alpha||^2 in the state's dtype."""

    l2: float
    q_norm: torch.Tensor


class DirTailOut(NamedTuple):
    """What the direction tail returns: ``beta`` (updated in place), the
    state's scalars in its dtype, the new residual, S, F and Q (None for the
    lasso) after the step (S and F refreshed when asked, Q before its
    refresh), the new active-set buffer, the step's vertex ``where(use_alt,
    i_a, i_f)``, the away vertex and the step size ``g`` (f32)."""

    beta: torch.Tensor
    scale: torch.Tensor
    maxabs: torch.Tensor
    step_inf: torch.Tensor
    stall: torch.Tensor
    resid: torch.Tensor
    s_quad: torch.Tensor
    f_lin: torch.Tensor
    q_norm: torch.Tensor | None
    buf: torch.Tensor
    i_star: torch.Tensor
    i_a: torch.Tensor
    g: torch.Tensor


def away_vertex(sel_b, buf, beta, scale, p: int):
    """The away-vertex argmax over the active-set buffer from its selected
    scores ``sel_b`` (the reference's ``_select_away`` after its
    ``score_indices``, ``core/step_rule.py:190-205``): empty (-1) and
    zero-weight slots masked, the first max of ``sign(alpha_i) * sel_i``.
    Returns ``(i_a, sel_a, a_a, sigma_a, any_valid)``, 0-d device tensors
    (``i_a`` 0 and the rest slot 0's when no slot is valid)."""
    safe = buf.clamp(0, p - 1)
    a_b = scale.float() * beta.index_select(0, safe).float()
    valid = (buf >= 0) & (a_b != 0.0)
    sigma = torch.sign(a_b)
    sel_b = sel_b.float()
    score = torch.where(valid, sigma * sel_b, float("-inf"))
    j = torch.argmax(score).view(1)
    any_valid = valid.any()
    i_a = torch.where(any_valid, safe.index_select(0, j).view(()), 0)
    return (i_a, sel_b.index_select(0, j).view(()), a_b.index_select(0, j).view(()),
            sigma.index_select(0, j).view(()), any_valid)


def dir_choice(sel_f, a_f, i_f, away, delta, ga, pairwise: bool, eps_den: float):
    """The away-or-FW choice of ``DirRule.step`` (the reference's
    ``core/step_rule.py:262-292``) from the FW vertex's selected score and
    alpha value, ``away_vertex``'s result and, for away steps, ``ga =
    <grad, alpha>``. Returns ``(DirStep, use_alt)``."""
    i_a, sel_a, a_a, sigma_a, any_valid = away
    df_fw = -delta * torch.sign(sel_f)
    w_a = torch.abs(a_a) / torch.clamp_min(delta, eps_den)
    usable = any_valid & (w_a > 0.0)
    if pairwise:
        # pairwise when an away atom exists and the paired direction descends
        use_alt = usable & (torch.abs(sel_f) + sigma_a * sel_a > 0.0)
        t = torch.where(use_alt, 0.0, -1.0)
        df = df_fw
        g_max = torch.where(use_alt, w_a, 1.0)
    else:
        # away iff its directional gap beats the FW direction's
        fw_gap = ga - df_fw * sel_f
        away_gap = sigma_a * delta * sel_a - ga
        use_alt = usable & (away_gap > fw_gap)
        t = torch.where(use_alt, 1.0, -1.0)
        df = torch.where(use_alt, 0.0, df_fw)
        g_max = torch.where(use_alt, (w_a / torch.clamp_min(1.0 - w_a, eps_den)).clamp_max(1e3),
                            1.0)
    da = torch.where(use_alt, -sigma_a * delta, 0.0)
    same = (i_f == i_a).float()
    return DirStep(t=t, df=df, da=da, i_f=i_f, i_a=i_a, a_f=a_f, a_a=a_a, sel_f=sel_f,
                   sel_a=sel_a, same=same, g_max=g_max), use_alt


def grad_dot_alpha(s_quad, f_lin, en: DirEN | None = None):
    """<grad, alpha> = S - F for the lasso, + l2 Q for the elastic-net."""
    ga = s_quad - f_lin
    return ga if en is None else ga + en.l2 * en.q_norm


def dir_ls_closed_form(ds: DirStep, s_quad, f_lin, vu, uu, eps_den: float, gap_rtol: float,
                       en: DirEN | None = None):
    """The exact step along the generalized direction, minimize
    1/2 ||X(alpha + g d) - y||^2 (+ l2/2 ||alpha + g d||^2) over g in [0,
    g_max], as scalar algebra in the reference's op order (lasso
    ``core/fw_lasso.py:199-217``, elastic-net ``core/fw_elasticnet.py:
    159-178``); ``vu = <X alpha, u>`` and ``uu = <u, u>`` for ``u = df z_f
    + da z_a``. ``num`` is -<grad, d>, the directional FW gap; below the
    f32 floor of its own terms the step is a stall (``gap_rtol``). Returns
    ``(g, no_progress)``."""
    ga = grad_dot_alpha(s_quad, f_lin, en)
    num = -(ds.t * ga + ds.df * ds.sel_f + ds.da * ds.sel_a)
    den = ds.t**2 * s_quad + 2.0 * ds.t * vu + uu
    scalars = s_quad + torch.abs(f_lin)
    if en is not None:
        # ||d||^2 = t^2 Q + 2t(df a_f + da a_a) + df^2 + da^2 + 2 df da [f == a]
        d2 = (ds.t**2 * en.q_norm + 2.0 * ds.t * (ds.df * ds.a_f + ds.da * ds.a_a)
              + ds.df**2 + ds.da**2 + 2.0 * ds.df * ds.da * ds.same)
        den = den + en.l2 * d2
        scalars = scalars + en.l2 * en.q_norm
    g = torch.minimum(torch.clamp_min(num / torch.clamp_min(den, eps_den), 0.0), ds.g_max)
    gap_scale = (torch.abs(ds.t) * scalars + torch.abs(ds.df * ds.sel_f)
                 + torch.abs(ds.da * ds.sel_a))
    return g, num <= gap_rtol * gap_scale


def dir_line_search(ds: DirStep, u, resid, y, s_quad, f_lin, eps_den: float, gap_rtol: float,
                    en: DirEN | None = None):
    """The lasso's (with ``en`` the elastic-net's) line search along the
    direction whose image is ``t X alpha + u``: the dots ``vu = <X alpha,
    u>`` (X alpha = y - R) and ``uu = <u, u>``, then ``dir_ls_closed_form``
    (the reference's ``dir_line_search``, lasso ``core/fw_lasso.py:188-217``,
    elastic-net ``core/fw_elasticnet.py:150-178``). f32 operands. Returns
    ``(g, no_progress, (vu, uu))``."""
    v = y - resid
    vu, uu = torch.dot(v, u), torch.dot(u, u)
    g, no_progress = dir_ls_closed_form(ds, s_quad, f_lin, vu, uu, eps_den, gap_rtol, en)
    return g, no_progress, (vu, uu)


def dir_update_co(resid, y, u, ds: DirStep, g, s_quad, f_lin, aux, refresh: bool, dtype,
                  q_norm=None):
    """The co-state after the step (the reference's ``dir_update_co``, lasso
    ``core/fw_lasso.py:219-235``, elastic-net ``core/fw_elasticnet.py:
    180-201`` but Q's refresh, which needs beta): ``dir_co_recursion`` on
    ``aux = (vu, uu)`` from ``dir_line_search``, the residual stored in
    ``dtype``, then S and F exactly from it when ``refresh``. f32 operands.
    Returns ``(resid, s_quad, f_lin, q_norm)`` (Q None without one)."""
    vu, uu = aux
    resid, s_quad, f_lin, q_norm = dir_co_recursion(resid, y, u, ds, g, s_quad, f_lin, vu, uu,
                                                    torch.dot(u, y), q_norm)
    resid = resid.to(dtype)
    if refresh:
        v = y - resid.float()
        s_quad, f_lin = torch.dot(v, v), torch.dot(v, y)
    return resid, s_quad, f_lin, q_norm


def dir_co_recursion(resid, y, u, ds: DirStep, g, s_quad, f_lin, vu, uu, uy, q_norm=None):
    """R' = (1+gt) R - gt y - g u and the S/F (and Q) recursions of the
    generalized step (lasso ``core/fw_lasso.py:219-235``, elastic-net
    ``core/fw_elasticnet.py:180-201``), before the periodic exact refresh.
    Returns ``(resid, s_quad, f_lin, q_norm)`` (Q None without one)."""
    gt = g * ds.t
    one_gt = 1.0 + gt
    resid = one_gt * resid - gt * y - g * u
    s_quad = one_gt**2 * s_quad + 2.0 * one_gt * g * vu + g**2 * uu
    f_lin = one_gt * f_lin + g * uy
    if q_norm is not None:
        atom2 = ds.df**2 + ds.da**2 + 2.0 * ds.df * ds.da * ds.same
        q_norm = (one_gt**2 * q_norm + 2.0 * one_gt * g * (ds.df * ds.a_f + ds.da * ds.a_a)
                  + g**2 * atom2)
    return resid, s_quad, f_lin, q_norm


def apply_dir_update(beta, scale, maxabs, stall, ds: DirStep, g, no_progress, cfg):
    """The generalized-direction twin of ``apply_coeff_update`` (the
    reference's ``core/step_rule.py:117-153``): the scaled-iterate update
    for alpha(g) = (1 + g t) alpha + g (df e_f + da e_a) with ``beta`` in
    place (the renorm only when the scale underflows, an exact multiply by
    1 otherwise), the exact zero of the away coordinate on a drop step (g
    reaches g_max), and the stopping statistics. Scalars in f32; ``beta``
    keeps its dtype, each update rounded once. Returns ``(beta, scale,
    maxabs, step_inf, stall)``."""
    scale, maxabs = scale.float(), maxabs.float()
    one_gt = 1.0 + g * ds.t
    new_scale = scale * one_gt
    need_renorm = new_scale < cfg.renorm_threshold
    factor = torch.where(need_renorm, new_scale, 1.0)
    scale = torch.where(need_renorm, 1.0, new_scale)
    denom = torch.clamp_min(scale, cfg.eps_den)
    inc_f, inc_a = g * ds.df / denom, g * ds.da / denom
    if beta.dtype == torch.float32:
        beta.mul_(factor)
        beta.index_add_(0, ds.i_f.view(1), inc_f.view(1))
        beta.index_add_(0, ds.i_a.view(1), inc_a.view(1))
    else:
        beta.copy_(beta.float().mul_(factor))
        for i, inc in ((ds.i_f, inc_f), (ds.i_a, inc_a)):
            beta.index_copy_(0, i.view(1), (_take(beta, i).float() + inc).to(beta.dtype).view(1))
    # drop step: the away atom leaves the decomposition exactly
    drop = (ds.da != 0.0) & (g >= ds.g_max) & (ds.same == 0.0)
    beta.index_copy_(0, ds.i_a.view(1), torch.where(drop, 0.0, _take(beta, ds.i_a)).view(1))
    # ||alpha' - alpha||_inf bound: |t| maxabs off the atoms, the exact
    # movement on them (same-coordinate terms folded in)
    d_f = ds.t * ds.a_f + ds.df + ds.same * ds.da
    d_a = ds.t * ds.a_a + ds.da + ds.same * ds.df
    step_inf = g * torch.maximum(torch.abs(ds.t) * maxabs,
                                 torch.maximum(torch.abs(d_f), torch.abs(d_a)))
    maxabs = torch.maximum(torch.abs(one_gt) * maxabs,
                           torch.maximum(torch.abs(scale * _take(beta, ds.i_f).float()),
                                         torch.abs(scale * _take(beta, ds.i_a).float())))
    stall = torch.where((step_inf <= cfg.tol) | no_progress, stall + 1, 0)
    return beta, scale, maxabs, step_inf, stall


def insert_active(buf, i_new, beta):
    """Track ``i_new`` in the active-set buffer (the reference's
    ``core/step_rule.py:176-187``): no change when present, else the
    weakest-|beta| slot is replaced (empty slots first, the first of equal
    ones). Returns a new buffer."""
    p = beta.shape[0]
    present = (buf == i_new).any()
    w = torch.where(buf >= 0, torch.abs(beta.index_select(0, buf.clamp(0, p - 1))), -1.0)
    slot = torch.argmin(w).view(1)
    inserted = buf.index_put((slot,), i_new.to(buf.dtype).view(1))
    return torch.where(present, buf, inserted)


def dense_columns(mat, ids: torch.Tensor, m: int) -> torch.Tensor:
    """The dense columns ``(len(ids), m)`` of the features ``ids``, in the
    design's dtype: rows of a dense ``Xt``, or each feature's block-ELL
    slots (``(values, rows)``) added into zeros (the padding adds 0.0 at row
    0; a feature's rows are distinct, so each sum is exact)."""
    if not isinstance(mat, tuple):
        return mat.index_select(0, ids)
    values, rows = mat
    nnz = values.shape[-1]
    vals = values.reshape(-1, nnz).index_select(0, ids)
    rws = rows.reshape(-1, nnz).index_select(0, ids).long()
    rws = rws + m * torch.arange(ids.shape[0], device=rws.device)[:, None]
    out = torch.zeros(ids.shape[0] * m, dtype=values.dtype, device=values.device)
    return out.index_add_(0, rws.view(-1), vals.reshape(-1)).view(-1, m)


def dir_tail_plain(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b, i_f,
                   sel_f, delta, refresh: bool, pairwise: bool, cfg, en: DirEN | None = None):
    """The plain version: ``DirRule.step`` after its FW vertex and the
    buffer's linear scores, composed of this module's ports of the
    reference's ops in its order (``core/step_rule.py:248-318``), the
    lasso's or with ``en`` the elastic-net's: the buffer's score shift,
    ``away_vertex``, ``dir_choice``, ``u = df z_f + da z_a``,
    ``dir_line_search``, ``apply_dir_update``, ``dir_update_co`` with the
    exact S/F refresh when ``refresh``, and ``insert_active`` when the FW
    atom gained weight. The one direction
    tail on 'torch', the plain sparse ops and CPU tensors. Scalars in f32;
    the residual computed in f32 and stored in the state's dtype. Returns a
    ``DirTailOut``."""
    m = y.shape[0]
    return _dir_tail_plain(
        lambda ds, away: dense_columns(mat, torch.stack([i_f, ds.i_a]), m), beta, scale, maxabs,
        stall, resid, s_quad, f_lin, y, buf, raw_b, i_f, sel_f, delta, refresh, pairwise, cfg, en)


def _dir_tail_plain(columns, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b,
                    i_f, sel_f, delta, refresh: bool, pairwise: bool, cfg, en=None,
                    complete=None):
    """``dir_tail_plain`` with the two columns from ``columns(ds, away)``
    (``away`` the away vertex, ``away_vertex``'s result); ``complete``, when
    given, sums the three dots (and the refresh's two) across the sample
    slices of a mesh."""
    p, dtype = beta.shape[0], beta.dtype
    sel_b = raw_b.float()
    if en is not None:
        sel_b = sel_b + en.l2 * (scale.float() * beta.index_select(0, buf.clamp(0, p - 1)).float())
    away = away_vertex(sel_b, buf, beta, scale, p)
    s_quad, f_lin, sel_f = s_quad.float(), f_lin.float(), sel_f.float()
    en_f = None if en is None else DirEN(en.l2, en.q_norm.float())
    ga = None if pairwise else grad_dot_alpha(s_quad, f_lin, en_f)
    a_f = scale.float() * _take(beta, i_f).float()
    ds, use_alt = dir_choice(sel_f, a_f, i_f, away, delta, ga, pairwise, cfg.eps_den)
    z = columns(ds, away).float()
    u = ds.df * z[0] + ds.da * z[1]
    rf, yf = resid.float(), y.float()
    if complete is None:
        g, no_progress, aux = dir_line_search(ds, u, rf, yf, s_quad, f_lin, cfg.eps_den,
                                              cfg.gap_rtol, en_f)
    else:
        v = yf - rf
        vu, uu, uy = complete(torch.stack([torch.dot(v, u), torch.dot(u, u),
                                           torch.dot(u, yf)])).unbind()
        g, no_progress = dir_ls_closed_form(ds, s_quad, f_lin, vu, uu, cfg.eps_den, cfg.gap_rtol,
                                            en_f)
    beta, scale, maxabs, step_inf, stall = apply_dir_update(beta, scale, maxabs, stall, ds, g,
                                                            no_progress, cfg)
    if complete is None:
        resid, s_quad, f_lin, q_norm = dir_update_co(rf, yf, u, ds, g, s_quad, f_lin, aux,
                                                     refresh, dtype,
                                                     None if en_f is None else en_f.q_norm)
    else:
        resid, s_quad, f_lin, q_norm = dir_co_recursion(rf, yf, u, ds, g, s_quad, f_lin, vu, uu,
                                                        uy, None if en_f is None else en_f.q_norm)
        resid = resid.to(dtype)
        if refresh:
            s_quad, f_lin = _refresh_dots(resid, yf, complete)
    # the FW atom enters the active set whenever it gained weight
    took_fw = (ds.df != 0.0) & (g > 0.0)
    buf = torch.where(took_fw, insert_active(buf, i_f, beta), buf)
    return DirTailOut(beta, scale.to(dtype), maxabs.to(dtype), step_inf.to(dtype), stall, resid,
                      s_quad.to(dtype), f_lin.to(dtype),
                      None if q_norm is None else q_norm.to(dtype), buf,
                      torch.where(use_alt, ds.i_a, i_f), ds.i_a, g)


def _refresh_dots(resid, yf, complete):
    """S and F exactly from the new residual, ``v.v`` and ``v.y`` (``v = y -
    R``) summed across the sample slices by ``complete``, in f32."""
    v = yf - resid.float()
    return complete(torch.stack([torch.dot(v, v), torch.dot(v, yf)])).unbind()


def dir_tail_given_plain(zcols, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b,
                         i_f, sel_f, delta, refresh: bool, pairwise: bool, cfg,
                         en: DirEN | None = None, complete=None):
    """The plain version of ``dir_tail_given``: ``dir_tail_plain`` with the
    columns read from ``zcols`` (z_f, feature 0's, each slot's: the away
    vertex's row is that of any slot whose clipped id is its id, all such
    rows the same column, or feature 0's when no slot is valid) and, with
    ``complete``, the dots summed across the sample slices."""
    p = beta.shape[0]

    def columns(ds, away):
        hit = (buf.clamp(0, p - 1) == ds.i_a).to(torch.int32)
        row_a = torch.where(away[4], 2 + torch.argmax(hit), 1)
        return zcols.index_select(0, torch.stack([row_a.new_zeros(()), row_a]))

    return _dir_tail_plain(columns, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf,
                           raw_b, i_f, sel_f, delta, refresh, pairwise, cfg, en, complete)


def dir_column_ids(i_f, buf, p: int) -> torch.Tensor:
    """The ids whose columns ``dir_tail_given`` reads: ``i_f``, 0, then each
    slot's id clipped to [0, p)."""
    return torch.cat([i_f.view(1), i_f.new_zeros(1), buf.clamp(0, p - 1)])


# (X, rows, nnz_max, beta, p, scale, maxabs, stall, s_quad, f_lin, q_norm, resid, y, buf, n_buf,
#  raw_b, i_f, sel_f, delta, m, pairwise, refresh, l2, renorm_threshold, eps_den, gap_rtol, tol,
#  r_out, s_out, stall_out, buf_out, i_out, g_out, scratch, dtype, stream)
_DIR_ARGTYPES = ([_PTR, _PTR, _I32, _PTR, _I64] + [_PTR] * 9 + [_I32] + [_PTR] * 4
                 + [_I32, _I32, _I32] + [_F32] * 5 + [_PTR] * 7 + [_I32, _PTR])
# (zcols, beta, p, ..., scratch, phase, dots, dtype, stream): dir_tail_launch's arguments
# from beta on, the phase and the dots' buffer before the dtype
_DIR_GIVEN_ARGTYPES = [_PTR] + _DIR_ARGTYPES[3:-2] + [_I32, _PTR, _I32, _PTR]
DIR_ROWS = 4096  # DT_ROWS of csrc/step_tail.cu: the residual rows a block owns
DIR_MAX_SLOTS = 512  # DT_MAX_SLOTS: the largest buffer the kernel takes


def dir_tail(mat, beta: torch.Tensor, scale: torch.Tensor, maxabs: torch.Tensor,
             stall: torch.Tensor, resid: torch.Tensor, s_quad: torch.Tensor, f_lin: torch.Tensor,
             y: torch.Tensor, buf: torch.Tensor, raw_b: torch.Tensor, i_f: torch.Tensor,
             sel_f: torch.Tensor, delta: torch.Tensor, refresh: bool, pairwise: bool, cfg):
    """The lasso's direction tail in one launch: ``mat`` the dense ``Xt (p,
    m)`` or the block-ELL ``(values, rows)``; ``beta`` (updated in place),
    its scalars, the residual and ``y`` in one dtype (f32 or bf16),
    ``stall`` int32; ``buf`` the int64 active-set buffer (-1 empty),
    ``raw_b`` its f32 linear scores, ``i_f`` (int64) and ``sel_f`` (f32)
    the FW vertex, ``delta`` a 0-d f32; ``refresh`` (the host's k) asks for
    the exact S/F refresh, ``pairwise`` picks the rule. A CPU tensor takes
    ``dir_tail_plain``; a CUDA tensor launches the kernel (or raises).
    Returns a ``DirTailOut``."""
    return _dir(dir_tail, mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b,
                i_f, sel_f, delta, refresh, pairwise, cfg, None)


def dir_tail_en(mat, beta: torch.Tensor, scale: torch.Tensor, maxabs: torch.Tensor,
                stall: torch.Tensor, resid: torch.Tensor, s_quad: torch.Tensor,
                f_lin: torch.Tensor, y: torch.Tensor, buf: torch.Tensor, raw_b: torch.Tensor,
                i_f: torch.Tensor, sel_f: torch.Tensor, delta: torch.Tensor, refresh: bool,
                pairwise: bool, cfg, en: DirEN):
    """The elastic-net's direction tail, in the kernel's EN instantiation:
    ``dir_tail``'s arguments, ``sel_f`` the FW vertex's shifted score, and
    ``en`` (``DirEN``: l2 and Q in the state's dtype); the buffer's scores
    are shifted inside the launch. Returns a ``DirTailOut`` with Q."""
    return _dir(dir_tail_en, mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf,
                raw_b, i_f, sel_f, delta, refresh, pairwise, cfg, en)


def dir_tail_given(zcols, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b, i_f,
                   sel_f, delta, refresh: bool, pairwise: bool, cfg, complete=None):
    """The lasso's direction tail on a rank's sample slice with the columns
    given: ``zcols (n_buf + 2, m)`` (``dir_column_ids``' columns, completed
    across the ranks that split the features), the kernel's ``GIVEN``
    instantiation. Without ``complete`` one launch; with it (the samples
    split across ranks) a launch for the three dots, ``complete`` of them,
    a launch for the rest, and S and F refreshed on the host when asked.
    A CPU tensor takes ``dir_tail_given_plain``. Returns a ``DirTailOut``."""
    return _dir(dir_tail_given, zcols, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf,
                raw_b, i_f, sel_f, delta, refresh, pairwise, cfg, None, complete)


def dir_tail_en_given(zcols, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b,
                      i_f, sel_f, delta, refresh: bool, pairwise: bool, cfg, en: DirEN,
                      complete=None):
    """``dir_tail_given`` for the elastic-net (the EN ``GIVEN``
    instantiation)."""
    return _dir(dir_tail_en_given, zcols, beta, scale, maxabs, stall, resid, s_quad, f_lin, y,
                buf, raw_b, i_f, sel_f, delta, refresh, pairwise, cfg, en, complete)


def _dir(wrapper, mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b, i_f,
         sel_f, delta, refresh, pairwise, cfg, en, complete=None):
    """``dir_tail`` (``en`` None) or ``dir_tail_en``, or their ``GIVEN``
    forms (``wrapper`` ``dir_tail_given``/``dir_tail_en_given``, ``mat`` the
    columns): the plain version on a CPU tensor, else one cooperative
    launch (two with ``complete``), counted on ``wrapper``."""
    given = wrapper in (dir_tail_given, dir_tail_en_given)
    if beta.dim() != 1 or resid.shape != y.shape or y.dim() != 1:
        raise ValueError(f"need beta (p,), resid and y (m,), got {tuple(beta.shape)}, "
                         f"{tuple(resid.shape)}, {tuple(y.shape)}")
    if buf.dim() != 1 or buf.numel() == 0 or raw_b.shape != buf.shape:
        raise ValueError(f"need a buffer (n >= 1,) and its scores (n,), got {tuple(buf.shape)}, "
                         f"{tuple(raw_b.shape)}")
    if given and (mat.dim() != 2 or mat.shape != (buf.numel() + 2, y.shape[0])):
        raise ValueError(f"need the columns ({buf.numel() + 2}, {y.shape[0]}), got "
                         f"{tuple(mat.shape)}")
    if beta.device.type == "cpu":
        if given:
            return dir_tail_given_plain(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y,
                                        buf, raw_b, i_f, sel_f, delta, refresh, pairwise, cfg,
                                        en, complete)
        return dir_tail_plain(mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf,
                              raw_b, i_f, sel_f, delta, refresh, pairwise, cfg, en)
    sparse = isinstance(mat, tuple)
    X, rows = mat if sparse else (mat, None)
    dtype = beta.dtype
    q_norm = None if en is None else en.q_norm
    if any(t.dtype != dtype for t in (X, scale, maxabs, s_quad, f_lin, resid, y)
           + (() if en is None else (q_norm,))):
        raise TypeError(f"{wrapper.__name__} needs the matrix, beta, its scalars, the residual "
                        "and y in one dtype")
    if (stall.dtype != torch.int32 or buf.dtype != torch.int64 or i_f.dtype != torch.int64
            or raw_b.dtype != torch.float32 or delta.dtype != torch.float32):
        raise TypeError(f"{wrapper.__name__} needs stall int32, the buffer and i_f int64, its "
                        "scores and delta float32")
    if sparse and (rows.dtype != torch.int32 or rows.shape != X.shape):
        raise TypeError("the row slots must be int32, the values' shape")
    if not sparse and not given and (X.dim() != 2 or X.shape != (beta.shape[0], y.shape[0])):
        raise ValueError(f"need Xt (p, m) = ({beta.shape[0]}, {y.shape[0]}), got "
                         f"{tuple(X.shape)}")
    if buf.numel() > DIR_MAX_SLOTS:
        raise ValueError(f"{wrapper.__name__} takes a buffer of at most {DIR_MAX_SLOTS} slots, "
                         f"got {buf.numel()}")
    sel_f = sel_f.float()
    dev = _build.require_cuda(X, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf,
                              raw_b, i_f, sel_f, delta, *(() if rows is None else (rows,)),
                              *(() if en is None else (q_norm,)))
    m = y.shape[0]
    blocks = -(-m // DIR_ROWS)
    r_out = torch.empty(m, dtype=dtype, device=dev)
    s_out = torch.empty(5 if en is None else 6, dtype=dtype, device=dev)
    stall_out = torch.empty((), dtype=torch.int32, device=dev)
    buf_out = torch.empty_like(buf)
    i_out = torch.empty(2, dtype=torch.int64, device=dev)
    g_out = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(5 * blocks, dtype=torch.float32, device=dev)

    def launch(phase, dots, refresh_):
        args = (beta.data_ptr(), beta.shape[0],
                scale.data_ptr(), maxabs.data_ptr(), stall.data_ptr(), s_quad.data_ptr(),
                f_lin.data_ptr(), None if en is None else q_norm.data_ptr(), resid.data_ptr(),
                y.data_ptr(), buf.data_ptr(), buf.numel(), raw_b.data_ptr(), i_f.data_ptr(),
                sel_f.data_ptr(), delta.data_ptr(), m, int(pairwise), int(refresh_),
                0.0 if en is None else _build.f32(en.l2), _build.f32(cfg.renorm_threshold),
                _build.f32(cfg.eps_den), _build.f32(cfg.gap_rtol), _build.f32(cfg.tol),
                r_out.data_ptr(), s_out.data_ptr(), stall_out.data_ptr(), buf_out.data_ptr(),
                i_out.data_ptr(), g_out.data_ptr(), scratch.data_ptr())
        with torch.cuda.device(dev):
            if given:
                fn = _build.function("step_tail", "dir_tail_given_launch", _DIR_GIVEN_ARGTYPES)
                err = fn(X.data_ptr(), *args, phase,
                         None if dots is None else dots.data_ptr(), _build.dtype_code(beta),
                         _build.stream(dev))
            else:
                fn = _build.function("step_tail", "dir_tail_launch", _DIR_ARGTYPES)
                err = fn(X.data_ptr(), None if rows is None else rows.data_ptr(),
                         X.shape[-1] if sparse else 0, *args, _build.dtype_code(beta),
                         _build.stream(dev))
            wrapper.launches += 1
        _build.check("step_tail", err, wrapper.__name__)

    if complete is None:
        launch(0, None, refresh)
    else:  # the dots, completed across the sample slices, then the rest
        dots = torch.empty(3, dtype=torch.float32, device=dev)
        launch(1, dots, False)
        dots = complete(dots)
        launch(2, dots, False)
        if refresh:
            s_new, f_new = _refresh_dots(r_out, y.float(), complete)
            s_out[3], s_out[4] = s_new.to(dtype), f_new.to(dtype)
    new_scale, new_maxabs, step_inf, new_s, new_f, *q = s_out.unbind()
    i_star, i_a = i_out.unbind()
    return DirTailOut(beta, new_scale, new_maxabs, step_inf, stall_out, r_out, new_s, new_f,
                      q[0] if q else None, buf_out, i_star, i_a, g_out)


dir_tail.launches = 0
dir_tail_en.launches = 0
dir_tail_given.launches = 0
dir_tail_en_given.launches = 0


# --------------------------------------------------------------------------
# The direction tail of L lanes (the batched engine's away and pairwise rules)
# --------------------------------------------------------------------------


def dir_tail_lanes_plain(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, buf,
                         raw_b, i_f, sel_f, delta, refresh, lanes, pairwise: bool, cfg,
                         en: DirEN | None = None, complete=None, given: bool = False):
    """The plain version of the lane direction tails: the one-lane plain tail
    (``dir_tail_plain``, or with ``given`` ``dir_tail_given_plain`` on the
    lane's ``(n_buf + 2, m)`` columns of ``mat``) once per listed lane, on
    its row of ``beta`` (in place) and copies of its residual, buffer,
    scores and scalars, with its own ``refresh``; a lane not listed keeps
    its residual, buffer and scalars, and its vertices are -1 and its g 0.
    Arguments and returns are ``dir_tail_lanes``'."""
    L = beta.shape[0]
    dev = beta.device
    fields = [scale, maxabs, step_inf, stall, resid, s_quad, f_lin]
    fields.append(en.q_norm if en is not None else s_quad)
    outs = [[t.clone() for t in f.unbind(0)] for f in fields]
    bufs = [b.clone() for b in buf.unbind(0)]
    i_star = torch.full((L,), -1, dtype=torch.int64, device=dev)
    i_a = torch.full((L,), -1, dtype=torch.int64, device=dev)
    g = torch.zeros(L, dtype=torch.float32, device=dev)
    run = set(lanes.tolist() if isinstance(lanes, torch.Tensor) else lanes)
    for lane in sorted(run):
        en_l = None if en is None else DirEN(en.l2, en.q_norm[lane].clone())
        args = (beta[lane], scale[lane].clone(), maxabs[lane].clone(), stall[lane].clone(),
                resid[lane].clone(), s_quad[lane].clone(), f_lin[lane].clone(), y,
                buf[lane].clone(), raw_b[lane].clone(), i_f[lane].clone(), sel_f[lane].clone(),
                delta[lane].clone(), bool(refresh[lane]), pairwise, cfg, en_l)
        if given:
            out = dir_tail_given_plain(mat[lane], *args, complete)
        else:
            out = dir_tail_plain(mat, *args)
        got = (out.scale, out.maxabs, out.step_inf, out.stall, out.resid, out.s_quad, out.f_lin,
               out.q_norm if en is not None else out.s_quad)
        for ts, t in zip(outs, got):
            ts[lane] = t
        bufs[lane] = out.buf
        i_star[lane], i_a[lane], g[lane] = out.i_star, out.i_a, out.g
    scale, maxabs, step_inf, stall, resid, s_quad, f_lin, q_norm = (torch.stack(ts)
                                                                     for ts in outs)
    return DirTailOut(beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin,
                      q_norm if en is not None else None, torch.stack(bufs), i_star, i_a, g)


def dir_tail_lanes(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, buf,
                   raw_b, i_f, sel_f, delta, refresh, lanes, pairwise: bool, cfg):
    """The lasso's direction tail for L lanes in one cooperative launch, a
    row of blocks a lane: ``beta (L, p)`` (updated in place), ``resid (L,
    m)``, the scalars ``scale``, ``maxabs``, ``step_inf``, ``stall``,
    ``s_quad``, ``f_lin``, the FW vertices ``i_f`` and their scores
    ``sel_f`` and the deltas ``delta``, each ``(L,)``, the buffers ``buf``
    and their linear scores ``raw_b`` ``(L, n_buf)``; ``mat`` and ``y`` are
    shared and the dtypes are ``dir_tail``'s. ``refresh`` (a host sequence,
    one bool a lane, False for a frozen lane) asks for each lane's exact S/F
    refresh; ``lanes`` (int32) lists the lanes that step, the others frozen
    (their outputs their inputs, vertices -1, g 0). A listed lane's outputs
    are the one-lane ``dir_tail``'s on its operands, bit for bit. A CPU
    tensor takes ``dir_tail_lanes_plain``; a CUDA tensor launches the
    kernel's LANES instantiation (or raises). Returns a ``DirTailOut`` of
    lane-stacked fields."""
    return _dir_lanes(dir_tail_lanes, mat, beta, scale, maxabs, step_inf, stall, resid, s_quad,
                      f_lin, y, buf, raw_b, i_f, sel_f, delta, refresh, lanes, pairwise, cfg, None)


def dir_tail_en_lanes(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, buf,
                      raw_b, i_f, sel_f, delta, refresh, lanes, pairwise: bool, cfg, en: DirEN):
    """The elastic-net's direction tail for L lanes (the EN LANES
    instantiation): ``dir_tail_lanes``' arguments and ``en`` (``DirEN`` of
    the lanes' ``(L,)`` Q). Returns a ``DirTailOut`` with the lanes' Q."""
    return _dir_lanes(dir_tail_en_lanes, mat, beta, scale, maxabs, step_inf, stall, resid,
                      s_quad, f_lin, y, buf, raw_b, i_f, sel_f, delta, refresh, lanes, pairwise,
                      cfg, en)


def dir_tail_lanes_given(zcols, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                         buf, raw_b, i_f, sel_f, delta, refresh, lanes, pairwise: bool, cfg,
                         complete=None):
    """``dir_tail_lanes`` on a rank's sample slice with each lane's columns
    given, ``zcols (L, n_buf + 2, m)`` (``dir_column_ids``' columns of each
    lane): the lane ``GIVEN`` instantiation. Without ``complete`` one
    launch; with it (the samples split across ranks) a launch for the
    lanes' three dots, ``complete`` of the ``(L, 3)`` dots, a launch for the
    rest, and each refreshing lane's S and F refreshed on the host."""
    return _dir_lanes(dir_tail_lanes_given, zcols, beta, scale, maxabs, step_inf, stall, resid,
                      s_quad, f_lin, y, buf, raw_b, i_f, sel_f, delta, refresh, lanes, pairwise,
                      cfg, None, complete)


def dir_tail_en_lanes_given(zcols, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                            buf, raw_b, i_f, sel_f, delta, refresh, lanes, pairwise: bool, cfg,
                            en: DirEN, complete=None):
    """``dir_tail_lanes_given`` for the elastic-net (the EN lane ``GIVEN``
    instantiation)."""
    return _dir_lanes(dir_tail_en_lanes_given, zcols, beta, scale, maxabs, step_inf, stall, resid,
                      s_quad, f_lin, y, buf, raw_b, i_f, sel_f, delta, refresh, lanes, pairwise,
                      cfg, en, complete)


# (..., scratch, lane_ids, n_run, n_lanes, refresh_l, step_inf, dtype, stream): dir_tail_launch's
# arguments with the lanes' before the dtype
_DIR_LANES_ARGTYPES = _DIR_ARGTYPES[:-2] + [_PTR, _I32, _I32, _PTR, _PTR, _I32, _PTR]
# dir_tail_given_launch's arguments with the lanes' between the dots and the dtype
_DIR_LANES_GIVEN_ARGTYPES = _DIR_GIVEN_ARGTYPES[:-2] + [_PTR, _I32, _I32, _PTR, _PTR, _I32, _PTR]
_refresh_flags: dict = {}  # (device, flags) -> the (L,) int32 flags on the device


def _refresh_arg(refresh, dev) -> torch.Tensor:
    """The lanes' refresh flags as the int32 device tensor the kernel reads,
    made once a pattern (a lane's refresh falls every refresh_every steps,
    so a path sees a handful), so a step copies nothing to the card."""
    key = (dev, tuple(bool(r) for r in refresh))
    t = _refresh_flags.get(key)
    if t is None:
        if len(_refresh_flags) > 256:
            _refresh_flags.clear()
        t = _refresh_flags[key] = torch.tensor(key[1], dtype=torch.int32, device=dev)
    return t


def _dir_lanes(wrapper, mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, buf,
               raw_b, i_f, sel_f, delta, refresh, lanes, pairwise, cfg, en, complete=None):
    """The four lane direction tails: the plain version on a CPU tensor,
    else one cooperative launch (two with ``complete``), counted on
    ``wrapper``."""
    given = wrapper in (dir_tail_lanes_given, dir_tail_en_lanes_given)
    if beta.dim() != 2 or resid.dim() != 2 or resid.shape[0] != beta.shape[0] or y.dim() != 1:
        raise ValueError(f"need beta (L, p), resid (L, m) and y (m,), got {tuple(beta.shape)}, "
                         f"{tuple(resid.shape)}, {tuple(y.shape)}")
    L, m = beta.shape[0], y.shape[0]
    if resid.shape[1] != m:
        raise ValueError(f"need resid (L, {m}), got {tuple(resid.shape)}")
    if any(t.shape != (L,) for t in (scale, maxabs, step_inf, stall, s_quad, f_lin, i_f, sel_f,
                                     delta) + (() if en is None else (en.q_norm,))):
        raise ValueError(f"need the lanes' scalars, FW vertices, scores and deltas as ({L},)")
    if buf.dim() != 2 or buf.shape[0] != L or buf.shape[1] == 0 or raw_b.shape != buf.shape:
        raise ValueError(f"need the buffers (L, n >= 1) and their scores, got "
                         f"{tuple(buf.shape)}, {tuple(raw_b.shape)}")
    if len(refresh) != L:
        raise ValueError(f"need one refresh flag a lane, got {len(refresh)} for {L} lanes")
    if lanes.dim() != 1 or lanes.dtype != torch.int32:
        raise ValueError(f"need lanes, the int32 ids of the lanes that step, got {lanes}")
    n_buf = buf.shape[1]
    if given and (mat.dim() != 3 or mat.shape != (L, n_buf + 2, m)):
        raise ValueError(f"need the columns ({L}, {n_buf + 2}, {m}), got {tuple(mat.shape)}")
    if beta.device.type == "cpu":
        return dir_tail_lanes_plain(mat, beta, scale, maxabs, step_inf, stall, resid, s_quad,
                                    f_lin, y, buf, raw_b, i_f, sel_f, delta, refresh, lanes,
                                    pairwise, cfg, en, complete, given)
    sparse = isinstance(mat, tuple)
    X, rows = mat if sparse else (mat, None)
    dtype = beta.dtype
    q_norm = None if en is None else en.q_norm
    if any(t.dtype != dtype for t in (X, scale, maxabs, step_inf, s_quad, f_lin, resid, y)
           + (() if en is None else (q_norm,))):
        raise TypeError(f"{wrapper.__name__} needs the matrix, beta, its scalars, the residual "
                        "and y in one dtype")
    if (stall.dtype != torch.int32 or buf.dtype != torch.int64 or i_f.dtype != torch.int64
            or raw_b.dtype != torch.float32 or delta.dtype != torch.float32):
        raise TypeError(f"{wrapper.__name__} needs stall int32, the buffers and i_f int64, their "
                        "scores and delta float32")
    if sparse and (rows.dtype != torch.int32 or rows.shape != X.shape):
        raise TypeError("the row slots must be int32, the values' shape")
    if not sparse and not given and (X.dim() != 2 or X.shape != (beta.shape[1], m)):
        raise ValueError(f"need Xt (p, m) = ({beta.shape[1]}, {m}), got {tuple(X.shape)}")
    if n_buf > DIR_MAX_SLOTS:
        raise ValueError(f"{wrapper.__name__} takes a buffer of at most {DIR_MAX_SLOTS} slots, "
                         f"got {n_buf}")
    sel_f = sel_f.float()
    dev = _build.require_cuda(X, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y,
                              buf, raw_b, i_f, sel_f, delta, lanes,
                              *(() if rows is None else (rows,)),
                              *(() if en is None else (q_norm,)))
    blocks = -(-m // DIR_ROWS)
    r_out = torch.empty((L, m), dtype=dtype, device=dev)
    s_out = torch.empty((5 if en is None else 6, L), dtype=dtype, device=dev)
    stall_out = torch.empty(L, dtype=torch.int32, device=dev)
    buf_out = torch.empty_like(buf)
    i_out = torch.empty((L, 2), dtype=torch.int64, device=dev)
    g_out = torch.empty(L, dtype=torch.float32, device=dev)
    scratch = torch.empty(5 * blocks * L, dtype=torch.float32, device=dev)
    flags = _refresh_arg(refresh, dev)
    any_refresh = any(bool(r) for r in refresh)

    def launch(phase, dots, refresh_):
        args = (beta.data_ptr(), beta.shape[1],
                scale.data_ptr(), maxabs.data_ptr(), stall.data_ptr(), s_quad.data_ptr(),
                f_lin.data_ptr(), None if en is None else q_norm.data_ptr(), resid.data_ptr(),
                y.data_ptr(), buf.data_ptr(), n_buf, raw_b.data_ptr(), i_f.data_ptr(),
                sel_f.data_ptr(), delta.data_ptr(), m, int(pairwise), int(refresh_),
                0.0 if en is None else _build.f32(en.l2), _build.f32(cfg.renorm_threshold),
                _build.f32(cfg.eps_den), _build.f32(cfg.gap_rtol), _build.f32(cfg.tol),
                r_out.data_ptr(), s_out.data_ptr(), stall_out.data_ptr(), buf_out.data_ptr(),
                i_out.data_ptr(), g_out.data_ptr(), scratch.data_ptr())
        lane_args = (*_build.lane_ids_arg(lanes), L,
                     (flags if refresh_ else _refresh_arg([False] * L, dev)).data_ptr(),
                     step_inf.data_ptr())
        with torch.cuda.device(dev):
            if given:
                fn = _build.function("step_tail", "dir_tail_lanes_given_launch",
                                     _DIR_LANES_GIVEN_ARGTYPES)
                err = fn(X.data_ptr(), *args, phase, None if dots is None else dots.data_ptr(),
                         *lane_args, _build.dtype_code(beta), _build.stream(dev))
            else:
                fn = _build.function("step_tail", "dir_tail_lanes_launch", _DIR_LANES_ARGTYPES)
                err = fn(X.data_ptr(), None if rows is None else rows.data_ptr(),
                         X.shape[-1] if sparse else 0, *args, *lane_args,
                         _build.dtype_code(beta), _build.stream(dev))
            wrapper.launches += 1
        _build.check("step_tail", err, wrapper.__name__)

    if complete is None:
        launch(0, None, any_refresh)
    else:  # the lanes' dots, completed across the sample slices, then the rest
        dots = torch.zeros((L, 3), dtype=torch.float32, device=dev)
        launch(1, dots, False)
        dots = complete(dots)
        launch(2, dots, False)
        yf = y.float()
        for lane, r in enumerate(refresh):
            if r:
                s_new, f_new = _refresh_dots(r_out[lane], yf, complete)
                s_out[3, lane], s_out[4, lane] = s_new.to(dtype), f_new.to(dtype)
    new_scale, new_maxabs, new_step_inf, new_s, new_f, *q = s_out.unbind()
    i_star, i_a = i_out.unbind(1)
    return DirTailOut(beta, new_scale, new_maxabs, new_step_inf, stall_out, r_out, new_s, new_f,
                      q[0] if q else None, buf_out, i_star, i_a, g_out)


dir_tail_lanes.launches = 0
dir_tail_en_lanes.launches = 0
dir_tail_lanes_given.launches = 0
dir_tail_en_lanes_given.launches = 0
