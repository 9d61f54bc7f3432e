// The unfused lasso step's tail after the argmax, in one launch: eq. 6's
// sign, eq. 8's line search, apply_coeff_update (beta in place, with the
// renorm only when the scale underflows), eq. 10 into a new residual
// (K3's op order dense, step_tail.py's sparse_residual_update's on the
// block-ELL layout) and the S/F recursions. It is K3's Hopper counterpart
// on the path (replaces the Pallas kernel at
// src/repro/kernels/residual_update/residual_update.py:45 there). See
// kernels/step_tail.py for the bound and the design.
//
// A lane axis (batched delta lanes, the LANES instantiation): blockIdx.y
// is the lane, whose beta, residual, output residual and scalars lie a
// stride past lane 0's (X, y and the column statistics are shared). A
// lane listed in lane_ids runs the step exactly as a one-lane launch on
// its operands; any other lane (frozen) copies its residual and scalars to
// the outputs and leaves beta alone, so its state is kept bit for bit. The
// one-lane instantiation compiles none of the lane code.
//
// The elastic-net's tail (the EN instantiations): eq. 6's sign from the
// winner's shifted score g_sel, the EN line search (common.cuh's
// en_line_search, which reads a_star = scale * beta[i_star] in every
// block) and Q's recursion beside S and F, written as s_out's sixth field.
// The lasso's instantiations compile none of it.
//
// The telemetry ring's record (the TEL instantiations): block 0's thread 0,
// which holds the step's scalars, writes the step's record into the ring
// (common.cuh's ring_write): k, i_star, EVENT_FW, the new stall, lam, the
// new step_inf and n_dots; with an objective (yty given), the sampled gap
// <grad, alpha> - delta_t * g_sel from the step's input scalars and the
// objective 1/2 y.y + 1/2 S - F (+ l2/2 Q) from its outputs, each op rounded
// to the state's dtype as the oracle's eager ops round it (NaN without).
// One lane: the host passes the slot, k and n_dots. Lanes: a listed lane
// reads its cursor on the device (k = cursor, a lane's records being its
// steps; n_dots = (cursor + 1) * the dots a step), writes at cursor % C and
// advances it; a frozen lane writes nothing. The TEL = false
// instantiations compile none of it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int ST_THREADS = 1024;
constexpr int ST_PER_THREAD = 4;  // residual entries a thread holds in flight
constexpr int ST_ROWS = ST_THREADS * ST_PER_THREAD;  // the residual rows a block owns

template <typename T>
struct TailArgs {
  const T* __restrict__ X;       // dense Xt (p, m), or the block-ELL values (n_feat, nnz_max)
  const int* __restrict__ rows;  // the block-ELL rows (n_feat, nnz_max); null for dense
  int nnz_max;
  T* __restrict__ beta;          // (p,), updated in place
  long long p;
  const T* __restrict__ scale;   // the state's scalars
  const T* __restrict__ maxabs;
  const int* __restrict__ stall;
  const T* __restrict__ s_quad;
  const T* __restrict__ f_lin;
  const T* __restrict__ resid;   // (m,)
  const T* __restrict__ y;       // (m,)
  const T* __restrict__ zty;     // (p,)
  const T* __restrict__ zn2;     // (p,)
  const long long* __restrict__ i_star;
  const float* __restrict__ g;   // the winner's score
  const float* __restrict__ delta;
  int m;
  float renorm_threshold, eps_den, gap_rtol, tol;
  T* __restrict__ r_out;         // (m,) the new residual
  T* __restrict__ s_out;         // (5,) scale, maxabs, step_inf, S, F
  int* __restrict__ stall_out;
  // lanes: null for one lane; else the n_run lanes that step. Lane l's
  // beta, resid and r_out start l * p, l * m and l * m elements in, its
  // scalars, i_star, g and delta are entry l of (L,) arrays, and its
  // outputs s_out[f * L + l] (field f) and stall_out[l].
  const int* __restrict__ lane_ids;
  int n_run;
  const T* __restrict__ step_inf;  // (L,) a frozen lane's step_inf, copied out
  // the elastic-net's: the winner's shifted score (g is then its linear
  // score), Q (output s_out field 5) and l2; g_sel null for the lasso
  const float* __restrict__ g_sel;
  const T* __restrict__ q_norm;
  float l2;
  // the telemetry ring (TEL): its storage (RING_WORDS * tel_cap words a
  // lane), the one-lane record's slot, k and n_dots (lanes: tel_ndots is
  // the dots a step and tel_cursor the lanes' cursors), y.y in the state's
  // dtype (null: no objective) and l2 / 2 as torch's f32 scalar
  int* __restrict__ tel;
  int tel_cap;
  long long tel_slot, tel_k, tel_ndots;
  long long* __restrict__ tel_cursor;
  const T* __restrict__ yty;
  float half_l2;
};

// x rounded to the state's dtype and back: one eager op's result
template <typename T>
__device__ __forceinline__ float rt(float x) {
  return to_f32(from_f32<T>(x));
}

// Point `a` at lane l's operands.
template <typename T, bool EN, bool TEL>
__device__ __forceinline__ void select_lane(TailArgs<T>& a, int l) {
  if constexpr (TEL) {
    a.tel += (long long)l * RING_WORDS * a.tel_cap;
    a.tel_cursor += l;
  }
  if constexpr (EN) {
    a.g_sel += l;
    a.q_norm += l;
  }
  a.beta += (long long)l * a.p;
  a.scale += l;
  a.maxabs += l;
  a.stall += l;
  a.s_quad += l;
  a.f_lin += l;
  a.resid += (long long)l * a.m;
  a.i_star += l;
  a.g += l;
  a.delta += l;
  a.r_out += (long long)l * a.m;
  a.s_out += l;
  a.stall_out += l;
  a.step_inf += l;
}

// A frozen lane: its residual rows of this block and (block 0) its scalars
// copied to the outputs unchanged.
template <typename T, bool EN>
__device__ void frozen_lane(const TailArgs<T>& a, int lo, int hi) {
  for (int k = lo + threadIdx.x; k < hi; k += ST_THREADS) a.r_out[k] = a.resid[k];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int L = gridDim.y;
    a.s_out[0] = *a.scale;
    a.s_out[L] = *a.maxabs;
    a.s_out[2 * L] = *a.step_inf;
    a.s_out[3 * L] = *a.s_quad;
    a.s_out[4 * L] = *a.f_lin;
    if constexpr (EN) a.s_out[5 * L] = *a.q_norm;
    *a.stall_out = *a.stall;
  }
}

// thread 0's scalars, handed to its block
struct TailShared {
  float lam, dt, one_m, new_scale, acc0;
  int renorm;
};

// Block b owns the residual rows [b * ST_ROWS, (b + 1) * ST_ROWS): it alone
// writes them, so the blocks share nothing they write. Every block's
// thread 0 computes the same scalars from the inputs; block 0 alone writes
// the coefficient, the statistics and S, F. Every load a thread needs is
// issued before the barrier that hands it the scalars.
template <typename T, bool SPARSE, bool LANES, bool EN, bool TEL>
__global__ void __launch_bounds__(ST_THREADS) step_tail_kernel(TailArgs<T> a) {
  __shared__ TailShared sh;
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * ST_ROWS, hi = min(a.m, lo + ST_ROWS);
  const int L = LANES ? gridDim.y : 1;  // s_out's field stride
  if constexpr (LANES) {
    const int l = blockIdx.y;
    bool listed = false;
    for (int k = 0; k < a.n_run; ++k) listed |= a.lane_ids[k] == l;
    select_lane<T, EN, TEL>(a, l);
    if (!listed) {
      frozen_lane<T, EN>(a, lo, hi);
      return;
    }
  }
  const long long i = *a.i_star;

  // ---- loads: this thread's rows of the residual and y (and the winner's
  // row), and, sparse, one slot of the winner with its row's inputs --------
  float rv[ST_PER_THREAD], yv[ST_PER_THREAD], zv[ST_PER_THREAD];
  const T* z = a.X + i * (long long)a.m;
#pragma unroll
  for (int e = 0; e < ST_PER_THREAD; ++e) {
    const int k = lo + tid + e * ST_THREADS;
    if (k < hi) {
      rv[e] = to_f32(a.resid[k]);
      yv[e] = to_f32(a.y[k]);
      if (!SPARSE) zv[e] = to_f32(z[k]);
    }
  }
  // sparse: the winner's slot tid (the first of this thread's slots) and
  // its row's inputs, where this block owns the row (a feature's rows are
  // distinct; padding holds value 0 at row 0, which block 0 owns)
  const long long base = SPARSE ? i * a.nnz_max : 0;
  int srow = -1;
  float sval = 0.f, sr = 0.f, sy = 0.f;
  if (SPARSE && tid < a.nnz_max) {
    const int r = a.rows[base + tid];
    if (r >= lo && r < hi) {
      srow = r;
      sval = to_f32(a.X[base + tid]);
      sr = to_f32(a.resid[r]);
      sy = to_f32(a.y[r]);
    }
  }
  float S = 0.f, F = 0.f, Q = 0.f, zty = 0.f, zn2 = 0.f, scale = 0.f, b0 = 0.f;
  LineSearch ls;
  if (tid == 0) {
    scale = to_f32(*a.scale);
    S = to_f32(*a.s_quad);
    F = to_f32(*a.f_lin);
    zty = to_f32(a.zty[i]);
    zn2 = to_f32(a.zn2[i]);
    if (EN || blockIdx.x == 0) b0 = to_f32(a.beta[i]);
    if constexpr (EN) {
      Q = to_f32(*a.q_norm);
      ls = en_line_search(*a.g, *a.g_sel, __fmul_rn(scale, b0), *a.delta, S, F, Q, zty, zn2,
                          a.l2, a.eps_den, a.gap_rtol);
    } else {
      ls = lasso_line_search(*a.g, *a.delta, S, F, zty, zn2, a.eps_den, a.gap_rtol);
    }
    sh.lam = ls.lam;
    sh.dt = ls.dt;
    sh.one_m = __fsub_rn(1.f, ls.lam);
    sh.new_scale = __fmul_rn(scale, sh.one_m);
    sh.renorm = sh.new_scale < a.renorm_threshold;
    sh.acc0 = -0.f;  // the identity of +: the row-0 slots' terms add to it
  }
  __syncthreads();
  const float lam = sh.lam, dt = sh.dt, one_m = sh.one_m;

  // ---- eq. 10 over this block's rows -----------------------------------------
#pragma unroll
  for (int e = 0; e < ST_PER_THREAD; ++e) {
    const int k = lo + tid + e * ST_THREADS;
    if (k < hi) {
      const float u = __fmul_rn(one_m, rv[e]);
      const float v = SPARSE ? __fmul_rn(lam, yv[e])
                             : __fmul_rn(lam, __fsub_rn(yv[e], __fmul_rn(dt, zv[e])));
      a.r_out[k] = from_f32<T>(__fadd_rn(u, v));
    }
  }
  // the rare renorm: beta *= new_scale, a contiguous share of it a block,
  // all but beta[i_star], which block 0 writes once from its value before
  // the step
  if (sh.renorm) {
    const float f = sh.new_scale;
    const long long share = (a.p + gridDim.x - 1) / gridDim.x;
    const long long q0 = blockIdx.x * share, q1 = min(a.p, q0 + share);
    for (long long q = q0 + tid; q < q1; q += ST_THREADS)
      if (q != i) a.beta[q] = from_f32<T>(__fmul_rn(to_f32(a.beta[q]), f));
  }

  // ---- sparse: out[row] = (1 - lam) r + lam y + (-lam * dt) * value ---------
  // A slot at row r != 0 rewrites out[r] from the row's f32 value (so a bf16
  // result is rounded once, as the plain version's f32 sum is), after the
  // barrier that orders it behind the row's eq. 10 write. The row-0 slots'
  // terms are summed in shared memory: of them at most one is nonzero, so
  // their sum and its addition to out[0] give the bits of the plain
  // version's adds in slot order.
  if (SPARSE) {
    __syncthreads();
    const float c = __fmul_rn(-lam, dt);
    for (int k = tid; k < a.nnz_max; k += ST_THREADS) {
      if (k != tid) {  // slots past the first ST_THREADS: loaded here
        const int r = a.rows[base + k];
        srow = r >= lo && r < hi ? r : -1;
        if (srow >= 0) {
          sval = to_f32(a.X[base + k]);
          sr = to_f32(a.resid[r]);
          sy = to_f32(a.y[r]);
        }
      }
      if (srow < 0) continue;
      const float term = __fmul_rn(c, sval);
      if (srow != 0) {
        const float u = __fadd_rn(__fmul_rn(one_m, sr), __fmul_rn(lam, sy));
        a.r_out[srow] = from_f32<T>(__fadd_rn(u, term));
      } else {
        atomicAdd(&sh.acc0, term);
      }
    }
  }

  // ---- apply_coeff_update's coefficient and statistics, then S/F -----------
  if (tid == 0 && blockIdx.x == 0) {
    const float a_star = __fmul_rn(scale, b0);
    float b = b0;
    float sc = sh.new_scale;
    if (sh.renorm) {
      b = to_f32(from_f32<T>(__fmul_rn(b0, sh.new_scale)));
      sc = 1.f;
    }
    const T bi = from_f32<T>(__fadd_rn(b, coeff_increment(dt, lam, sc, a.eps_den)));
    a.beta[i] = bi;
    float maxabs = to_f32(*a.maxabs), step_inf = 0.f;
    int stall = *a.stall;
    stop_stats(lam, one_m, dt, a_star, __fmul_rn(sc, to_f32(bi)), ls.no_prog, a.tol, maxabs,
               step_inf, stall);
    // <grad, alpha> = S - F (+ l2 Q) from the inputs, for the record's gap
    float ga = 0.f;
    if constexpr (TEL) {
      ga = rt<T>(__fsub_rn(S, F));
      if constexpr (EN) ga = rt<T>(__fadd_rn(ga, rt<T>(__fmul_rn(a.l2, Q))));
    }
    sf_recursion(S, F, ls.g_lin, lam, dt, zty, zn2);
    a.s_out[0] = from_f32<T>(sc);
    a.s_out[L] = from_f32<T>(maxabs);
    a.s_out[2 * L] = from_f32<T>(step_inf);
    a.s_out[3 * L] = from_f32<T>(S);
    a.s_out[4 * L] = from_f32<T>(F);
    float Q1 = 0.f;
    if constexpr (EN) {
      Q1 = q_recursion(Q, lam, dt, a_star);
      a.s_out[5 * L] = from_f32<T>(Q1);
    }
    *a.stall_out = stall;
    if constexpr (TEL) {
      float gap = ring_nan(), obj = ring_nan();
      if (a.yty != nullptr) {
        gap = __fsub_rn(ga, __fmul_rn(dt, EN ? *a.g_sel : *a.g));
        // 0.5 * yty + 0.5 * S - F (+ (0.5 * l2) * Q) on the stored outputs
        obj = rt<T>(__fsub_rn(rt<T>(__fadd_rn(rt<T>(__fmul_rn(0.5f, to_f32(*a.yty))),
                                              rt<T>(__fmul_rn(0.5f, rt<T>(S))))),
                              rt<T>(F)));
        if constexpr (EN) obj = rt<T>(__fadd_rn(obj, rt<T>(__fmul_rn(a.half_l2, rt<T>(Q1)))));
      }
      long long slot = a.tel_slot, k = a.tel_k, n = a.tel_ndots;
      if constexpr (LANES) {
        k = *a.tel_cursor;
        slot = k % a.tel_cap;
        n = (k + 1) * a.tel_ndots;
        *a.tel_cursor = k + 1;
      }
      ring_write(a.tel, a.tel_cap, slot, k, i, 0 /* EVENT_FW */, stall, lam, gap, obj, step_inf,
                 n);
    }
  }
  if (SPARSE && blockIdx.x == 0) {
    __syncthreads();  // every row-0 term is in sh.acc0
    if (tid == 0) {
      const float u = __fadd_rn(__fmul_rn(one_m, to_f32(a.resid[0])),
                                __fmul_rn(lam, to_f32(a.y[0])));
      a.r_out[0] = from_f32<T>(__fadd_rn(u, sh.acc0));
    }
  }
}

template <typename T, bool SPARSE, bool LANES, bool TEL>
static void launch_tail_tel(const TailArgs<T>& a, dim3 grid, cudaStream_t s) {
  if (a.g_sel != nullptr)
    step_tail_kernel<T, SPARSE, LANES, true, TEL><<<grid, ST_THREADS, 0, s>>>(a);
  else
    step_tail_kernel<T, SPARSE, LANES, false, TEL><<<grid, ST_THREADS, 0, s>>>(a);
}

template <typename T, bool SPARSE, bool LANES>
static void launch_tail(const TailArgs<T>& a, dim3 grid, cudaStream_t s) {
  if (a.tel != nullptr)
    launch_tail_tel<T, SPARSE, LANES, true>(a, grid, s);
  else
    launch_tail_tel<T, SPARSE, LANES, false>(a, grid, s);
}

template <typename T>
static int launch(const void* X, const int* rows, int nnz_max, void* beta, long long p,
                  const void* scale, const void* maxabs, const int* stall, const void* s_quad,
                  const void* f_lin, const void* resid, const void* y, const void* zty,
                  const void* zn2, const long long* i_star, const float* g, const float* delta,
                  int m, float renorm_threshold, float eps_den, float gap_rtol, float tol,
                  void* r_out, void* s_out, int* stall_out, const int* lane_ids, int n_run,
                  int n_lanes, const void* step_inf, const float* g_sel, const void* q_norm,
                  float l2, int* tel, int tel_cap, long long tel_slot, long long tel_k,
                  long long tel_ndots, long long* tel_cursor, const void* yty, float half_l2,
                  cudaStream_t s) {
  TailArgs<T> a{static_cast<const T*>(X),      rows,
                nnz_max,                       static_cast<T*>(beta),
                p,                             static_cast<const T*>(scale),
                static_cast<const T*>(maxabs), stall,
                static_cast<const T*>(s_quad), static_cast<const T*>(f_lin),
                static_cast<const T*>(resid),  static_cast<const T*>(y),
                static_cast<const T*>(zty),    static_cast<const T*>(zn2),
                i_star,                        g,
                delta,                         m,
                renorm_threshold,              eps_den,
                gap_rtol,                      tol,
                static_cast<T*>(r_out),        static_cast<T*>(s_out),
                stall_out,                     lane_ids,
                n_run,                         static_cast<const T*>(step_inf),
                g_sel,                         static_cast<const T*>(q_norm),
                l2,                            tel,
                tel_cap,                       tel_slot,
                tel_k,                         tel_ndots,
                tel_cursor,                    static_cast<const T*>(yty),
                half_l2};
  if (m < 1) return (int)cudaErrorInvalidValue;
  if (lane_ids == nullptr ? n_lanes != 1
                          : n_lanes < 1 || n_lanes > 65535 || n_run < 0 || n_run > n_lanes ||
                                step_inf == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((g_sel == nullptr) != (q_norm == nullptr)) return (int)cudaErrorInvalidValue;
  if (tel != nullptr && (tel_cap < 1 || (lane_ids != nullptr) != (tel_cursor != nullptr) ||
                         (lane_ids == nullptr && (tel_slot < 0 || tel_slot >= tel_cap))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + ST_ROWS - 1) / ST_ROWS, n_lanes);
  if (lane_ids == nullptr) {
    if (rows != nullptr)
      launch_tail<T, true, false>(a, grid, s);
    else
      launch_tail<T, false, false>(a, grid, s);
  } else if (rows != nullptr) {
    launch_tail<T, true, true>(a, grid, s);
  } else {
    launch_tail<T, false, true>(a, grid, s);
  }
  return (int)cudaGetLastError();
}

// rows == nullptr: the dense layout (X is Xt (p, m)); otherwise X and rows
// are the block-ELL arrays, nnz_max slots a feature. lane_ids == nullptr:
// one lane (n_lanes 1; n_run and step_inf unused); otherwise n_lanes lanes
// of which the n_run listed ones step (see TailArgs). g_sel == nullptr:
// the lasso's tail; otherwise the elastic-net's, with q_norm (in the
// state's dtype) and l2, and s_out holds 6 fields. tel == nullptr: no ring
// record; otherwise the TEL instantiation writes one a stepping lane (see
// TailArgs), with the gap and the objective when yty is given.
extern "C" int step_tail_launch(const void* X, const int* rows, int nnz_max, void* beta,
                                long long p, const void* scale, const void* maxabs,
                                const int* stall, const void* s_quad, const void* f_lin,
                                const void* resid, const void* y, const void* zty,
                                const void* zn2, const long long* i_star, const float* g,
                                const float* delta, int m, float renorm_threshold,
                                float eps_den, float gap_rtol, float tol, void* r_out,
                                void* s_out, int* stall_out, const int* lane_ids, int n_run,
                                int n_lanes, const void* step_inf, int dtype, const float* g_sel,
                                const void* q_norm, float l2, int* tel, int tel_cap,
                                long long tel_slot, long long tel_k, long long tel_ndots,
                                long long* tel_cursor, const void* yty, float half_l2,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(X, rows, nnz_max, beta, p, scale, maxabs, stall, s_quad, f_lin, resid,
                         y, zty, zn2, i_star, g, delta, m, renorm_threshold, eps_den, gap_rtol,
                         tol, r_out, s_out, stall_out, lane_ids, n_run, n_lanes, step_inf, g_sel,
                         q_norm, l2, tel, tel_cap, tel_slot, tel_k, tel_ndots, tel_cursor, yty,
                         half_l2, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(X, rows, nnz_max, beta, p, scale, maxabs, stall, s_quad, f_lin,
                                 resid, y, zty, zn2, i_star, g, delta, m, renorm_threshold,
                                 eps_den, gap_rtol, tol, r_out, s_out, stall_out, lane_ids, n_run,
                                 n_lanes, step_inf, g_sel, q_norm, l2, tel, tel_cap, tel_slot, tel_k,
                                 tel_ndots, tel_cursor, yty, half_l2, s);
  return (int)cudaErrorInvalidValue;
}


// ---- the direction tail of the away and pairwise rules ---------------------
//
// DirRule.step after its FW vertex and the active-set buffer's linear scores
// (kernels/step_tail.py's dir_tail_plain, the reference's
// core/step_rule.py:248-318), in one cooperative launch: the away vertex over
// the buffer (with the elastic-net's shift raw + l2 * (scale * beta[buf])),
// the away-or-FW choice, u = df z_f + da z_a, the three O(m) dots <v, u>,
// <u, u>, <u, y> (v = y - R), the line search, apply_dir_update, the residual
// (1 + g t) R - g t y - g u, the S/F (and Q) recursions, the exact S/F refresh
// when the host asks, and insert_active. There is no Pallas kernel behind it:
// the reference runs this as XLA ops. See kernels/step_tail.py for the bound.
//
// The line search needs the three dots before g is known: block b owns the
// residual rows [b * DT_ROWS, (b + 1) * DT_ROWS), sums its rows' products in
// a fixed order, writes its partials, and after one grid sync every block's
// thread 0 adds the blocks' partials in block order, so every block holds
// the same g and two launches give the same bits. The refresh's two dots of
// the new residual take a second grid sync. Every block recomputes the
// buffer's argmax and the choice (a few hundred flops) from the same inputs.
// All reads of beta happen before the first sync and all writes after it:
// the renorm's share of beta is a block's, the two atoms block 0's, and
// insert_active reads the post-update |beta| of the buffer's slots from
// their values before the step, renormalised or moved as the step moves them.
constexpr int DT_THREADS = 1024;
constexpr int DT_PER_THREAD = 4;
constexpr int DT_ROWS = DT_THREADS * DT_PER_THREAD;
constexpr int DT_WARPS = DT_THREADS / 32;
constexpr int DT_MAX_SLOTS = 512;

template <typename T>
struct DirArgs {
  const T* __restrict__ X;       // dense Xt (p, m), or the block-ELL values (n_feat, nnz_max)
  const int* __restrict__ rows;  // the block-ELL rows; null for dense
  int nnz_max;
  T* __restrict__ beta;          // (p,), updated in place
  long long p;
  const T* __restrict__ scale;
  const T* __restrict__ maxabs;
  const int* __restrict__ stall;
  const T* __restrict__ s_quad;
  const T* __restrict__ f_lin;
  const T* __restrict__ q_norm;  // the elastic-net's Q; null for the lasso
  const T* __restrict__ resid;   // (m,)
  const T* __restrict__ y;       // (m,)
  const long long* __restrict__ buf;  // (n_buf,) the active set, -1 empty
  int n_buf;
  const float* __restrict__ raw_b;    // (n_buf,) its linear scores
  const long long* __restrict__ i_f;  // the FW vertex
  const float* __restrict__ sel_f;    // its selected score
  const float* __restrict__ delta;
  int m, pairwise, refresh;
  float l2, renorm_threshold, eps_den, gap_rtol, tol;
  T* __restrict__ r_out;         // (m,)
  T* __restrict__ s_out;         // scale, maxabs, step_inf, S, F[, Q]
  int* __restrict__ stall_out;
  long long* __restrict__ buf_out;  // (n_buf,)
  long long* __restrict__ i_out;    // i_star = use_alt ? i_a : i_f, i_a
  float* __restrict__ g_out;
  float* __restrict__ scratch;      // 5 floats a block: the dots' and the refresh's partials
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// what thread 0 hands its block
struct DirShared {
  float sel[DT_MAX_SLOTS], a[DT_MAX_SLOTS], b0[DT_MAX_SLOTS];  // the slots' sel, alpha, beta
  float red[DT_WARPS][3];
  float t, df, da, a_f, a_a, sel_a, g_max, ba0;  // the choice (thread 0's, for block 0)
  float g, gt, one_gt, new_scale;                 // the line search's
  long long i_a;
  int use_alt, renorm;
};

// Block-wide sums of N values a thread, in a fixed order (warp butterflies,
// then the warps in order on thread 0); thread 0 returns them in v.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float (&red)[DT_WARPS][3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = warp_sum(v[c]);
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < N; ++c) red[warp][c] = v[c];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      float s = red[0][c];
      for (int w = 1; w < DT_WARPS; ++w) s = __fadd_rn(s, red[w][c]);
      v[c] = s;
    }
}

// the blocks' partials c0..c0+N-1 summed in block order (read from L2: they
// were written by other blocks before the grid sync)
template <int N>
__device__ __forceinline__ void grid_sums(const float* scratch, int c0, float (&v)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    float s = __ldcg(scratch + c0 + c);
    for (int b = 1; b < (int)gridDim.x; ++b) s = __fadd_rn(s, __ldcg(scratch + 5 * b + c0 + c));
    v[c] = s;
  }
}

template <typename T, bool SPARSE, bool EN>
__global__ void __launch_bounds__(DT_THREADS) dir_tail_kernel(DirArgs<T> a) {
  __shared__ DirShared sh;
  __shared__ float zs[SPARSE ? 2 * DT_ROWS : 1];  // sparse: z_f, z_a on this block's rows
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * DT_ROWS, hi = min(a.m, lo + DT_ROWS);
  const long long i_f = *a.i_f, p = a.p;

  // ---- loads: this thread's rows of R, y (and, dense, z_f); the slots ----
  float rv[DT_PER_THREAD], yv[DT_PER_THREAD], zf[DT_PER_THREAD], za[DT_PER_THREAD];
#pragma unroll
  for (int e = 0; e < DT_PER_THREAD; ++e) {
    const int k = lo + tid + e * DT_THREADS;
    rv[e] = yv[e] = zf[e] = za[e] = 0.f;
    if (k < hi) {
      rv[e] = to_f32(a.resid[k]);
      yv[e] = to_f32(a.y[k]);
      if (!SPARSE) zf[e] = to_f32(a.X[i_f * (long long)a.m + k]);
    }
    if (SPARSE) zs[tid + e * DT_THREADS] = zs[DT_ROWS + tid + e * DT_THREADS] = 0.f;
  }
  const float scale = to_f32(*a.scale);
  for (int s = tid; s < a.n_buf; s += DT_THREADS) {
    const long long b = a.buf[s];
    const float bv = to_f32(a.beta[b < 0 ? 0 : (b >= p ? p - 1 : b)]);
    const float al = __fmul_rn(scale, bv);
    sh.b0[s] = bv;
    sh.a[s] = al;
    sh.sel[s] = EN ? __fadd_rn(a.raw_b[s], __fmul_rn(a.l2, al)) : a.raw_b[s];
  }
  float S = 0.f, F = 0.f, Q = 0.f, delta = 0.f, sel_f = 0.f, bf0 = 0.f, beta0 = 0.f;
  if (tid == 0) {
    S = to_f32(*a.s_quad);
    F = to_f32(*a.f_lin);
    if (EN) Q = to_f32(*a.q_norm);
    delta = *a.delta;
    sel_f = *a.sel_f;
    bf0 = to_f32(a.beta[i_f]);
    beta0 = to_f32(a.beta[0]);  // the away atom's dummy when no slot is valid
  }
  __syncthreads();
  // sparse: z_f's slots on this block's rows (a feature's rows are distinct;
  // the padding and stored zeros add nothing to the zeros)
  if (SPARSE) {
    for (int k = tid; k < a.nnz_max; k += DT_THREADS) {
      const long long slot = i_f * a.nnz_max + k;
      const int r = a.rows[slot];
      const float v = to_f32(a.X[slot]);
      if (r >= lo && r < hi && v != 0.f) zs[r - lo] = v;
    }
  }

  // ---- the away vertex: the first max of sign(alpha) * sel over the valid
  // slots (warp 0), then the choice (thread 0) ----------------------------
  if (tid < 32) {
    float best = -INFINITY;
    long long bj = LLONG_MAX;
    bool any = false;
    for (int s = tid; s < a.n_buf; s += 32) {
      const float al = sh.a[s];
      const bool valid = a.buf[s] >= 0 && al != 0.f;
      any |= valid;
      const float sc = valid ? __fmul_rn(sign_of(al), sh.sel[s]) : -INFINITY;
      if (better(sc, s, best, bj)) {
        best = sc;
        bj = s;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const long long oj = __shfl_xor_sync(0xffffffffu, bj, o);
      if (better(ob, oj, best, bj)) {
        best = ob;
        bj = oj;
      }
    }
    const bool any_valid = __any_sync(0xffffffffu, any);
    if (tid == 0) {
      const int j = (int)bj;
      const float sel_a = sh.sel[j], a_a = sh.a[j], sigma_a = sign_of(a_a);
      const long long bj_id = a.buf[j];
      const long long i_a = any_valid ? (bj_id < 0 ? 0 : (bj_id >= p ? p - 1 : bj_id)) : 0;
      const float df_fw = __fmul_rn(-delta, sign_of(sel_f));
      const float a_f = __fmul_rn(scale, bf0);
      const float w_a = __fdiv_rn(fabsf(a_a), nan_max(delta, a.eps_den));
      const bool usable = any_valid && w_a > 0.f;
      float ga = 0.f;
      bool use_alt;
      float t, df, g_max;
      if (a.pairwise) {
        use_alt = usable && __fadd_rn(fabsf(sel_f), __fmul_rn(sigma_a, sel_a)) > 0.f;
        t = use_alt ? 0.f : -1.f;
        df = df_fw;
        g_max = use_alt ? w_a : 1.f;
      } else {
        ga = __fsub_rn(S, F);
        if (EN) ga = __fadd_rn(ga, __fmul_rn(a.l2, Q));
        const float fw_gap = __fsub_rn(ga, __fmul_rn(df_fw, sel_f));
        const float away_gap = __fsub_rn(__fmul_rn(__fmul_rn(sigma_a, delta), sel_a), ga);
        use_alt = usable && away_gap > fw_gap;
        t = use_alt ? 1.f : -1.f;
        df = use_alt ? 0.f : df_fw;
        g_max = use_alt ? nan_min(__fdiv_rn(w_a, nan_max(__fsub_rn(1.f, w_a), a.eps_den)), 1e3f)
                        : 1.f;
      }
      const float da = use_alt ? __fmul_rn(-sigma_a, delta) : 0.f;
      sh.t = t;
      sh.df = df;
      sh.da = da;
      sh.i_a = i_a;
      sh.a_f = a_f;
      sh.a_a = a_a;
      sh.sel_a = sel_a;
      sh.g_max = g_max;
      sh.use_alt = use_alt;
      sh.ba0 = any_valid ? sh.b0[j] : beta0;  // beta[i_a] before the step
    }
  }
  __syncthreads();
  const float t = sh.t, df = sh.df, da = sh.da;
  const float a_f = sh.a_f, a_a = sh.a_a, sel_a = sh.sel_a, g_max = sh.g_max, ba0 = sh.ba0;
  const long long i_a = sh.i_a;
  const bool use_alt = sh.use_alt;
  if (SPARSE) {
    for (int k = tid; k < a.nnz_max; k += DT_THREADS) {
      const long long slot = i_a * a.nnz_max + k;
      const int r = a.rows[slot];
      const float v = to_f32(a.X[slot]);
      if (r >= lo && r < hi && v != 0.f) zs[DT_ROWS + r - lo] = v;
    }
    __syncthreads();
  }

  // ---- u = df z_f + da z_a and this block's partials of <v,u>, <u,u>, <u,y>
  float dots[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < DT_PER_THREAD; ++e) {
    const int k = lo + tid + e * DT_THREADS;
    if (k < hi) {
      if (SPARSE) {
        zf[e] = zs[k - lo];
        za[e] = zs[DT_ROWS + k - lo];
      } else {
        za[e] = to_f32(a.X[i_a * (long long)a.m + k]);
      }
      const float u = __fadd_rn(__fmul_rn(df, zf[e]), __fmul_rn(da, za[e]));
      zf[e] = u;  // u on this row from here on
      const float v = __fsub_rn(yv[e], rv[e]);
      dots[0] = fmaf(v, u, dots[0]);
      dots[1] = fmaf(u, u, dots[1]);
      dots[2] = fmaf(u, yv[e], dots[2]);
    }
  }
  block_sums<3>(dots, sh.red);
  if (tid == 0)
#pragma unroll
    for (int c = 0; c < 3; ++c) a.scratch[5 * blockIdx.x + c] = dots[c];
  grid.sync();

  // ---- every block: the dots, then the line search -----------------------
  float vu = 0.f, uu = 0.f, uy = 0.f, g = 0.f, scale_new = 0.f;
  bool no_prog = false;
  if (tid == 0) {
    float tot[3];
    grid_sums<3>(a.scratch, 0, tot);
    vu = tot[0];
    uu = tot[1];
    uy = tot[2];
    float ga = __fsub_rn(S, F);
    if (EN) ga = __fadd_rn(ga, __fmul_rn(a.l2, Q));
    const float num = -__fadd_rn(__fadd_rn(__fmul_rn(t, ga), __fmul_rn(df, sel_f)),
                                 __fmul_rn(da, sel_a));
    float den = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(t, t), S),
                                    __fmul_rn(__fmul_rn(2.f, t), vu)), uu);
    float scal = __fadd_rn(S, fabsf(F));
    if (EN) {
      const float cross = __fadd_rn(__fmul_rn(df, a_f), __fmul_rn(da, a_a));
      const float d2 = __fadd_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(t, t), Q),
                                        __fmul_rn(__fmul_rn(2.f, t), cross)),
                              __fmul_rn(df, df)),
                    __fmul_rn(da, da)),
          __fmul_rn(__fmul_rn(__fmul_rn(2.f, df), da), i_a == i_f ? 1.f : 0.f));
      den = __fadd_rn(den, __fmul_rn(a.l2, d2));
      scal = __fadd_rn(scal, __fmul_rn(a.l2, Q));
    }
    g = nan_min(clamp_min_nan(__fdiv_rn(num, clamp_min_nan(den, a.eps_den)), 0.f), g_max);
    const float gap_scale = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(t), scal),
                                                fabsf(__fmul_rn(df, sel_f))),
                                      fabsf(__fmul_rn(da, sel_a)));
    no_prog = num <= __fmul_rn(a.gap_rtol, gap_scale);
    const float gt = __fmul_rn(g, t);
    const float one_gt = __fadd_rn(1.f, gt);
    scale_new = __fmul_rn(scale, one_gt);
    sh.g = g;
    sh.gt = gt;
    sh.one_gt = one_gt;
    sh.new_scale = scale_new;
    sh.renorm = scale_new < a.renorm_threshold;
  }
  __syncthreads();
  const float gs = sh.g, gt = sh.gt, one_gt = sh.one_gt;

  // ---- the new residual on this block's rows; the refresh's partials -----
  float fresh[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < DT_PER_THREAD; ++e) {
    const int k = lo + tid + e * DT_THREADS;
    if (k < hi) {
      const T rn = from_f32<T>(__fsub_rn(__fsub_rn(__fmul_rn(one_gt, rv[e]), __fmul_rn(gt, yv[e])),
                                         __fmul_rn(gs, zf[e])));
      a.r_out[k] = rn;
      const float v = __fsub_rn(yv[e], to_f32(rn));
      fresh[0] = fmaf(v, v, fresh[0]);
      fresh[1] = fmaf(v, yv[e], fresh[1]);
    }
  }
  // the rare renorm: beta *= new_scale, a block's share, but the two atoms,
  // which block 0 writes once from their values before the step
  if (sh.renorm) {
    const float f = sh.new_scale;
    const long long share = (p + gridDim.x - 1) / gridDim.x;
    const long long q0 = blockIdx.x * share, q1 = min(p, q0 + share);
    for (long long q = q0 + tid; q < q1; q += DT_THREADS)
      if (q != i_f && q != i_a) a.beta[q] = from_f32<T>(__fmul_rn(to_f32(a.beta[q]), f));
  }
  if (a.refresh) {
    block_sums<2>(fresh, sh.red);
    if (tid == 0) {
      a.scratch[5 * blockIdx.x + 3] = fresh[0];
      a.scratch[5 * blockIdx.x + 4] = fresh[1];
    }
    grid.sync();
  }
  if (blockIdx.x != 0 || tid != 0) return;

  // ---- block 0, thread 0: apply_dir_update, the recursions, the buffer ----
  const bool renorm = sh.renorm, same = i_a == i_f;
  const float fsame = same ? 1.f : 0.f;
  float sc = scale_new, bf = bf0, ba = ba0;
  if (renorm) {
    bf = to_f32(from_f32<T>(__fmul_rn(bf0, scale_new)));
    ba = to_f32(from_f32<T>(__fmul_rn(ba0, scale_new)));
    sc = 1.f;
  }
  const float denom = clamp_min_nan(sc, a.eps_den);
  bf = to_f32(from_f32<T>(__fadd_rn(bf, __fdiv_rn(__fmul_rn(g, df), denom))));
  if (same) ba = bf;
  ba = to_f32(from_f32<T>(__fadd_rn(ba, __fdiv_rn(__fmul_rn(g, da), denom))));
  if (same) bf = ba;
  const bool drop = da != 0.f && g >= g_max && !same;
  if (drop) ba = 0.f;
  a.beta[i_f] = from_f32<T>(bf);
  a.beta[i_a] = from_f32<T>(ba);
  const float maxabs0 = to_f32(*a.maxabs);
  const float d_f = __fadd_rn(__fadd_rn(__fmul_rn(t, a_f), df), __fmul_rn(fsame, da));
  const float d_a = __fadd_rn(__fadd_rn(__fmul_rn(t, a_a), da), __fmul_rn(fsame, df));
  const float step_inf = __fmul_rn(g, nan_max(__fmul_rn(fabsf(t), maxabs0),
                                              nan_max(fabsf(d_f), fabsf(d_a))));
  const float maxabs = nan_max(__fmul_rn(fabsf(one_gt), maxabs0),
                               nan_max(fabsf(__fmul_rn(sc, bf)), fabsf(__fmul_rn(sc, ba))));
  const int stall = (step_inf <= a.tol || no_prog) ? *a.stall + 1 : 0;
  // S, F (and Q): the recursions, or the exact refresh of S and F
  const float two_og = __fmul_rn(2.f, one_gt);
  const float og2 = __fmul_rn(one_gt, one_gt), g2 = __fmul_rn(g, g);
  if (a.refresh) {
    float tot[2];
    grid_sums<2>(a.scratch, 3, tot);
    S = tot[0];
    F = tot[1];
  } else {
    S = __fadd_rn(__fadd_rn(__fmul_rn(og2, S), __fmul_rn(__fmul_rn(two_og, g), vu)),
                  __fmul_rn(g2, uu));
    F = __fadd_rn(__fmul_rn(one_gt, F), __fmul_rn(g, uy));
  }
  a.s_out[0] = from_f32<T>(sc);
  a.s_out[1] = from_f32<T>(maxabs);
  a.s_out[2] = from_f32<T>(step_inf);
  a.s_out[3] = from_f32<T>(S);
  a.s_out[4] = from_f32<T>(F);
  if constexpr (EN) {
    const float atom2 = __fadd_rn(__fadd_rn(__fmul_rn(df, df), __fmul_rn(da, da)),
                                  __fmul_rn(__fmul_rn(__fmul_rn(2.f, df), da), fsame));
    const float cross = __fadd_rn(__fmul_rn(df, a_f), __fmul_rn(da, a_a));
    a.s_out[5] = from_f32<T>(__fadd_rn(__fadd_rn(__fmul_rn(og2, Q),
                                                 __fmul_rn(__fmul_rn(two_og, g), cross)),
                                       __fmul_rn(g2, atom2)));
  }
  *a.stall_out = stall;
  *a.g_out = g;
  a.i_out[0] = use_alt ? i_a : i_f;
  a.i_out[1] = i_a;
  // insert_active(buf, i_f, beta after the step) when the FW atom gained
  // weight: no change when present, else the first weakest-|beta| slot
  const bool took_fw = df != 0.f && g > 0.f;
  bool present = false;
  float wmin = INFINITY;
  int slot = 0;
  for (int s = 0; s < a.n_buf; ++s) {
    const long long b = a.buf[s];
    present |= b == i_f;
    float w = -1.f;
    if (b >= 0) {
      const long long q = b >= p ? p - 1 : b;
      float bn = sh.b0[s];
      if (q == i_a) bn = ba;
      else if (q == i_f) bn = bf;
      else if (renorm) bn = to_f32(from_f32<T>(__fmul_rn(bn, scale_new)));
      w = fabsf(bn);
    }
    // torch.argmin's order: NaN the smallest, then the first of equal ones
    if (s == 0 || (isnan(w) && !isnan(wmin)) || (!isnan(wmin) && w < wmin)) {
      wmin = w;
      slot = s;
    }
  }
  for (int s = 0; s < a.n_buf; ++s)
    a.buf_out[s] = (took_fw && !present && s == slot) ? i_f : a.buf[s];
}

template <typename T, bool SPARSE>
static int launch_dir(DirArgs<T>& a, int blocks, cudaStream_t s) {
  void* args[] = {&a};
  const void* k = a.q_norm != nullptr ? (const void*)dir_tail_kernel<T, SPARSE, true>
                                      : (const void*)dir_tail_kernel<T, SPARSE, false>;
  cudaError_t err = cudaLaunchCooperativeKernel(k, dim3(blocks), dim3(DT_THREADS), args, 0, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it again
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dir_t(const void* X, const int* rows, int nnz_max, void* beta, long long p,
                        const void* scale, const void* maxabs, const int* stall,
                        const void* s_quad, const void* f_lin, const void* q_norm,
                        const void* resid, const void* y, const long long* buf, int n_buf,
                        const float* raw_b, const long long* i_f, const float* sel_f,
                        const float* delta, int m, int pairwise, int refresh, float l2,
                        float renorm_threshold, float eps_den, float gap_rtol, float tol,
                        void* r_out, void* s_out, int* stall_out, long long* buf_out,
                        long long* i_out, float* g_out, float* scratch, cudaStream_t s) {
  if (m < 1 || p < 1 || n_buf < 1 || n_buf > DT_MAX_SLOTS || (rows != nullptr && nnz_max < 1))
    return (int)cudaErrorInvalidValue;
  DirArgs<T> a{static_cast<const T*>(X), rows, nnz_max, static_cast<T*>(beta), p,
               static_cast<const T*>(scale), static_cast<const T*>(maxabs), stall,
               static_cast<const T*>(s_quad), static_cast<const T*>(f_lin),
               static_cast<const T*>(q_norm), static_cast<const T*>(resid),
               static_cast<const T*>(y), buf, n_buf, raw_b, i_f, sel_f, delta, m, pairwise,
               refresh, l2, renorm_threshold, eps_den, gap_rtol, tol, static_cast<T*>(r_out),
               static_cast<T*>(s_out), stall_out, buf_out, i_out, g_out, scratch};
  const int blocks = (m + DT_ROWS - 1) / DT_ROWS;
  return rows != nullptr ? launch_dir<T, true>(a, blocks, s) : launch_dir<T, false>(a, blocks, s);
}

// rows == nullptr: the dense layout (X is Xt (p, m)); otherwise X and rows
// are the block-ELL arrays, nnz_max slots a feature. q_norm == nullptr: the
// lasso's tail; otherwise the elastic-net's, with l2, and s_out holds Q as a
// sixth field. scratch holds 5 floats for each of the ceil(m / DT_ROWS)
// blocks, which must all be resident at once (a cooperative launch).
extern "C" int dir_tail_launch(const void* X, const int* rows, int nnz_max, void* beta,
                               long long p, const void* scale, const void* maxabs,
                               const int* stall, const void* s_quad, const void* f_lin,
                               const void* q_norm, const void* resid, const void* y,
                               const long long* buf, int n_buf, const float* raw_b,
                               const long long* i_f, const float* sel_f, const float* delta,
                               int m, int pairwise, int refresh, float l2,
                               float renorm_threshold, float eps_den, float gap_rtol, float tol,
                               void* r_out, void* s_out, int* stall_out, long long* buf_out,
                               long long* i_out, float* g_out, float* scratch, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_dir_t<float>(X, rows, nnz_max, beta, p, scale, maxabs, stall, s_quad, f_lin,
                               q_norm, resid, y, buf, n_buf, raw_b, i_f, sel_f, delta, m,
                               pairwise, refresh, l2, renorm_threshold, eps_den, gap_rtol, tol,
                               r_out, s_out, stall_out, buf_out, i_out, g_out, scratch, s);
  if (dtype == DT_BF16)
    return launch_dir_t<__nv_bfloat16>(X, rows, nnz_max, beta, p, scale, maxabs, stall, s_quad,
                                       f_lin, q_norm, resid, y, buf, n_buf, raw_b, i_f, sel_f,
                                       delta, m, pairwise, refresh, l2, renorm_threshold,
                                       eps_den, gap_rtol, tol, r_out, s_out, stall_out, buf_out,
                                       i_out, g_out, scratch, s);
  return (int)cudaErrorInvalidValue;
}
