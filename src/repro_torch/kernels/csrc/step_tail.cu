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
#include "common.cuh"

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
};

// Point `a` at lane l's operands.
template <typename T, bool EN>
__device__ __forceinline__ void select_lane(TailArgs<T>& a, int l) {
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
template <typename T, bool SPARSE, bool LANES, bool EN>
__global__ void __launch_bounds__(ST_THREADS) step_tail_kernel(TailArgs<T> a) {
  __shared__ TailShared sh;
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * ST_ROWS, hi = min(a.m, lo + ST_ROWS);
  const int L = LANES ? gridDim.y : 1;  // s_out's field stride
  if constexpr (LANES) {
    const int l = blockIdx.y;
    bool listed = false;
    for (int k = 0; k < a.n_run; ++k) listed |= a.lane_ids[k] == l;
    select_lane<T, EN>(a, l);
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
    sf_recursion(S, F, ls.g_lin, lam, dt, zty, zn2);
    a.s_out[0] = from_f32<T>(sc);
    a.s_out[L] = from_f32<T>(maxabs);
    a.s_out[2 * L] = from_f32<T>(step_inf);
    a.s_out[3 * L] = from_f32<T>(S);
    a.s_out[4 * L] = from_f32<T>(F);
    if constexpr (EN) a.s_out[5 * L] = from_f32<T>(q_recursion(Q, lam, dt, a_star));
    *a.stall_out = stall;
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

template <typename T, bool SPARSE, bool LANES>
static void launch_tail(const TailArgs<T>& a, dim3 grid, cudaStream_t s) {
  if (a.g_sel != nullptr)
    step_tail_kernel<T, SPARSE, LANES, true><<<grid, ST_THREADS, 0, s>>>(a);
  else
    step_tail_kernel<T, SPARSE, LANES, false><<<grid, ST_THREADS, 0, s>>>(a);
}

template <typename T>
static int launch(const void* X, const int* rows, int nnz_max, void* beta, long long p,
                  const void* scale, const void* maxabs, const int* stall, const void* s_quad,
                  const void* f_lin, const void* resid, const void* y, const void* zty,
                  const void* zn2, const long long* i_star, const float* g, const float* delta,
                  int m, float renorm_threshold, float eps_den, float gap_rtol, float tol,
                  void* r_out, void* s_out, int* stall_out, const int* lane_ids, int n_run,
                  int n_lanes, const void* step_inf, const float* g_sel, const void* q_norm,
                  float l2, cudaStream_t s) {
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
                l2};
  if (m < 1) return (int)cudaErrorInvalidValue;
  if (lane_ids == nullptr ? n_lanes != 1
                          : n_lanes < 1 || n_lanes > 65535 || n_run < 0 || n_run > n_lanes ||
                                step_inf == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((g_sel == nullptr) != (q_norm == nullptr)) return (int)cudaErrorInvalidValue;
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
// state's dtype) and l2, and s_out holds 6 fields.
extern "C" int step_tail_launch(const void* X, const int* rows, int nnz_max, void* beta,
                                long long p, const void* scale, const void* maxabs,
                                const int* stall, const void* s_quad, const void* f_lin,
                                const void* resid, const void* y, const void* zty,
                                const void* zn2, const long long* i_star, const float* g,
                                const float* delta, int m, float renorm_threshold,
                                float eps_den, float gap_rtol, float tol, void* r_out,
                                void* s_out, int* stall_out, const int* lane_ids, int n_run,
                                int n_lanes, const void* step_inf, int dtype, const float* g_sel,
                                const void* q_norm, float l2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(X, rows, nnz_max, beta, p, scale, maxabs, stall, s_quad, f_lin, resid,
                         y, zty, zn2, i_star, g, delta, m, renorm_threshold, eps_den, gap_rtol,
                         tol, r_out, s_out, stall_out, lane_ids, n_run, n_lanes, step_inf, g_sel,
                         q_norm, l2, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(X, rows, nnz_max, beta, p, scale, maxabs, stall, s_quad, f_lin,
                                 resid, y, zty, zn2, i_star, g, delta, m, renorm_threshold,
                                 eps_den, gap_rtol, tol, r_out, s_out, stall_out, lane_ids, n_run,
                                 n_lanes, step_inf, g_sel, q_norm, l2, s);
  return (int)cudaErrorInvalidValue;
}
