// K4 and K7: K fused FW iterations per launch, on the dense layout (K4,
// replaces the Pallas kernel at src/repro/kernels/fused_step/fused_step.py:259
// through its entry dense_fused_chunk at :310) and on the block-ELL layout
// (K7, the same kernel through sparse_fused_chunk at :376), one cooperative
// grid skeleton for both; and the replay of their step records into the
// O(p) coefficient state (replaces the XLA fori_loop of
// src/repro/core/engine.py:387, _fused_replay). See kernels/fused_step.py
// for the bounds and the design.
//
// Scalar algebra: every op is a separate _rn intrinsic in the op order of
// core/fw_lasso.py (ls_closed_form, sf_recursion) and core/engine.py
// (apply_coeff_update), so nvcc cannot contract into FMAs. The dense scores
// go through warp_row_score, K2's per-row dot, and its residual update is
// K3's op sequence; the sparse scores go through warp_slot_score, K5's
// slot dot.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int FC_THREADS = 512;
constexpr int FC_WARPS = FC_THREADS / 32;
constexpr int REC = 8;  // record row: lam, delta_t, raw, sel, stall flag, 0, 0, 0

struct __align__(16) Partial {
  float mag;
  float raw;
  long long j;
};

// Another block's partial, read from L2 (ld.global.cg): this block's L1
// may still hold the slot's value from two steps before.
__device__ __forceinline__ Partial load_partial(const Partial* q) {
  union {
    float4 v;
    Partial q;
  } u;
  u.v = __ldcg(reinterpret_cast<const float4*>(q));
  return u.q;
}

// torch's NaN rules: maximum/clamp propagate NaN, sign(NaN) = 0
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.f), 1.f);
}
__device__ __forceinline__ float sign_of(float g) {
  return (float)((0.f < g) - (g < 0.f));
}

// Block-wide first max of each thread's (mag, j, raw); thread 0 ends with
// the winner. Every block that holds the same candidates gets the same
// winner: `better` is a total order on (mag, j).
__device__ __forceinline__ void block_best(float& mag, long long& j, float& raw, float* smag,
                                           long long* sj, float* sraw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(mag, j, raw);
  if (lane == 0) {
    smag[warp] = mag;
    sj[warp] = j;
    sraw[warp] = raw;
  }
  __syncthreads();
  if (warp == 0) {
    mag = lane < FC_WARPS ? smag[lane] : -INFINITY;
    j = lane < FC_WARPS ? sj[lane] : LLONG_MAX;
    raw = lane < FC_WARPS ? sraw[lane] : 0.f;
    warp_best(mag, j, raw);
  }
  __syncthreads();  // smag/sj/sraw free again
}

// The two layouts the chunk runs on. Each gives the per-row score of a
// sampled coordinate against the block's residual copy (one warp) and the
// eq. 10 update of that copy by the step's winner (the whole block).

// Dense Xt (p, m) (K4): K2's row dot; K3's op order for eq. 10; y staged
// in shared memory beside the residual.
struct DenseRows {
  static constexpr bool kStageY = true;
  const float* X;
  long long p;
  int m;
  int vec;

  __device__ __forceinline__ float score(long long row, const float* rs, int lane) const {
    return warp_row_score<float>(X, row, p, m, rs, vec, lane);
  }
  __device__ __forceinline__ void update(float* rs, const float* yv, long long i, float lam,
                                         float dt) const {
    const float one_m = __fsub_rn(1.f, lam);
    const float* z = X + i * (long long)m;
    for (int k = threadIdx.x; k < m; k += FC_THREADS) {
      const float a = __fmul_rn(one_m, rs[k]);
      const float b = __fmul_rn(lam, __fsub_rn(yv[k], __fmul_rn(dt, z[k])));
      rs[k] = __fadd_rn(a, b);
    }
  }
};

// Block-ELL slots (K7): K5's slot dot; the op order of
// sparse.ops.sparse_residual_update, out = (1 - lam) r + lam y over m and
// then out[rows] += (-lam * dt) * vals over the winner's slots. A
// feature's real rows are distinct, so the slots' adds are independent;
// a padded slot (value 0) adds nothing and is skipped, so the shared
// row 0 of the padding sees no race. y is read through L2, which leaves
// shared memory to the residual alone (m <= 57,344).
struct SparseSlots {
  static constexpr bool kStageY = false;
  const float* values;
  const int* rows;
  long long n_feat;  // padded features in the arrays
  int m;
  int nnz_max;

  __device__ __forceinline__ float score(long long f, const float* rs, int lane) const {
    return warp_slot_score<float>(values, rows, f, n_feat, nnz_max, rs, lane);
  }
  __device__ __forceinline__ void update(float* rs, const float* yv, long long i, float lam,
                                         float dt) const {
    const float one_m = __fsub_rn(1.f, lam);
    for (int k = threadIdx.x; k < m; k += FC_THREADS)
      rs[k] = __fadd_rn(__fmul_rn(one_m, rs[k]), __fmul_rn(lam, __ldg(yv + k)));
    __syncthreads();
    const float c = __fmul_rn(-lam, dt);
    const long long base = i * nnz_max;
    for (int k = threadIdx.x; k < nnz_max; k += FC_THREADS) {
      const float v = values[base + k];
      if (v != 0.f) atomicAdd(rs + rows[base + k], __fmul_rn(c, v));
    }
  }
};

// One persistent cooperative grid runs the K steps, the same skeleton for
// both layouts. Per step: every warp scores its share of the kappa sampled
// coordinates against its block's copy of the residual; each block writes
// its first max to partials[s % 2]; one grid sync; every block reduces all
// partials in the same order, computes the line search and the S/F
// recursions redundantly (identical scalars everywhere), and updates its
// own shared-memory residual with the winner (Layout::update). Block 0
// writes the records, the final residual and (S, F, Q).
template <class Layout>
__global__ void __launch_bounds__(FC_THREADS, 2)
fused_chunk_kernel(Layout L, const float* __restrict__ y, const float* __restrict__ r0,
                   const float* __restrict__ s0, const float* __restrict__ f0,
                   const float* __restrict__ q0, const float* __restrict__ delta_p,
                   const long long* __restrict__ idx, const float* __restrict__ zty_s,
                   const float* __restrict__ zn2_s, int m, int K, long long kappa, long long k0,
                   long long max_iters, int refresh_every, float eps_den, float gap_rtol,
                   long long* __restrict__ i_star_out, float* __restrict__ recs,
                   unsigned char* __restrict__ no_prog_out, float* __restrict__ r_out,
                   float* __restrict__ s_out, Partial* __restrict__ partials) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                   // this block's live residual (m)
  float* ys = smem + ((m + 3) & ~3);  // y (m), when the layout stages it
  const float* yv = Layout::kStageY ? ys : y;
  __shared__ float smag[FC_WARPS], sraw[FC_WARPS], sv[2][FC_WARPS];
  __shared__ long long sj[FC_WARPS];
  __shared__ float sh_lam, sh_dt;
  __shared__ long long sh_i;
  __shared__ int sh_active, sh_refresh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < m; i += FC_THREADS) {
    rs[i] = r0[i];
    if (Layout::kStageY) ys[i] = y[i];
  }
  // the scalar state lives in thread 0 of every block
  float S = *s0, F = *f0;
  const float delta = *delta_p;
  __syncthreads();

  const long long gwarp = (long long)blockIdx.x * FC_WARPS + warp;
  const long long nwarps = (long long)gridDim.x * FC_WARPS;
  for (int s = 0; s < K; ++s) {
    const long long* ids = idx + (long long)s * kappa;
    // ---- score this block's share of the sampled rows, first max --------
    float mag = -INFINITY, raw = 0.f;
    long long j = LLONG_MAX;
    for (long long c = gwarp; c < kappa; c += nwarps) {
      const float sc = L.score(ids[c], rs, lane);
      if (better(fabsf(sc), c, mag, j)) {
        mag = fabsf(sc);
        j = c;
        raw = sc;
      }
    }
    block_best(mag, j, raw, smag, sj, sraw);
    Partial* part = partials + (s & 1) * gridDim.x;
    if (tid == 0) part[blockIdx.x] = Partial{mag, raw, j};
    grid.sync();

    // ---- every block: the step's winner, then the scalar algebra ---------
    mag = -INFINITY;
    raw = 0.f;
    j = LLONG_MAX;
    for (int b = tid; b < (int)gridDim.x; b += FC_THREADS) {
      const Partial q = load_partial(part + b);
      if (better(q.mag, q.j, mag, j)) {
        mag = q.mag;
        j = q.j;
        raw = q.raw;
      }
    }
    block_best(mag, j, raw, smag, sj, sraw);
    if (tid == 0) {
      const long long flat = (long long)s * kappa + j;
      const long long i_star = ids[j];
      const float zty = zty_s[flat], zn2 = zn2_s[flat];
      const float g = raw;  // lasso: the selected score is the linear one
      const float dt = __fmul_rn(-delta, sign_of(g));
      const float g_lin = __fadd_rn(g, zty);
      // ls_closed_form (eq. 8)
      const float dtg = __fmul_rn(dt, g);
      const float num = __fsub_rn(__fsub_rn(S, dtg), F);
      const float den = __fadd_rn(__fsub_rn(S, __fmul_rn(__fmul_rn(2.f, dt), g_lin)),
                                  __fmul_rn(__fmul_rn(dt, dt), zn2));
      const float lam = clamp01(__fdiv_rn(num, clamp_min_nan(den, eps_den)));
      const float gap_scale = __fadd_rn(__fadd_rn(S, fabsf(F)), fabsf(dtg));
      const bool no_prog = num <= __fmul_rn(gap_rtol, gap_scale);
      const long long kg = k0 + s;
      const bool active = kg < max_iters;
      if (active) {
        // sf_recursion
        const float one_m = __fsub_rn(1.f, lam);
        const float a = __fmul_rn(__fmul_rn(one_m, one_m), S);
        const float b =
            __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, dt), lam), one_m), g_lin);
        const float c = __fmul_rn(__fmul_rn(__fmul_rn(dt, dt), __fmul_rn(lam, lam)), zn2);
        S = __fadd_rn(__fadd_rn(a, b), c);
        F = __fadd_rn(__fmul_rn(one_m, F), __fmul_rn(__fmul_rn(dt, lam), zty));
      }
      sh_lam = lam;
      sh_dt = dt;
      sh_i = i_star;
      sh_active = active;
      sh_refresh = active && (kg % refresh_every) == (refresh_every - 1);
      if (blockIdx.x == 0) {
        float* rec = recs + (long long)s * REC;
        rec[0] = lam;
        rec[1] = dt;
        rec[2] = g;
        rec[3] = g;
        rec[4] = no_prog ? 1.f : 0.f;
        rec[5] = rec[6] = rec[7] = 0.f;
        i_star_out[s] = i_star;
        no_prog_out[s] = no_prog;
      }
    }
    __syncthreads();

    // ---- eq. 10 on this block's residual + the refresh --------------------
    if (sh_active) {
      L.update(rs, yv, sh_i, sh_lam, sh_dt);
      __syncthreads();
      if (sh_refresh) {  // exact S = ||v||^2, F = v.y with v = y - R, fixed order
        float vv = 0.f, vy = 0.f;
        for (int i = tid; i < m; i += FC_THREADS) {
          const float yi = yv[i];
          const float v = __fsub_rn(yi, rs[i]);
          vv = fmaf(v, v, vv);
          vy = fmaf(v, yi, vy);
        }
        vv = warp_sum(vv);
        vy = warp_sum(vy);
        if (lane == 0) {
          sv[0][warp] = vv;
          sv[1][warp] = vy;
        }
        __syncthreads();
        if (tid == 0) {
          S = 0.f;
          F = 0.f;
          for (int w = 0; w < FC_WARPS; ++w) {
            S = __fadd_rn(S, sv[0][w]);
            F = __fadd_rn(F, sv[1][w]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (blockIdx.x == 0) {
    for (int i = tid; i < m; i += FC_THREADS) r_out[i] = rs[i];
    if (tid == 0) {
      s_out[0] = S;
      s_out[1] = F;
      s_out[2] = *q0;
    }
  }
}

// One block walks the K records in order with apply_coeff_update's op
// sequence; beta is multiplied (by the whole block) only on a renorm.
__global__ void fused_replay_kernel(float* __restrict__ beta, long long p,
                                    const float* __restrict__ scale_in,
                                    const float* __restrict__ maxabs_in,
                                    const float* __restrict__ step_inf_in,
                                    const int* __restrict__ stall_in,
                                    const long long* __restrict__ i_star,
                                    const float* __restrict__ lam, long long lam_stride,
                                    const float* __restrict__ dt, long long dt_stride,
                                    const unsigned char* __restrict__ no_prog, int K,
                                    long long k0, long long max_iters, float renorm_threshold,
                                    float eps_den, float tol, float* __restrict__ f_out,
                                    int* __restrict__ stall_out) {
  __shared__ float sh_new_scale;
  __shared__ int sh_renorm;
  float scale = *scale_in, maxabs = *maxabs_in, step_inf = *step_inf_in;
  int stall = *stall_in;
  float lam_t = 0.f, dt_t = 0.f, a_star = 0.f, one_m = 0.f, new_scale = 0.f;
  long long i = 0;
  for (int t = 0; t < K && k0 + t < max_iters; ++t) {
    if (threadIdx.x == 0) {
      i = i_star[t];
      lam_t = lam[t * lam_stride];
      dt_t = dt[t * dt_stride];
      a_star = __fmul_rn(scale, beta[i]);
      one_m = __fsub_rn(1.f, lam_t);
      new_scale = __fmul_rn(scale, one_m);
      sh_new_scale = new_scale;
      sh_renorm = new_scale < renorm_threshold;
    }
    __syncthreads();
    if (sh_renorm) {
      const float f = sh_new_scale;
      for (long long q = threadIdx.x; q < p; q += blockDim.x) beta[q] = __fmul_rn(beta[q], f);
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      scale = sh_renorm ? 1.f : new_scale;
      const float coef = __fdiv_rn(__fmul_rn(dt_t, lam_t), clamp_min_nan(scale, eps_den));
      const float bi = __fadd_rn(beta[i], coef);
      beta[i] = bi;
      const float alpha_new = __fmul_rn(scale, bi);
      step_inf = __fmul_rn(lam_t, nan_max(maxabs, fabsf(__fsub_rn(dt_t, a_star))));
      maxabs = nan_max(__fmul_rn(one_m, maxabs), fabsf(alpha_new));
      stall = (step_inf <= tol || no_prog[t]) ? stall + 1 : 0;
    }
    __syncthreads();  // sh_* are rewritten by the next record
  }
  if (threadIdx.x == 0) {
    f_out[0] = scale;
    f_out[1] = maxabs;
    f_out[2] = step_inf;
    *stall_out = stall;
  }
}

// Dynamic shared memory of a block: the residual, and y beside it when the
// layout stages y.
template <class Layout>
static size_t chunk_smem_bytes(int m) {
  return (size_t)(((m + 3) & ~3) + (Layout::kStageY ? m : 0)) * sizeof(float);
}

// The cooperative grid for a layout and m on the current device: every
// SM's worth of resident blocks, as the occupancy calculator allows
// (resident_grid, which also raises the shared-memory limit on the device).
template <class Layout>
static int chunk_blocks(int m, int* blocks) {
  static GridCache cache;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = resident_grid(fused_chunk_kernel<Layout>, FC_THREADS, chunk_smem_bytes<Layout>(m),
                        LLONG_MAX, &cache, blocks);
  return (int)err;
}

template <class Layout>
static int chunk_launch(Layout L, const float* y, const float* r0, const float* s0,
                        const float* f0, const float* q0, const float* delta,
                        const long long* idx, const float* zty_s, const float* zn2_s, int m,
                        int K, long long kappa, long long k0, long long max_iters,
                        int refresh_every, float eps_den, float gap_rtol, long long* i_star,
                        float* recs, unsigned char* no_prog, float* r_out, float* s_out,
                        void* partials, int blocks, void* stream) {
  Partial* part = static_cast<Partial*>(partials);
  void* args[] = {&L,         &y,      &r0,        &s0,      &f0,       &q0,
                  &delta,     &idx,    &zty_s,     &zn2_s,   &m,        &K,
                  &kappa,     &k0,     &max_iters, &refresh_every, &eps_den, &gap_rtol,
                  &i_star,    &recs,   &no_prog,   &r_out,   &s_out,    &part};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)fused_chunk_kernel<Layout>, dim3(blocks), dim3(FC_THREADS), args,
      chunk_smem_bytes<Layout>(m), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it again
    return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int dense_fused_chunk_blocks(int m, int* blocks) {
  return chunk_blocks<DenseRows>(m, blocks);
}

extern "C" int sparse_fused_chunk_blocks(int m, int* blocks) {
  return chunk_blocks<SparseSlots>(m, blocks);
}

extern "C" int dense_fused_chunk_launch(const float* X, long long p, const float* y,
                                        const float* r0, const float* s0, const float* f0,
                                        const float* q0, const float* delta,
                                        const long long* idx, const float* zty_s,
                                        const float* zn2_s, int m, int K, long long kappa,
                                        long long k0,
                                        long long max_iters, int refresh_every, float eps_den,
                                        float gap_rtol, long long* i_star, float* recs,
                                        unsigned char* no_prog, float* r_out, float* s_out,
                                        void* partials, int blocks, void* stream) {
  const DenseRows L{X, p, m, rows_vectorizable<float>(X, m)};
  return chunk_launch(L, y, r0, s0, f0, q0, delta, idx, zty_s, zn2_s, m, K, kappa, k0,
                      max_iters, refresh_every, eps_den, gap_rtol, i_star, recs, no_prog,
                      r_out, s_out, partials, blocks, stream);
}

extern "C" int sparse_fused_chunk_launch(const float* values, const int* rows,
                                         long long n_feat, int nnz_max, const float* y,
                                         const float* r0, const float* s0, const float* f0,
                                         const float* q0, const float* delta,
                                         const long long* idx, const float* zty_s,
                                         const float* zn2_s, int m, int K, long long kappa,
                                         long long k0,
                                         long long max_iters, int refresh_every, float eps_den,
                                         float gap_rtol, long long* i_star, float* recs,
                                         unsigned char* no_prog, float* r_out, float* s_out,
                                         void* partials, int blocks, void* stream) {
  const SparseSlots L{values, rows, n_feat, m, nnz_max};
  return chunk_launch(L, y, r0, s0, f0, q0, delta, idx, zty_s, zn2_s, m, K, kappa, k0,
                      max_iters, refresh_every, eps_den, gap_rtol, i_star, recs, no_prog,
                      r_out, s_out, partials, blocks, stream);
}

extern "C" int fused_replay_launch(float* beta, long long p, const float* scale,
                                   const float* maxabs, const float* step_inf, const int* stall,
                                   const long long* i_star, const float* lam,
                                   long long lam_stride, const float* dt, long long dt_stride,
                                   const unsigned char* no_prog, int K, long long k0,
                                   long long max_iters, float renorm_threshold, float eps_den,
                                   float tol, float* f_out, int* stall_out, void* stream) {
  fused_replay_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      beta, p, scale, maxabs, step_inf, stall, i_star, lam, lam_stride, dt, dt_stride,
      no_prog, K, k0, max_iters, renorm_threshold, eps_den, tol, f_out, stall_out);
  return (int)cudaGetLastError();
}
