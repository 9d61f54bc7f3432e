// Shared device helpers for the port's Hopper kernels.
//
// Every kernel takes its element type as a template (f32 or bf16 inputs,
// f32 accumulation, as in the Pallas kernels) and is launched through a
// plain C entry point that returns cudaGetLastError(), so the ctypes
// wrapper in kernels/*.py can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

// dtype codes shared with kernels/_build.py (DTYPE_CODES)
enum { DT_F32 = 0, DT_BF16 = 1 };

// A vector that fits in this many bytes is staged in shared memory; above
// it the kernels read it through L1/L2 (no opt-in attribute is needed up
// to 48 KB of dynamic shared memory).
#define STAGE_LIMIT_BYTES (48 * 1024)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One 16-byte load of T, unpacked to floats: 4 f32 or 8 bf16.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy an f32 vector into shared memory (whole block takes part).
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int m) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// One warp's partial sums over a contiguous row x[0:m] against the f32
// vector v: dot += x.v and, when SQ, sq += x.x. Lanes stride the row so the
// warp's loads are coalesced. VEC: 16-byte loads of x and float4 reads of v
// (needs x 16-byte aligned, m a multiple of Vec16<T>::N, v in shared memory).
template <typename T, bool SQ>
__device__ __forceinline__ void row_dot(const T* __restrict__ x, const float* __restrict__ v,
                                        int m, bool vec, int lane, float& dot, float& sq) {
  if (vec) {
    constexpr int N = Vec16<T>::N;
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const int nv = m / N;
    for (int c = lane; c < nv; c += 32) {
      float xs[N];
      Vec16<T>::load(x + (size_t)c * N, xs);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 w = v4[c * (N / 4) + q];
        dot = fmaf(xs[4 * q + 0], w.x, dot);
        dot = fmaf(xs[4 * q + 1], w.y, dot);
        dot = fmaf(xs[4 * q + 2], w.z, dot);
        dot = fmaf(xs[4 * q + 3], w.w, dot);
        if (SQ) {
          sq = fmaf(xs[4 * q + 0], xs[4 * q + 0], sq);
          sq = fmaf(xs[4 * q + 1], xs[4 * q + 1], sq);
          sq = fmaf(xs[4 * q + 2], xs[4 * q + 2], sq);
          sq = fmaf(xs[4 * q + 3], xs[4 * q + 3], sq);
        }
      }
    }
  } else {
    for (int i = lane; i < m; i += 32) {
      const float xi = to_f32(x[i]);
      dot = fmaf(xi, v[i], dot);
      if (SQ) sq = fmaf(xi, xi, sq);
    }
  }
}

// The sampled score -x.v of row `row` of X (p, m), summed by one warp in
// row_dot's order and returned to every lane. A row outside [0, p) scores
// exactly 0 (-0.0f, as the reference's zero-padded rows do) without
// touching memory. K2 and the fused chunk (K4) both score through this, so
// they round alike.
template <typename T>
__device__ __forceinline__ float warp_row_score(const T* __restrict__ X, long long row,
                                                long long p, int m,
                                                const float* __restrict__ v, bool vec,
                                                int lane) {
  float dot = 0.f, unused = 0.f;
  if (row >= 0 && row < p) row_dot<T, false>(X + row * m, v, m, vec, lane, dot, unused);
  return -warp_sum(dot);
}

// The block-ELL layout (sparse/matrix.py) keeps feature f's nonzeros in the
// nnz_max contiguous slots values[f * nnz_max + k], rows[f * nnz_max + k];
// a padded slot holds value 0 at row 0. One warp's partial sums over those
// slots against the f32 vector v: dot += x * v[row] and, when SQ,
// sq += x * x. Lanes stride the slots, so the warp reads them coalesced;
// the gather of v is random (v is meant to lie in shared memory).
template <typename T, bool SQ>
__device__ __forceinline__ void slot_dot(const T* __restrict__ values,
                                         const int* __restrict__ rows, long long f,
                                         int nnz_max, const float* __restrict__ v, int lane,
                                         float& dot, float& sq) {
  const long long base = f * nnz_max;
  for (int k = lane; k < nnz_max; k += 32) {
    const float x = to_f32(values[base + k]);
    dot = fmaf(x, v[rows[base + k]], dot);
    if (SQ) sq = fmaf(x, x, sq);
  }
}

// The sampled score -z_f . v of feature f in the block-ELL layout, summed
// by one warp in slot_dot's order and returned to every lane. A feature
// outside [0, n_feat) scores exactly 0 (-0.0f) without touching memory.
// K5 and the sparse fused chunk (K7) both score through this, so they
// round alike.
template <typename T>
__device__ __forceinline__ float warp_slot_score(const T* __restrict__ values,
                                                 const int* __restrict__ rows, long long f,
                                                 long long n_feat, int nnz_max,
                                                 const float* __restrict__ v, int lane) {
  float dot = 0.f, unused = 0.f;
  if (f >= 0 && f < n_feat) slot_dot<T, false>(values, rows, f, nnz_max, v, lane, dot, unused);
  return -warp_sum(dot);
}

// ---- the lasso step's scalar algebra ---------------------------------------
//
// One copy for every kernel that runs it: the fused chunks' end of a step
// (end_step), the fused replay and the unfused step's tail (step_tail.cu).
// Every op is a separate _rn intrinsic in the op order of
// kernels/step_tail.py (ls_closed_form, sf_recursion, apply_coeff_update),
// so nvcc cannot contract into FMAs and the bits are the eager ops'.

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

// Eq. 6's vertex sign and the closed-form line search (eq. 8) of a step
// whose selected score is g (the lasso's is its linear score).
struct LineSearch {
  float dt;     // delta_t = -delta * sign(g)
  float g_lin;  // g + z.y
  float lam;
  bool no_prog;    // num <= gap_rtol * gap_scale
  float num;       // the sampled duality gap
  float gap_scale; // the magnitude of its terms
};

__device__ __forceinline__ LineSearch lasso_line_search(float g, float delta, float S, float F,
                                                        float zty, float zn2, float eps_den,
                                                        float gap_rtol) {
  LineSearch o;
  o.dt = __fmul_rn(-delta, sign_of(g));
  o.g_lin = __fadd_rn(g, zty);
  const float dtg = __fmul_rn(o.dt, g);
  const float num = __fsub_rn(__fsub_rn(S, dtg), F);
  const float den = __fadd_rn(__fsub_rn(S, __fmul_rn(__fmul_rn(2.f, o.dt), o.g_lin)),
                              __fmul_rn(__fmul_rn(o.dt, o.dt), zn2));
  o.lam = clamp01(__fdiv_rn(num, clamp_min_nan(den, eps_den)));
  const float gap_scale = __fadd_rn(__fadd_rn(S, fabsf(F)), fabsf(dtg));
  o.no_prog = num <= __fmul_rn(gap_rtol, gap_scale);
  o.num = num;
  o.gap_scale = gap_scale;
  return o;
}

// The S/F scalar recursions (sf_recursion), in place.
__device__ __forceinline__ void sf_recursion(float& S, float& F, float g_lin, float lam, float dt,
                                             float zty, float zn2) {
  const float one_m = __fsub_rn(1.f, lam);
  const float sa = __fmul_rn(__fmul_rn(one_m, one_m), S);
  const float sb = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, dt), lam), one_m), g_lin);
  const float sc = __fmul_rn(__fmul_rn(__fmul_rn(dt, dt), __fmul_rn(lam, lam)), zn2);
  S = __fadd_rn(__fadd_rn(sa, sb), sc);
  F = __fadd_rn(__fmul_rn(one_m, F), __fmul_rn(__fmul_rn(dt, lam), zty));
}

// ---- the elastic-net's scalar algebra ---------------------------------------
//
// The op order of kernels/step_tail.py's en_ls_closed_form and q_recursion
// (the reference's core/fw_elasticnet.py:45-74), for the unfused tail's EN
// instantiation and the fused chunks' (end_step with the alpha ledger).

// Eq. 6's sign from the shifted score g_sel and the elastic-net's
// closed-form line search of a step whose winner has linear score g_raw and
// alpha value a; Q = ||alpha||^2.
__device__ __forceinline__ LineSearch en_line_search(float g_raw, float g_sel, float a,
                                                     float delta, float S, float F, float Q,
                                                     float zty, float zn2, float l2,
                                                     float eps_den, float gap_rtol) {
  LineSearch o;
  o.dt = __fmul_rn(-delta, sign_of(g_sel));
  o.g_lin = __fadd_rn(g_raw, zty);
  const float dtg = __fmul_rn(o.dt, g_raw);
  const float dta = __fmul_rn(o.dt, a);
  const float num = __fadd_rn(__fsub_rn(__fsub_rn(S, dtg), F), __fmul_rn(l2, __fsub_rn(Q, dta)));
  const float two_dt = __fmul_rn(2.f, o.dt);
  const float dt2 = __fmul_rn(o.dt, o.dt);
  const float den_x = __fadd_rn(__fsub_rn(S, __fmul_rn(two_dt, o.g_lin)), __fmul_rn(dt2, zn2));
  const float den_q = __fadd_rn(__fsub_rn(Q, __fmul_rn(two_dt, a)), dt2);
  const float den = __fadd_rn(den_x, __fmul_rn(l2, den_q));
  o.lam = clamp01(__fdiv_rn(num, clamp_min_nan(den, eps_den)));
  const float gap_scale = __fadd_rn(__fadd_rn(__fadd_rn(S, fabsf(F)), fabsf(dtg)),
                                    __fmul_rn(l2, __fadd_rn(Q, fabsf(dta))));
  o.no_prog = num <= __fmul_rn(gap_rtol, gap_scale);
  o.num = num;
  o.gap_scale = gap_scale;
  return o;
}

// The Q = ||alpha||^2 recursion: (1-lam)^2 Q + 2 lam (1-lam) dt a + lam^2 dt^2.
__device__ __forceinline__ float q_recursion(float Q, float lam, float dt, float a) {
  const float one_m = __fsub_rn(1.f, lam);
  const float qa = __fmul_rn(__fmul_rn(one_m, one_m), Q);
  const float qb = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, lam), one_m), dt), a);
  const float qc = __fmul_rn(__fmul_rn(lam, lam), __fmul_rn(dt, dt));
  return __fadd_rn(__fadd_rn(qa, qb), qc);
}

// apply_coeff_update's increment of beta[i_star]: delta_t * lam / scale,
// the scale after any renorm.
__device__ __forceinline__ float coeff_increment(float dt, float lam, float scale, float eps_den) {
  return __fdiv_rn(__fmul_rn(dt, lam), clamp_min_nan(scale, eps_den));
}

// apply_coeff_update's stopping statistics, in place: the
// ||alpha^{k+1} - alpha^k||_inf bound, the running max |alpha| and the
// stall count, from the step's a_star = scale * beta[i_star] before it
// and alpha_new = scale * beta[i_star] after it.
__device__ __forceinline__ void stop_stats(float lam, float one_m, float dt, float a_star,
                                           float alpha_new, bool no_prog, float tol,
                                           float& maxabs, float& step_inf, int& stall) {
  step_inf = __fmul_rn(lam, nan_max(maxabs, fabsf(__fsub_rn(dt, a_star))));
  maxabs = nan_max(__fmul_rn(one_m, maxabs), fabsf(alpha_new));
  stall = (step_inf <= tol || no_prog) ? stall + 1 : 0;
}

// The most dynamic shared memory a block may opt in to on Hopper (227 KB),
// less a margin for the kernels' static shared memory.
#define OPTIN_SMEM_BYTES (224 * 1024)

// resident_grid's answers for one kernel, one entry per device: the
// shared-memory limit is a per-device attribute, so a device must set it
// before its own first launch. A device past the table is asked every time.
#define GRID_CACHE_DEVICES 64
struct GridCache {
  size_t smem_plus1[GRID_CACHE_DEVICES];  // 0: not asked yet
  int blocks[GRID_CACHE_DEVICES];
};

// A persistent grid for `kernel` on the current device: as many blocks of
// `threads` with `smem` bytes of dynamic shared memory as can be resident
// at once (each stages a vector once and then strides over the work), and
// no more than `needed`. Raises the kernel's dynamic shared memory limit to
// OPTIN_SMEM_BYTES first (a limit set to one call's need would refuse a
// later, larger one). The answer is cached per device for the last smem.
template <typename K>
inline cudaError_t resident_grid(K kernel, int threads, size_t smem, long long needed,
                                 GridCache* cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < GRID_CACHE_DEVICES;
  if (!cached || cache->smem_plus1[dev] != smem + 1) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 OPTIN_SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return err;
    if (!cached) {
      *blocks = (int)(needed < sms * per_sm ? needed : sms * per_sm);
      return cudaSuccess;
    }
    cache->smem_plus1[dev] = smem + 1;
    cache->blocks[dev] = sms * per_sm;
  }
  *blocks = (int)(needed < cache->blocks[dev] ? needed : cache->blocks[dev]);
  return cudaSuccess;
}

// jnp.argmax / torch.argmax order: NaN counts as the largest value, and of
// equal values the first in sample order wins.
__device__ __forceinline__ bool better(float a, long long ja, float b, long long jb) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ja < jb);
  return a > b || (a == b && ja < jb);
}

// Warp-wide first max of (best, bj) under `better`; every lane ends with
// the winner and its payload `val`.
__device__ __forceinline__ void warp_best(float& best, long long& bj, float& val) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const long long oj = __shfl_xor_sync(0xffffffffu, bj, o);
    const float ov = __shfl_xor_sync(0xffffffffu, val, o);
    if (better(ob, oj, best, bj)) {
      best = ob;
      bj = oj;
      val = ov;
    }
  }
}

// ---- Hopper's asynchronous copies into shared memory --------------------
//
// A 1-D bulk copy (TMA without a tensor map) moves `bytes` (a multiple of
// 16, both addresses 16-byte aligned) from global to shared memory and
// reports them to an mbarrier; one thread starts it after announcing the
// bytes with mbar_expect_tx, and every thread that reads the tile waits on
// the barrier's phase. cp_async16 is the per-thread 16-byte copy of sm_80;
// with fetch false it reads nothing and fills the 16 bytes with zeros.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the copy engine and the other
// threads (a __syncthreads() must follow before any thread uses them).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 16-byte copy of the first `bytes` (0-16) of src, the rest of the
// 16 bytes zero-filled.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fetch) {
  cp_async16_n(dst, src, fetch ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's cp_async16 groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- a warp's ring of block-ELL features (K5 and K7) -----------------------
//
// One block of 1024 threads an SM; each warp scores its own sequence of
// features, two at a time, against the block's shared-memory residual rs:
// half h of the warp (lanes 16 h .. 16 h + 15) scores feature 2 pi + h of
// pair pi. A feature comes in pieces of `slots` (nnz_max up to 124, or a
// multiple of 32: kernels/sparse_grad.py's ring_plan); the pairs' pieces
// stream through the warp's ring of RING_DEPTH stages, a pair's piece a
// tick:
//
//  - ids: lane l holds the id of feature 32 w + l of the warp's sequence
//    (Ids(f): the sequence's feature f) for the window w of the pair
//    fetched next and the window after it (one load a lane per 32
//    features, handed out by shuffles);
//  - tick u reads stage u % D and then starts the row slots of tick
//    u + D/2's pieces (whose values have landed) and the value slots of
//    tick u + D's into the stage just read, one cp.async group a tick, so
//    waiting until at most D/2 - 1 groups pend brings both;
//  - a stage holds, for each half, the 16-byte chunks that cover its
//    piece (a feature's slots start at 4 * nnz_max * f bytes, 16-byte
//    aligned only for some f): lane q of the half copies value chunks q
//    and q + 16 and, beside them, the same row chunks, but only where one
//    of the chunk's 4 values is nonzero (sign bit ignored): a zero-filled
//    row chunk makes a padded slot or a stored zero gather rs[0] * 0, an
//    exact 0 for a finite residual, as the plain dot's rs[row] * 0 does.
//    Lane q = 0 writes the piece's place and slots (0 for an id outside
//    [0, n_feat), which scores -0 without a read) to its Meta;
//  - lane q sums slot_dot's lane-q and lane-(q + 16) partials (slots
//    q + 32 t and q + 16 + 32 t, in order, across the pieces), adds them
//    and finishes warp_sum's butterfly in the half (xor 8, 4, 2, 1): the
//    same additions of the same operands as warp_slot_score, so the same
//    bits.
//
// The sequence is K rounds of n features (K7: a step's run of positions;
// K5: one round), and the stream runs on across the rounds.
constexpr int RING_DEPTH = 4;
constexpr int RING_WARPS = 32;  // the ring kernels' blocks: 1024 threads

struct Meta {
  long long at;  // the first chunk's first float in the arrays
  int sh;        // where the piece starts in its first chunk (0-3)
  int cnt;       // the piece's slots; 0: nothing to read
};

// Dynamic shared memory of a ring kernel: the residual (m floats, rounded
// up to 16 bytes), then each warp's RING_DEPTH stages of two pieces'
// `stride` value and `stride` row slots, then their Metas
// (kernels/sparse_grad.py's RingPlan.smem_bytes).
inline size_t ring_smem_bytes(int m, int stride) {
  return ((size_t)((m + 3) & ~3) + (size_t)RING_WARPS * RING_DEPTH * 4 * stride) * sizeof(float) +
         (size_t)RING_WARPS * RING_DEPTH * 2 * sizeof(Meta);
}

// Whether a ring of `slots`-slot pieces a `stride` apart serves nnz_max
// (kernels/sparse_grad.py's ring_plan makes such plans).
inline bool ring_plan_ok(int nnz_max, int slots, int stride) {
  return nnz_max >= 1 && (slots == nnz_max ? slots <= 124 : slots % 32 == 0 && slots < nnz_max) &&
         slots <= 128 && stride % 4 == 0 && stride >= slots + 3;
}

// The ring of one warp. Ids: the sequence's feature ids, `long long
// operator()(int f)` for f < K * n. NT: slots a lane of a half reads a
// piece, ceil(slots / 32).
template <int NT, class Ids>
struct SlotRing {
  static constexpr int D = RING_DEPTH, HALF = D / 2;
  const float* values;
  const int* rows;
  long long n_feat;  // features in the arrays
  long long total;   // floats in each array
  int nnz, ps, pieces, stride;
  float* ring;  // this warp's stages
  Meta* meta;   // this warp's Metas
  int lane, h, q;
  Ids ids;
  int n, npairs, K, total_q;
  long long win, win_next;  // the id windows
  int wcur;
  // the value cursor: round vs, pair vpi (its first feature vqa in the
  // sequence), piece vp; vfirst: this half's feature's first slot (or -1)
  long long vfirst;
  int vs, vpi, vqa, vp;
  int cs;  // the stage read next; its rows went out D/2 ticks before

  // `area`: the block's shared memory past the residual
  __device__ __forceinline__ SlotRing(const float* values_, const int* rows_, long long n_feat_,
                                      int nnz_max, int stride_, float* area, Ids ids_, int n_,
                                      int K_)
      : values(values_), rows(rows_), n_feat(n_feat_), total(n_feat_ * nnz_max), nnz(nnz_max),
        stride(stride_), ids(ids_), n(n_), K(K_) {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    h = lane >> 4;
    q = lane & 15;
    ps = nnz <= 32 * NT ? nnz : 32 * NT;
    pieces = (nnz + ps - 1) / ps;
    ring = area + (size_t)warp * D * 4 * stride;
    meta = reinterpret_cast<Meta*>(area + (size_t)RING_WARPS * D * 4 * stride) + warp * D * 2;
    npairs = (n + 1) / 2;
    total_q = n * K;
    win = window(0);
    win_next = window(1);
    wcur = 0;
    vfirst = -1;
    vs = vpi = vqa = vp = 0;
    cs = 0;
  }

  __device__ __forceinline__ float* half_stage(int st) { return ring + (st * 4 + 2 * h) * stride; }

  __device__ __forceinline__ long long window(int w) {  // the id of feature 32 w + lane
    const int f = 32 * w + lane;
    return f >= total_q ? -1 : ids(f);
  }

  __device__ __forceinline__ int clamp(long long at) { return (int)min(16LL, 4 * (total - at)); }

  __device__ __forceinline__ void fetch_values(int st) {  // the next tick's value chunks
    Meta mm{0, 0, 0};
    if (vs < K) {
      if (vp == 0) {
        const int f = vqa + h;
        const long long f0 = __shfl_sync(0xffffffffu, win, f & 31);
        const long long f1 = __shfl_sync(0xffffffffu, win_next, f & 31);
        const long long id = (f >> 5) == wcur ? f0 : f1;
        vfirst = 2 * vpi + h < n && id >= 0 && id < n_feat ? id * nnz : -1;
      }
      if (vfirst >= 0) {
        const long long g0 = vfirst + (long long)ps * vp;
        mm.sh = (int)(g0 & 3);
        mm.at = g0 - mm.sh;
        mm.cnt = min(ps, nnz - ps * vp);
      }
      if (++vp == pieces) {
        vp = 0;
        if (++vpi == npairs) {
          vpi = 0;
          vqa = ++vs * n;
        } else {
          vqa += 2;
        }
        if ((vqa >> 5) > wcur) {  // a pair moves on by at most 2 features
          win = win_next;
          win_next = window(++wcur + 1);
        }
      }
    }
    if (q == 0) meta[st * 2 + h] = mm;
    const int nch = (mm.sh + mm.cnt + 3) >> 2;
    float* vdst = half_stage(st);
#pragma unroll
    for (int c = q; c < 32; c += 16)
      if (c < nch) cp_async16_n(vdst + 4 * c, values + mm.at + 4 * c, clamp(mm.at + 4 * c));
  }

  __device__ __forceinline__ void fetch_rows(int st) {  // stage st's row chunks
    const Meta mm = meta[st * 2 + h];
    const int nch = (mm.sh + mm.cnt + 3) >> 2;
    float* vsrc = half_stage(st);
#pragma unroll
    for (int c = q; c < 32; c += 16) {
      if (c < nch) {  // value chunk c came by this lane's own copy
        const uint4 w = *reinterpret_cast<const uint4*>(vsrc + 4 * c);
        const bool stored = ((w.x | w.y | w.z | w.w) & 0x7fffffffu) != 0;
        cp_async16_n(vsrc + stride + 4 * c, rows + mm.at + 4 * c,
                     stored ? clamp(mm.at + 4 * c) : 0);
      }
    }
  }

  // groups: the values of ticks 0 .. D-1, then the rows of 0 .. D/2-1
  __device__ __forceinline__ void prologue() {
    for (int t = 0; t < D; ++t) {
      fetch_values(t);
      cp_async_commit();
    }
    for (int t = 0; t < HALF; ++t) {
      cp_async_wait<D - 1>();  // tick t's values (this lane's chunks)
      __syncwarp();            // its Metas
      fetch_rows(t);
      cp_async_commit();
    }
  }

  // The next pair: this half's feature's -z . rs, on every lane of the half.
  __device__ __forceinline__ float score_pair(const float* rs) {
    float dot0 = 0.f, dot1 = 0.f;  // slot_dot's lane-q and lane-(q + 16) partials
    for (int pc = 0; pc < pieces; ++pc) {
      cp_async_wait<HALF - 1>();
      __syncwarp();  // every lane's chunks of stage cs, and its Metas
      const Meta mm = meta[cs * 2 + h];
      const float* sv = half_stage(cs) + mm.sh;
      const int* rw = reinterpret_cast<const int*>(sv + stride);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int k = q + 32 * t;
        if (k < mm.cnt) dot0 = fmaf(sv[k], rs[rw[k]], dot0);
        if (k + 16 < mm.cnt) dot1 = fmaf(sv[k + 16], rs[rw[k + 16]], dot1);
      }
      __syncwarp();  // stage cs read by every lane before it is refilled
      fetch_rows((cs + HALF) & (D - 1));
      fetch_values(cs);
      cp_async_commit();
      cs = (cs + 1) & (D - 1);
    }
    float v = dot0 + dot1;  // warp_sum's xor-16 level, then the rest in the half
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return -v;
  }
};

// True when rows of T[m] starting at base are all 16-byte aligned.
template <typename T>
inline bool rows_vectorizable(const void* base, int m) {
  return (reinterpret_cast<uintptr_t>(base) % 16 == 0) && (m % Vec16<T>::N == 0);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
