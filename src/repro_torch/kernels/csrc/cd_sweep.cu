// One sweep of coordinate descent (the lasso's penalized form, Glmnet's
// update) in one launch on one block: for each position t of the order,
// j = order[t] (t itself when the order is cyclic),
//
//     rho   = z_j . R + a_j ||z_j||^2
//     a_new = S_lam(rho) / max(||z_j||^2, 1e-12)
//     d     = a_new - a_j;  R -= d z_j;  a_j = a_new;  max_delta = max(max_delta, |d|)
//
// alpha and R (f32) are updated in place; the design is f32 or bf16, read
// and widened to f32. It replaces no pallas_call: the reference runs the
// sweep as an XLA fori_loop (src/repro/core/baselines.py:70-96). See
// kernels/cd_sweep.py for the bound and the design.
#include "common.cuh"

constexpr int CD_MAX_SLOTS = 16;  // the column ring's depth at most
constexpr int CD_ORDER_RING = 32;  // order entries staged ahead (>= 2 * CD_MAX_SLOTS)
constexpr int CD_MAX_WARPS = 32;
constexpr int CD_RPT = 4;  // residual entries a thread on the ring route (m up to 4,096)

// 4- and 8-byte copies into shared memory (sm_80's cp.async; .ca is the
// only cache level that takes sizes below 16). `bytes` < 4 zero-fills.
__device__ __forceinline__ void cp_async4_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Wait until at most n (0 <= n < CD_MAX_SLOTS) of this thread's groups pend:
// the wait takes an immediate, and the ring's depth is a launch argument.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
#define CD_WAIT_CASE(k) \
  case k:               \
    cp_async_wait<k>(); \
    break;
    CD_WAIT_CASE(0) CD_WAIT_CASE(1) CD_WAIT_CASE(2) CD_WAIT_CASE(3) CD_WAIT_CASE(4)
    CD_WAIT_CASE(5) CD_WAIT_CASE(6) CD_WAIT_CASE(7) CD_WAIT_CASE(8) CD_WAIT_CASE(9)
    CD_WAIT_CASE(10) CD_WAIT_CASE(11) CD_WAIT_CASE(12) CD_WAIT_CASE(13)
    default:
      cp_async_wait<14>();
#undef CD_WAIT_CASE
  }
}

// The block's barrier: a lone warp needs only __syncwarp, which orders its
// lanes' memory accesses as __syncthreads does a block's.
__device__ __forceinline__ void cd_barrier(bool one_warp) {
  if (one_warp)
    __syncwarp();
  else
    __syncthreads();
}

// The dot's total: one warp's butterfly (every lane ends with the same
// bits), then, with several warps, the warps' partials added in warp order
// by every thread. part[t & 1] is written before the position's barrier and
// read after it; a position's partials are overwritten two positions later,
// past the next barrier.
__device__ __forceinline__ float cd_partial(float dot, float (*part)[CD_MAX_WARPS], int t,
                                            bool one_warp) {
  dot = warp_sum(dot);
  if (!one_warp && (threadIdx.x & 31) == 0) part[t & 1][threadIdx.x >> 5] = dot;
  return dot;
}

__device__ __forceinline__ float cd_total(float dot, float (*part)[CD_MAX_WARPS], int t,
                                          bool one_warp) {
  if (one_warp) return dot;
  const int nw = blockDim.x >> 5;
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += part[t & 1][w];
  return s;
}

// Glmnet's update from rho's parts, in the plain version's op order (every
// op a separate _rn intrinsic, so nvcc cannot contract into FMAs). Returns d.
__device__ __forceinline__ float cd_step(float dot, float a, float n2, float lam, float& a_new) {
  const float rho = __fadd_rn(dot, __fmul_rn(a, n2));
  const float st = __fmul_rn(sign_of(rho), fmaxf(__fsub_rn(fabsf(rho), lam), 0.f));
  a_new = __fdiv_rn(st, fmaxf(n2, 1e-12f));
  return __fsub_rn(a_new, a);
}

// z_j's words: a row of T[m] from its 4-byte aligned floor (bf16 rows of odd
// m start mid-word, `sh` elements in; the copy clamps the last word at the
// end of the array).
template <typename T>
__device__ __forceinline__ void row_words(long long j, int m, long long& w0, int& sh, int& nw) {
  if (sizeof(T) == 4) {
    w0 = j * m;
    sh = 0;
    nw = m;
  } else {
    const long long e0 = j * m;
    w0 = e0 >> 1;
    sh = (int)(e0 & 1);
    nw = (sh + m + 1) >> 1;
  }
}

// The residual in registers, CD_RPT entries a thread (element tid + k * NT),
// the columns streamed through a ring of `slots` stages in shared memory,
// D = slots - 1 of them in flight: position t issues column t + D (and the
// order entry t + 2D), so its row is known a stage ahead. Each stage is
// `sw` words; then the stages' ||z||^2, then the order ring.
template <typename T>
__global__ void __launch_bounds__(1024, 1)
    cd_sweep_ring_kernel(const T* __restrict__ X, float* alpha, float* R,
                         const float* __restrict__ zn2, const long long* __restrict__ order,
                         float* max_delta, long long p, int m, float lam, int slots, int sw) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[2][CD_MAX_WARPS];
  float* cols = smem;
  float* n2s = cols + (size_t)slots * sw;
  long long* ords = reinterpret_cast<long long*>(n2s + ((slots + 1) & ~1));
  const int tid = threadIdx.x, NT = blockDim.x;
  const bool one_warp = NT == 32, cyclic = order == nullptr;
  const int D = slots - 1;
  const long long total_bytes = (long long)p * m * (long long)sizeof(T);
  const uint32_t* Xw = reinterpret_cast<const uint32_t*>(X);

  float r[CD_RPT];
#pragma unroll
  for (int k = 0; k < CD_RPT; ++k) {
    const int i = tid + k * NT;
    r[k] = i < m ? R[i] : 0.f;
  }

  // column c into stage st: its words, its ||z||^2 (thread 0)
  auto fetch = [&](long long c, int st) {
    const long long jc = cyclic ? c : ords[c & (CD_ORDER_RING - 1)];
    long long w0;
    int sh, nw;
    row_words<T>(jc, m, w0, sh, nw);
    float* dst = cols + (size_t)st * sw;
    for (int w = tid; w < nw; w += NT) {
      const long long at = w0 + w;
      cp_async4_n(dst + w, Xw + at, (int)min(4LL, total_bytes - 4 * at));
    }
    if (tid == 0) {
      cp_async4_n(n2s + st, zn2 + jc, 4);
      // a hint: a_j is read (never copied) when its position comes
      asm volatile("prefetch.global.L1 [%0];" ::"l"(alpha + jc));
    }
  };

  if (!cyclic) {  // the order's first 2D entries, then a barrier
    for (long long c = tid; c < 2 * D && c < p; c += NT) ords[c] = order[c];
    cd_barrier(one_warp);
  }
  for (int s = 0; s < D; ++s) {  // columns 0 .. D-1, one group each
    if (s < p) fetch(s, s);
    cp_async_commit();
  }
  cp_async_wait_n(D - 1);  // column 0
  cd_barrier(one_warp);

  float md = 0.f;
  long long last_j = -1;
  float last_a = 0.f;
  int cur = 0;
  for (long long t = 0; t < p; ++t) {
    // 1. the position's row, ||z||^2 and a_j: a_j read here, in the chain
    //    (the store of the position before may not be visible yet, so a
    //    repeat of its row takes the value it wrote)
    const long long j = cyclic ? t : ords[t & (CD_ORDER_RING - 1)];
    const float n2 = n2s[cur];
    const float a = j == last_j ? last_a : alpha[j];
    // 2. the partial dot; z kept for the update
    long long w0;
    int sh, nw;
    row_words<T>(j, m, w0, sh, nw);
    const T* col = reinterpret_cast<const T*>(cols + (size_t)cur * sw) + sh;
    float z[CD_RPT];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < CD_RPT; ++k) {
      const int i = tid + k * NT;
      z[k] = i < m ? to_f32(col[i]) : 0.f;
      dot = fmaf(z[k], r[k], dot);
    }
    dot = cd_partial(dot, part, (int)t, one_warp);
    // 3. the next stage's copies: column t + D into the stage column t - 1
    //    left (read before the last barrier), order entry t + 2D
    if (t + D < p) {
      const int st = cur == 0 ? slots - 1 : cur - 1;
      fetch(t + D, st);
      if (!cyclic && tid == 0 && t + 2 * D < p)
        cp_async8(ords + ((t + 2 * D) & (CD_ORDER_RING - 1)), order + t + 2 * D);
    }
    cp_async_commit();
    // 4. column t + 1 landed for every thread; the partials visible
    cp_async_wait_n(D - 1);
    cd_barrier(one_warp);
    // 5. the update
    dot = cd_total(dot, part, (int)t, one_warp);
    float a_new;
    const float d = cd_step(dot, a, n2, lam, a_new);
#pragma unroll
    for (int k = 0; k < CD_RPT; ++k) r[k] = __fsub_rn(r[k], __fmul_rn(d, z[k]));
    if (tid == 0) alpha[j] = a_new;
    md = fmaxf(md, fabsf(d));
    last_j = j;
    last_a = a_new;
    cur = cur + 1 == slots ? 0 : cur + 1;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < CD_RPT; ++k) {
    const int i = tid + k * NT;
    if (i < m) R[i] = r[k];
  }
  if (tid == 0) *max_delta = md;
}

// Past the registers' reach: the residual in shared memory when it fits,
// else in place in device memory (`rs` null), each thread owning the same
// elements tid + k * NT as above, so R needs no barrier of its own; the
// columns read straight from device memory.
template <typename T>
__global__ void __launch_bounds__(1024, 1)
    cd_sweep_direct_kernel(const T* __restrict__ X, float* alpha, float* R,
                           const float* __restrict__ zn2, const long long* __restrict__ order,
                           float* max_delta, long long p, int m, float lam, int staged) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[2][CD_MAX_WARPS];
  const int tid = threadIdx.x, NT = blockDim.x;
  const bool one_warp = NT == 32;
  float* r = staged ? smem : R;
  if (staged)
    for (int i = tid; i < m; i += NT) r[i] = R[i];
  float md = 0.f;
  long long last_j = -1;
  float last_a = 0.f;
  for (long long t = 0; t < p; ++t) {
    const long long j = order == nullptr ? t : order[t];
    const float n2 = zn2[j];
    const float a = j == last_j ? last_a : alpha[j];
    const T* col = X + j * m;
    float dot = 0.f;
    for (int i = tid; i < m; i += NT) dot = fmaf(to_f32(col[i]), r[i], dot);
    dot = cd_partial(dot, part, (int)t, one_warp);
    cd_barrier(one_warp);
    dot = cd_total(dot, part, (int)t, one_warp);
    float a_new;
    const float d = cd_step(dot, a, n2, lam, a_new);
    for (int i = tid; i < m; i += NT) r[i] = __fsub_rn(r[i], __fmul_rn(d, to_f32(col[i])));
    if (tid == 0) alpha[j] = a_new;
    md = fmaxf(md, fabsf(d));
    last_j = j;
    last_a = a_new;
  }
  if (staged)
    for (int i = tid; i < m; i += NT) R[i] = r[i];
  if (tid == 0) *max_delta = md;
}

// route codes of kernels/cd_sweep.py's SweepPlan
enum { CD_RING = 0, CD_DIRECT = 1 };

// Dynamic shared memory past 48 KB needs the kernel's limit raised first.
template <typename K>
static cudaError_t cd_smem_limit(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
static int cd_sweep_typed(const void* X, float* alpha, float* R, const float* zn2,
                          const long long* order, float* max_delta, long long p, int m,
                          float lam, int route, int threads, int slots, int sw, size_t smem,
                          cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  cudaError_t err;
  if (route == CD_RING) {
    if (slots < 2 || slots > CD_MAX_SLOTS || (long long)threads * CD_RPT < m)
      return (int)cudaErrorInvalidValue;
    err = cd_smem_limit(cd_sweep_ring_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    cd_sweep_ring_kernel<T><<<1, threads, smem, s>>>(Xt, alpha, R, zn2, order, max_delta, p, m,
                                                     lam, slots, sw);
  } else if (route == CD_DIRECT) {
    err = cd_smem_limit(cd_sweep_direct_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    cd_sweep_direct_kernel<T><<<1, threads, smem, s>>>(Xt, alpha, R, zn2, order, max_delta, p,
                                                       m, lam, smem > 0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int cd_sweep_launch(const void* X, float* alpha, float* R, const float* zn2,
                               const long long* order, float* max_delta, long long p, int m,
                               float lam, int dtype, int route, int threads, int slots, int sw,
                               long long smem, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || m < 1 || p < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return cd_sweep_typed<float>(X, alpha, R, zn2, order, max_delta, p, m, lam, route, threads,
                                 slots, sw, (size_t)smem, s);
  if (dtype == DT_BF16)
    return cd_sweep_typed<__nv_bfloat16>(X, alpha, R, zn2, order, max_delta, p, m, lam, route,
                                         threads, slots, sw, (size_t)smem, s);
  return (int)cudaErrorInvalidValue;
}

// The sweep's latency floor: n dependent warp sums, each feeding the next
// (the chain every coordinate's dot sits on), on one warp. Written to *out
// so the chain is not removed; a timing yardstick only.
__global__ void cd_chain_floor_kernel(long long n, float* out) {
  float v = (float)threadIdx.x;
  for (long long t = 0; t < n; ++t) v = warp_sum(v) * 1e-3f;
  if (threadIdx.x == 0) *out = v;
}

extern "C" int cd_chain_floor_launch(long long n, float* out, void* stream) {
  cd_chain_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(n, out);
  return (int)cudaGetLastError();
}
