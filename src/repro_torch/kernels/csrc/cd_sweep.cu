// Coordinate descent on the lasso's penalized form (Glmnet's update), one
// sweep at a time: for each position t of the order, j = order[t] (t itself
// when the order is cyclic),
//
//     rho   = z_j . R + a_j ||z_j||^2
//     a_new = S_lam(rho) / max(||z_j||^2, 1e-12)
//     d     = a_new - a_j;  R -= d z_j;  a_j = a_new;  max_delta = max(max_delta, |d|)
//
// alpha and R (f32) are updated in place; the design is f32 or bf16, read
// and widened to f32. It replaces no pallas_call: the reference runs the
// sweep as an XLA fori_loop (src/repro/core/baselines.py:70-96).
//
// Two sweeps compute that function bit for bit. The unscreened one
// (cd_sweep_launch: cd_sweep_ring_kernel, cd_sweep_direct_kernel) runs
// every position on one block. The screened one (cd_score_launch, then
// cd_walk_launch) first scores every row against R in one grid-wide pass,
// then walks the order on one block, running only the positions the score
// cannot rule out. Both share the chain's device functions below. See
// kernels/cd_sweep.py for the bounds, the screen's derivation and the design.
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
// past the next barrier. `store`: lane 0 keeps its warp's partial for the
// block (a lone warp that reads its own butterfly needs not).
__device__ __forceinline__ float cd_partial(float dot, float (*part)[CD_MAX_WARPS], int t,
                                            bool store) {
  dot = warp_sum(dot);
  if (store && (threadIdx.x & 31) == 0) part[t & 1][threadIdx.x >> 5] = dot;
  return dot;
}

// The total of nw warps' partials (nw = 1: that warp's butterfly).
__device__ __forceinline__ float cd_total(float (*part)[CD_MAX_WARPS], int t, int nw) {
  if (nw == 1) return part[t & 1][0];
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += part[t & 1][w];
  return s;
}

// The ring route's per-thread dot and update: the residual's elements
// tid + k * nt, k = 0 .. CD_RPT - 1, in registers; fmas in k order.
__device__ __forceinline__ float cd_dot4(const float (&z)[CD_RPT], const float (&r)[CD_RPT]) {
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < CD_RPT; ++k) dot = fmaf(z[k], r[k], dot);
  return dot;
}

__device__ __forceinline__ void cd_axpy4(float (&r)[CD_RPT], const float (&z)[CD_RPT],
                                         float d) {
#pragma unroll
  for (int k = 0; k < CD_RPT; ++k) r[k] = __fsub_rn(r[k], __fmul_rn(d, z[k]));
}

// The direct route's: elements tid, tid + nt, ... of a residual in shared or
// device memory, the column read straight from device memory.
template <typename T>
__device__ __forceinline__ float cd_dot_strided(const T* col, const float* r, int m, int nt) {
  float dot = 0.f;
  for (int i = threadIdx.x; i < m; i += nt) dot = fmaf(to_f32(col[i]), r[i], dot);
  return dot;
}

template <typename T>
__device__ __forceinline__ void cd_axpy_strided(float* r, const T* col, float d, int m, int nt) {
  for (int i = threadIdx.x; i < m; i += nt) r[i] = __fsub_rn(r[i], __fmul_rn(d, to_f32(col[i])));
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
#pragma unroll
    for (int k = 0; k < CD_RPT; ++k) {
      const int i = tid + k * NT;
      z[k] = i < m ? to_f32(col[i]) : 0.f;
    }
    float dot = cd_partial(cd_dot4(z, r), part, (int)t, !one_warp);
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
    if (!one_warp) dot = cd_total(part, (int)t, NT >> 5);
    float a_new;
    const float d = cd_step(dot, a, n2, lam, a_new);
    cd_axpy4(r, z, d);
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
    float dot = cd_partial(cd_dot_strided(col, r, m, NT), part, (int)t, !one_warp);
    cd_barrier(one_warp);
    if (!one_warp) dot = cd_total(part, (int)t, NT >> 5);
    float a_new;
    const float d = cd_step(dot, a, n2, lam, a_new);
    cd_axpy_strided(r, col, d, m, NT);
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

// ---- the screened sweep: the score pass, then the walker ------------------
//
// Position t of row j with a_j = 0 leaves everything as it was when
// |z_j . R_t| (as the chain rounds it) <= lam. The score pass bounds that
// from R_0, the residual at the walk's start: the walker skips t while
// a_j = 0 and B <= h_j, where B (f32, rounded up) bounds how far the moves
// since R_0 and their rounding can have taken the residual, and h_j is
// row j's headroom (f32, rounded down). kernels/cd_sweep.py derives both.

constexpr int CS_THREADS = 256;  // the score pass: a warp a row, 8 rows a block at a time
constexpr int CW_CHUNK = CS_THREADS;  // the rows of a score chunk (a warp's 32 rows, 8 warps)
constexpr int CS_ROWS = 4;            // rows a score warp reads at once
constexpr int CW_E = 4;          // window positions a walker thread tests
constexpr int CW_MAX_WORDS = CW_E * CD_MAX_WARPS;  // a window's ballot words at most

// sqrt((q + m 2^-149) / (1 - G)) rounded up: >= ||v|| for the f32 sum of
// squares q of m elements (G covers the sum's rounding, 2^-149 an element
// its underflow).
__device__ __forceinline__ double cw_norm_up(float q, int m, double G) {
  return sqrt(((double)q + m * 0x1p-149) / (1.0 - G)) * (1.0 + 0x1p-50);
}

// c = z . R_0 and q = ||z||^2 of row j (a warp, fmas in lane order), then
// its headroom h_j and norm bound nz_j (lane 0, f64). A block scores a
// chunk of CW_CHUNK rows at a time, 32 a warp, and writes the chunk's
// least headroom of a row with a_j = 0 (-inf when a row has a_j != 0 or a
// NaN headroom): a cyclic walk skips a chunk whose least headroom is at
// least B without reading it. Every block sums ||R_0||^2 in the same
// order, so every block holds the same bound; block 0 writes it to *r0n
// for the walker. A non-finite zn2_j makes h_j NaN: a row the caller gave
// a non-finite norm always runs.
template <typename T>
__global__ void __launch_bounds__(CS_THREADS)
    cd_score_kernel(const T* __restrict__ X, const float* __restrict__ R,
                    const float* __restrict__ zn2, const float* __restrict__ alpha, long long p,
                    int m, float lam, double G, float* __restrict__ head, float* __restrict__ nz,
                    float* __restrict__ cmin, double* __restrict__ r0n) {
  __shared__ float red[CS_THREADS / 32];
  __shared__ double rn_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s = 0.f;
  for (int i = tid; i < m; i += CS_THREADS) s = fmaf(R[i], R[i], s);
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < CS_THREADS / 32; ++w) t += red[w];
    rn_s = cw_norm_up(t, m, G);
    if (blockIdx.x == 0) *r0n = rn_s;
  }
  __syncthreads();
  const double rn = rn_s;
  const double t2 = 2.0 * G * rn;
  const long long nch = (p + CW_CHUNK - 1) / CW_CHUNK;
  for (long long ch = blockIdx.x; ch < nch; ch += gridDim.x) {
    // the warp's 32 rows, CS_ROWS at a time (their loads in flight together);
    // lane k keeps row k's sums
    const long long j0 = ch * CW_CHUNK + warp * 32;
    float my_c = 0.f, my_q = 0.f;
    for (int k0 = 0; k0 < 32; k0 += CS_ROWS) {
      float c[CS_ROWS], q[CS_ROWS];
#pragma unroll
      for (int u = 0; u < CS_ROWS; ++u) c[u] = q[u] = 0.f;
      for (int i = lane; i < m; i += 32) {
        const float r = __ldg(R + i);
#pragma unroll
        for (int u = 0; u < CS_ROWS; ++u) {
          const long long j = j0 + k0 + u;
          if (j < p) {
            const float v = to_f32(X[j * m + i]);
            c[u] = fmaf(v, r, c[u]);
            q[u] = fmaf(v, v, q[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < CS_ROWS; ++u) {
        c[u] = warp_sum(c[u]);
        q[u] = warp_sum(q[u]);
        if (lane == k0 + u) {
          my_c = c[u];
          my_q = q[u];
        }
      }
    }
    // each lane its row's headroom and norm bound, in f64
    const long long j = j0 + lane;
    float v = INFINITY;
    if (j < p) {
      const float n = __double2float_ru(cw_norm_up(my_q, m, G));
      const double t1 = ((double)lam - fabs((double)my_c) - m * 0x1p-148) / (double)n;
      double h = (t1 - t2) / (1.0 + G) - 0x1p-40 * (fabs(t1) + t2);
      if (!isfinite(zn2[j])) h = __longlong_as_double(0x7ff8000000000000LL);
      const float h32 = __double2float_rd(h);
      head[j] = h32;
      nz[j] = n;
      v = alpha[j] == 0.f && h32 == h32 ? h32 : -INFINITY;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float least = red[0];
      for (int w = 1; w < CS_THREADS / 32; ++w) least = fminf(least, red[w]);
      cmin[ch] = least;
    }
    __syncthreads();
  }
}

// B after a move d of a row whose norm is at most nzj: the move itself and
// the rounding of R -= d z (an element at most u |d z_i| + u |R_i|, R's
// norm at most rn + B, an underflow 2^-149 an element, here m 2^-126), in
// f32 rounded up.
__device__ __forceinline__ float cw_grow(float B, float d, float nzj, float rn, int m) {
  const float mv = __fmul_ru(__fmul_ru(fabsf(d), nzj), 1.f + 0x1p-22f);
  const float t = __fadd_ru(__fadd_ru(__fadd_ru(B, mv), __fmul_ru(rn, 0x1p-22f)),
                            __fmul_ru((float)m, 0x1p-126f));
  return __fmul_ru(t, 1.f + 0x1p-21f);
}

// ||v|| rounded up from the f32 sum of squares q of m elements of v (as
// cw_norm_up, in f32), times 1 + 2^-22 for elements that are themselves
// rounded differences (each within u of the exact one).
__device__ __forceinline__ float cw_drift_up(float q, int m, float one_minus_G) {
  const float t = __fdiv_ru(__fadd_ru(q, __fmul_ru((float)m, 0x1p-126f)), one_minus_G);
  return __fmul_ru(__fsqrt_ru(t), 1.f + 0x1p-22f);
}

// The first set bit at or after bit `from` of a window's ballot words (bit
// b is window offset b: word w holds offsets 32 w .. 32 w + 31), or -1. Each
// warp finds it by itself, the words read a warp-width at a time.
__device__ __forceinline__ int cw_first(const unsigned* buf, int nwords, int from) {
  const int lane = threadIdx.x & 31, w_from = from >> 5;
  for (int base = w_from & ~31; base < nwords; base += 32) {
    const int w = base + lane;
    unsigned v = w < nwords && w >= w_from ? buf[w] : 0u;
    if (w == w_from) v &= ~0u << (from & 31);
    const unsigned any = __ballot_sync(0xffffffffu, v != 0u);
    if (any) {
      const int l = __ffs(any) - 1;
      return (base + l) * 32 + __ffs(__shfl_sync(0xffffffffu, v, l)) - 1;
    }
  }
  return -1;
}

// The walker: one block walks the order from position io[0] to its end, or
// to a re-base (`rebase_after` idle survivors: positions run with a_j = 0
// that left it at 0). Each turn every thread tests CW_E positions of the
// window (W = CW_E * blockDim.x positions from w0) under the current B; the
// ballots find the first survivor at or after `cur`. The first nt threads
// (H's plan for m) run it: H's dot, H's sums, H's update, the column read
// straight from device memory. REGS keeps R in registers (H's ring route, m
// <= 4,096); otherwise R lives in shared memory (`staged`) or device memory
// (blockDim.x = nt). On return io[0] is the next position to decide (p when
// the sweep is done), io[1] and io[2] add the survivors and the idle ones,
// *md_io the sweep's max |d| so far. B after a survivor: the moves' sum
// (cw_grow), and with REGS the tighter ||R - R_0|| the chain sums beside the
// survivor's dot, plus its move.
template <typename T, bool REGS>
__global__ void __launch_bounds__(1024, 1)
    cd_walk_kernel(const T* __restrict__ X, float* alpha, float* R, const float* __restrict__ zn2,
                   const long long* __restrict__ order, const float* __restrict__ head,
                   const float* __restrict__ nz, const float* __restrict__ cmin,
                   const double* __restrict__ r0n, float* md_io, long long* io, long long p,
                   int m, float lam, int nt, int staged, long long rebase_after) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[2][CD_MAX_WARPS];
  __shared__ float part_dr[2][CD_MAX_WARPS];
  __shared__ unsigned masks[2][CW_MAX_WORDS];
  const int tid = threadIdx.x, NTB = blockDim.x, lane = tid & 31, nwb = NTB >> 5;
  const int nwords = CW_E * nwb;
  const long long W = (long long)CW_E * NTB;
  const bool cyclic = order == nullptr, chain = tid < nt;
  float* rs = staged ? smem : R;  // the direct route's residual
  const float rn = __double2float_ru(*r0n);
  // 1 - G rounded down, G = kernels/cd_sweep.py's screen_gamma
  const float one_minus_G = __double2float_rd(1.0 - 2.0 * (m + 64) * 0x1p-24);
  float md = *md_io;
  long long cur = io[0];

  float r[CD_RPT], r0[CD_RPT];  // REGS: R and R_0, the walk's start
  if constexpr (REGS) {
#pragma unroll
    for (int k = 0; k < CD_RPT; ++k) {
      const int i = tid + k * nt;
      r[k] = r0[k] = chain && i < m ? R[i] : 0.f;
    }
  } else if (staged) {
    for (int i = tid; i < m; i += NTB) rs[i] = R[i];
  }

  // the window: each thread's CW_E positions w0 + e * NTB + tid, their rows,
  // headrooms and whether a_j = 0, kept current as the walk moves rows (the
  // last survivor's store may not be visible yet: its row takes the value
  // it wrote)
  long long surv = 0, idle = 0, last_j = -1;
  float last_a = 0.f;
  float hh[CW_E];
  long long jj[CW_E];
  bool az[CW_E];
  long long w0 = cur - W;  // the first turn loads the first window
  auto load_window = [&]() {
#pragma unroll
    for (int e = 0; e < CW_E; ++e) {
      const long long pos = w0 + (long long)e * NTB + tid;
      jj[e] = pos < p ? (cyclic ? pos : order[pos]) : -1;
      hh[e] = pos < p ? head[jj[e]] : 0.f;
      az[e] = pos >= p || (jj[e] == last_j ? last_a : alpha[jj[e]]) == 0.f;
    }
  };

  float B = 0.f;  // rounded up
  int it = 0, sc = 0;

  // cyclic: the first position at or after `from` whose chunk may hold a
  // survivor under B (a thread a chunk, NTB chunks a turn), or p
  const long long nch = (p + CW_CHUNK - 1) / CW_CHUNK;
  auto skip_chunks = [&](long long from) -> long long {
    for (long long c0 = from / CW_CHUNK; c0 < nch; c0 += NTB) {
      const long long c = c0 + tid;
      const unsigned b = __ballot_sync(0xffffffffu, c < nch && !(B <= cmin[c]));
      unsigned* cbuf = masks[it & 1];
      if (lane == 0) cbuf[tid >> 5] = b;
      __syncthreads();
      ++it;
      const int off = cw_first(cbuf, nwb, 0);
      if (off >= 0) {
        const long long at = (c0 + off) * CW_CHUNK;
        return at > from ? at : from;
      }
    }
    return p;
  };

  while (cur < p) {
    if (cur >= w0 + W) {
      if (cyclic) {
        cur = skip_chunks(cur);
        if (cur >= p) break;
      }
      w0 = cur;
      load_window();
    }
    // 1. the window's survivors under B, one ballot word a warp and slot
    unsigned* buf = masks[it & 1];
#pragma unroll
    for (int e = 0; e < CW_E; ++e) {
      const long long pos = w0 + (long long)e * NTB + tid;
      const bool sv = pos >= cur && pos < p && (!az[e] || !(B <= hh[e]));
      const unsigned b = __ballot_sync(0xffffffffu, sv);
      if (lane == 0) buf[e * nwb + (tid >> 5)] = b;
    }
    __syncthreads();
    ++it;
    // 2. the position to run: the first survivor
    const int off = cw_first(buf, nwords, (int)(cur - w0));
    if (off < 0) {  // nothing in the window can move
      cur = w0 + W;
      continue;
    }
    const long long run = w0 + off;
    // 3. its row, a_j (read here, in the chain; a row repeated back to back
    //    takes the value it wrote), ||z||^2, nz and the dot's partial
    const long long j = cyclic ? run : order[run];
    const float a = j == last_j ? last_a : alpha[j];
    const float n2 = zn2[j], nzj = nz[j];
    const T* col = X + j * m;
    float dot;
    float z[CD_RPT];
    if constexpr (REGS) {
#pragma unroll
      for (int k = 0; k < CD_RPT; ++k) {
        const int i = tid + k * nt;
        z[k] = chain && i < m ? to_f32(col[i]) : 0.f;
      }
      dot = cd_partial(cd_dot4(z, r), part, sc, chain);
      // ||R - R_0||^2 beside the dot (R before this update), for B
      float dr = 0.f;
#pragma unroll
      for (int k = 0; k < CD_RPT; ++k) {
        const float e = __fsub_rn(r[k], r0[k]);
        dr = fmaf(e, e, dr);
      }
      cd_partial(dr, part_dr, sc, chain);
    } else {
      dot = cd_partial(cd_dot_strided(col, rs, m, nt), part, sc, chain);
    }
    // 4. the partials visible; the update
    __syncthreads();
    dot = cd_total(part, sc, nt >> 5);
    float a_new;
    const float d = cd_step(dot, a, n2, lam, a_new);
    if constexpr (REGS) {
      if (chain) cd_axpy4(r, z, d);
    } else {
      cd_axpy_strided(rs, col, d, m, nt);
    }
    if (tid == 0) alpha[j] = a_new;
    md = fmaxf(md, fabsf(d));
    if (d != 0.f) B = cw_grow(B, d, nzj, rn, m);
    if constexpr (REGS) {
      // the tighter of the moves' sum and ||R - R_0|| before this update (its
      // f32 differences rounded by at most u) plus this move
      const float D = cw_drift_up(cd_total(part_dr, sc, nt >> 5), m, one_minus_G);
      B = fminf(B, d != 0.f ? cw_grow(D, d, nzj, rn, m) : D);
    }
    ++surv;
    if (a == 0.f && a_new == 0.f) ++idle;
    if (!cyclic) {
#pragma unroll
      for (int e = 0; e < CW_E; ++e)
        if (jj[e] == j) az[e] = a_new == 0.f;
    }
    last_j = j;
    last_a = a_new;
    ++sc;
    cur = run + 1;
    if (rebase_after > 0 && idle >= rebase_after) break;
  }
  if constexpr (REGS) {
#pragma unroll
    for (int k = 0; k < CD_RPT; ++k) {
      const int i = tid + k * nt;
      if (chain && i < m) R[i] = r[k];
    }
  } else if (staged) {
    for (int i = tid; i < m; i += NTB) R[i] = rs[i];
  }
  __syncthreads();  // every thread read io[0] and *md_io before thread 0 writes them
  if (tid == 0) {
    *md_io = md;
    io[0] = cur < p ? cur : p;
    io[1] += surv;
    io[2] += idle;
  }
}

template <typename T>
static int cd_score_typed(const void* X, const float* R, const float* zn2, const float* alpha,
                          float* head, float* nz, float* cmin, double* r0n, long long p, int m,
                          float lam, double G, int blocks, cudaStream_t s) {
  cd_score_kernel<T><<<blocks, CS_THREADS, 0, s>>>(static_cast<const T*>(X), R, zn2, alpha, p, m,
                                                   lam, G, head, nz, cmin, r0n);
  return (int)cudaGetLastError();
}

extern "C" int cd_score_launch(const void* X, const float* R, const float* zn2,
                               const float* alpha, float* head, float* nz, float* cmin,
                               double* r0n, long long p, int m, float lam, double G, int dtype,
                               int blocks, void* stream) {
  if (m < 1 || p < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return cd_score_typed<float>(X, R, zn2, alpha, head, nz, cmin, r0n, p, m, lam, G, blocks, s);
  if (dtype == DT_BF16)
    return cd_score_typed<__nv_bfloat16>(X, R, zn2, alpha, head, nz, cmin, r0n, p, m, lam, G,
                                         blocks, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int cd_walk_typed(const void* X, float* alpha, float* R, const float* zn2,
                         const long long* order, const float* head, const float* nz,
                         const float* cmin, const double* r0n, float* md, long long* io,
                         long long p, int m, float lam, int route, int threads, int nt,
                         size_t smem, long long rebase_after, cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  cudaError_t err;
  if (route == CD_RING) {
    if ((long long)nt * CD_RPT < m || nt > threads || smem != 0)
      return (int)cudaErrorInvalidValue;
    cd_walk_kernel<T, true><<<1, threads, 0, s>>>(Xt, alpha, R, zn2, order, head, nz, cmin, r0n,
                                                  md, io, p, m, lam, nt, 0, rebase_after);
  } else if (route == CD_DIRECT) {
    if (nt != threads) return (int)cudaErrorInvalidValue;
    err = cd_smem_limit(cd_walk_kernel<T, false>, smem);
    if (err != cudaSuccess) return (int)err;
    cd_walk_kernel<T, false><<<1, threads, smem, s>>>(Xt, alpha, R, zn2, order, head, nz, cmin,
                                                      r0n, md, io, p, m, lam, nt, smem > 0,
                                                      rebase_after);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int cd_walk_launch(const void* X, float* alpha, float* R, const float* zn2,
                              const long long* order, const float* head, const float* nz,
                              const float* cmin, const double* r0n, float* md, long long* io,
                              long long p, int m, float lam, int dtype, int route, int threads,
                              int nt, long long smem, long long rebase_after, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || nt < 32 || nt % 32 != 0 || m < 1 ||
      p < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return cd_walk_typed<float>(X, alpha, R, zn2, order, head, nz, cmin, r0n, md, io, p, m, lam,
                                route, threads, nt, (size_t)smem, rebase_after, s);
  if (dtype == DT_BF16)
    return cd_walk_typed<__nv_bfloat16>(X, alpha, R, zn2, order, head, nz, cmin, r0n, md, io, p,
                                        m, lam, route, threads, nt, (size_t)smem, rebase_after,
                                        s);
  return (int)cudaErrorInvalidValue;
}
