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

// True when rows of T[m] starting at base are all 16-byte aligned.
template <typename T>
inline bool rows_vectorizable(const void* base, int m) {
  return (reinterpret_cast<uintptr_t>(base) % 16 == 0) && (m % Vec16<T>::N == 0);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
