// health_flags: the guarded solve's between-chunk check in one launch. It
// replaces no Pallas kernel: the reference checks the state with XLA ops
// in one jitted program (src/repro/resilience/guards.py:127-135). Eager
// torch would take about 10 launches for it (isfinite and all on beta, on
// scale and on each float leaf of the co-state, a stack and a copy) and a
// bool temporary of p bytes. See kernels/health.py for the bound.
//
// out = [beta_ok, co_ok, stall]: beta_ok is 1 when beta and scale hold no
// NaN or Inf, co_ok when the co-state's float leaves hold none, stall the
// int32 stall count, so one 12-byte copy serves the check and the loop's
// stop test. The test reads each element's bits: a value is not finite
// when its exponent bits are all ones (f32 0x7f800000, bf16 0x7f80), so
// both dtypes go through one 16-byte load path, four 32-bit words a load.
// A grid-stride pass ORs each thread's "bad" bits, the block reduces them
// with __syncthreads_or, block partials go to scratch, and the last block
// to finish (a ticket) reduces the partials and resets the ticket to 0 for
// the next launch. OR is order-free, so the flags are deterministic.
#include "common.cuh"

constexpr int HEALTH_MAX_SEGS = 8;
constexpr int HEALTH_THREADS = 256;
constexpr int HEALTH_MAX_BLOCKS = 1024;
constexpr int HEALTH_UNROLL = 4;

struct HealthSegs {
  const void* ptr[HEALTH_MAX_SEGS];
  long long n[HEALTH_MAX_SEGS];  // elements
  int bf16[HEALTH_MAX_SEGS];     // 1: 2-byte elements, 0: 4-byte
  int group[HEALTH_MAX_SEGS];    // 0: beta and scale, 1: the co-state
  int count;
};

__device__ __forceinline__ bool word_bad(unsigned w, int bf16) {
  // the high half's exponent mask is f32's; bf16 tests the low half too
  const bool hi = (w & 0x7f800000u) == 0x7f800000u;
  return bf16 ? (hi || (w & 0x7f80u) == 0x7f80u) : hi;
}

__device__ __forceinline__ bool vec_bad(const uint4& v, int bf16) {
  return word_bad(v.x, bf16) | word_bad(v.y, bf16) | word_bad(v.z, bf16) | word_bad(v.w, bf16);
}

__global__ void __launch_bounds__(HEALTH_THREADS)
health_flags_kernel(HealthSegs segs, const int* __restrict__ stall, int* __restrict__ out,
                    int* part, unsigned int* done) {
  __shared__ bool last;
  const long long tid = (long long)blockIdx.x * HEALTH_THREADS + threadIdx.x;
  const long long T = (long long)gridDim.x * HEALTH_THREADS;
  bool bad0 = false, bad1 = false;
  for (int s = 0; s < segs.count; ++s) {
    const int bf16 = segs.bf16[s];
    const long long n = segs.n[s];
    const int es = bf16 ? 2 : 4;
    bool b = false;
    const bool aligned = (reinterpret_cast<uintptr_t>(segs.ptr[s]) & 15) == 0;
    const long long nvec = aligned ? n * es / 16 : 0;
    const uint4* v = static_cast<const uint4*>(segs.ptr[s]);
    for (long long q = tid; q < nvec; q += HEALTH_UNROLL * T) {
      uint4 w[HEALTH_UNROLL];
#pragma unroll
      for (int u = 0; u < HEALTH_UNROLL; ++u)
        w[u] = q + u * T < nvec ? __ldg(v + q + u * T) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < HEALTH_UNROLL; ++u) b |= vec_bad(w[u], bf16);
    }
    // the elements past the last whole 16 bytes (or all of them, unaligned)
    for (long long i = nvec * 16 / es + tid; i < n; i += T) {
      if (bf16) {
        const unsigned h = __ldg(static_cast<const unsigned short*>(segs.ptr[s]) + i);
        b |= (h & 0x7f80u) == 0x7f80u;
      } else {
        b |= word_bad(__ldg(static_cast<const unsigned*>(segs.ptr[s]) + i), 0);
      }
    }
    if (segs.group[s])
      bad1 |= b;
    else
      bad0 |= b;
  }
  const int any0 = __syncthreads_or(bad0);
  const int any1 = __syncthreads_or(bad1);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = any0;
    part[2 * blockIdx.x + 1] = any1;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int b0 = 0, b1 = 0;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += HEALTH_THREADS) {
    b0 |= __ldcg(part + 2 * k);
    b1 |= __ldcg(part + 2 * k + 1);
  }
  b0 = __syncthreads_or(b0);
  b1 = __syncthreads_or(b1);
  if (threadIdx.x == 0) {
    out[0] = !b0;
    out[1] = !b1;
    out[2] = *stall;
    *done = 0;
  }
}

// scratch: HEALTH_MAX_BLOCKS * 2 ints of block partials, then the ticket
// (u32, 0 between launches)
extern "C" int health_flags_launch(const void* const* ptrs, const long long* ns,
                                   const int* bf16, const int* groups, int count,
                                   const int* stall, int* out, int* scratch, void* stream) {
  if (count < 1 || count > HEALTH_MAX_SEGS) return (int)cudaErrorInvalidValue;
  HealthSegs segs;
  long long vecs = 0;
  for (int s = 0; s < HEALTH_MAX_SEGS; ++s) {
    const bool on = s < count;
    segs.ptr[s] = on ? ptrs[s] : nullptr;
    segs.n[s] = on ? ns[s] : 0;
    segs.bf16[s] = on ? bf16[s] : 0;
    segs.group[s] = on ? groups[s] : 0;
    if (on) vecs += (ns[s] * (bf16[s] ? 2 : 4) + 15) / 16;
  }
  segs.count = count;
  long long blocks = (vecs + HEALTH_THREADS * HEALTH_UNROLL - 1) / (HEALTH_THREADS * HEALTH_UNROLL);
  if (blocks < 1) blocks = 1;
  if (blocks > HEALTH_MAX_BLOCKS) blocks = HEALTH_MAX_BLOCKS;
  unsigned int* done = reinterpret_cast<unsigned int*>(scratch + 2 * HEALTH_MAX_BLOCKS);
  health_flags_kernel<<<(unsigned)blocks, HEALTH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      segs, stall, out, scratch, done);
  return (int)cudaGetLastError();
}
