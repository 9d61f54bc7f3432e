// K6: the setup pass over the block-ELL layout, zty = sum vals * y[rows]
// and znorm2 = sum vals^2 per feature in one sweep (replaces the Pallas
// kernel at src/repro/kernels/sparse_colstats/sparse_colstats.py:55, entry
// sparse_colstats_fused at :64). See kernels/sparse_colstats.py for the
// bound and the design.
#include "common.cuh"

constexpr int SC_THREADS = 512;

// One warp per feature of [0, p) (the padded tail is not in the work), a
// persistent grid: each block stages y once, then its warps stride over
// the features.
template <typename T>
__global__ void __launch_bounds__(SC_THREADS)
sparse_colstats_kernel(const T* __restrict__ values, const int* __restrict__ rows,
                       const float* __restrict__ y, float* __restrict__ zty,
                       float* __restrict__ zn2, long long p, int nnz_max, int m, int staged) {
  extern __shared__ __align__(16) float ys[];
  const float* v = y;
  if (staged) {
    stage(ys, y, m);
    v = ys;
  }
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (SC_THREADS / 32);
  for (long long f = (long long)blockIdx.x * (SC_THREADS / 32) + (threadIdx.x >> 5); f < p;
       f += nwarps) {
    float dot = 0.f, sq = 0.f;
    slot_dot<T, true>(values, rows, f, nnz_max, v, lane, dot, sq);
    dot = warp_sum(dot);
    sq = warp_sum(sq);
    if (lane == 0) {
      zty[f] = dot;
      zn2[f] = sq;
    }
  }
}

template <typename T>
static int launch(const void* values, const int* rows, const float* y, float* zty, float* zn2,
                  long long p, int nnz_max, int m, cudaStream_t s) {
  static GridCache cache;
  const int staged = (size_t)m * sizeof(float) <= OPTIN_SMEM_BYTES;
  const size_t smem = staged ? (size_t)m * sizeof(float) : 0;
  const long long needed = (p + SC_THREADS / 32 - 1) / (SC_THREADS / 32);
  int blocks = 0;
  cudaError_t err = resident_grid(sparse_colstats_kernel<T>, SC_THREADS, smem, needed,
                                  &cache, &blocks);
  if (err != cudaSuccess) return (int)err;
  sparse_colstats_kernel<T><<<blocks, SC_THREADS, smem, s>>>(
      static_cast<const T*>(values), rows, y, zty, zn2, p, nnz_max, m, staged);
  return (int)cudaGetLastError();
}

extern "C" int sparse_colstats_launch(const void* values, const int* rows, const float* y,
                                      float* zty, float* zn2, long long p, int nnz_max, int m,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(values, rows, y, zty, zn2, p, nnz_max, m, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(values, rows, y, zty, zn2, p, nnz_max, m, s);
  return (int)cudaErrorInvalidValue;
}
