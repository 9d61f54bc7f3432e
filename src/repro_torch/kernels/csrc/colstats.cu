// K1: the setup pass over the design matrix, zty = Xt @ y and
// znorm2[i] = ||Xt[i]||^2 in one sweep (replaces the Pallas kernel at
// src/repro/kernels/colstats/colstats.py:54). See kernels/colstats.py for
// the bound and the design.
#include "common.cuh"

template <typename T>
__global__ void colstats_kernel(const T* __restrict__ X, const float* __restrict__ y,
                                float* __restrict__ zty, float* __restrict__ zn2,
                                long long p, int m, int staged, int vec) {
  extern __shared__ __align__(16) float ys[];
  const float* v = y;
  if (staged) {
    stage(ys, y, m);
    v = ys;
  }
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= p) return;  // no padding copy: rows past p are not in the grid
  float dot = 0.f, sq = 0.f;
  row_dot<T, true>(X + row * m, v, m, vec, lane, dot, sq);
  dot = warp_sum(dot);
  sq = warp_sum(sq);
  if (lane == 0) {
    zty[row] = dot;
    zn2[row] = sq;
  }
}

extern "C" int colstats_launch(const void* X, const float* y, float* zty, float* zn2,
                               long long p, int m, int dtype, void* stream) {
  const int threads = 256;
  const int rows_per_block = threads / 32;
  const long long blocks = (p + rows_per_block - 1) / rows_per_block;
  const int staged = (size_t)m * sizeof(float) <= STAGE_LIMIT_BYTES;
  const size_t smem = staged ? (size_t)m * sizeof(float) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    const int vec = staged && rows_vectorizable<float>(X, m);
    colstats_kernel<float><<<(unsigned)blocks, threads, smem, s>>>(
        static_cast<const float*>(X), y, zty, zn2, p, m, staged, vec);
  } else if (dtype == DT_BF16) {
    const int vec = staged && rows_vectorizable<__nv_bfloat16>(X, m);
    colstats_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(X), y, zty, zn2, p, m, staged, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
