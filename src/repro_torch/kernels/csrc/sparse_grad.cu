// K5: the sampled scores over the block-ELL layout (replaces the Pallas
// kernel at src/repro/kernels/sparse_grad/sparse_grad.py:87, entry
// sparse_sampled_scores at :64). See kernels/sparse_grad.py for the bound
// and the design.
#include "common.cuh"

constexpr int SG_THREADS = 512;

// scores[j] = -z_f . r with f = blk[j / bs] * bs + j % bs, one warp per
// sampled feature (warp_slot_score: a feature outside [0, n_feat) scores
// 0). A persistent grid: each block stages r once, then its warps stride
// over the sampled features.
template <typename T>
__global__ void __launch_bounds__(SG_THREADS)
sparse_sampled_scores_kernel(const T* __restrict__ values, const int* __restrict__ rows,
                             const float* __restrict__ r, const long long* __restrict__ blk,
                             float* __restrict__ scores, long long n, int bs, int nnz_max,
                             long long n_feat, int m, int staged) {
  extern __shared__ __align__(16) float rs[];
  const float* v = r;
  if (staged) {
    stage(rs, r, m);
    v = rs;
  }
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (SG_THREADS / 32);
  for (long long j = (long long)blockIdx.x * (SG_THREADS / 32) + (threadIdx.x >> 5); j < n;
       j += nwarps) {
    const long long f = blk[j / bs] * bs + j % bs;
    const float score = warp_slot_score<T>(values, rows, f, n_feat, nnz_max, v, lane);
    if (lane == 0) scores[j] = score;
  }
}

template <typename T>
static int launch(const void* values, const int* rows, const float* r, const long long* blk,
                  float* scores, long long n, int bs, int nnz_max, long long n_feat, int m,
                  cudaStream_t s) {
  static GridCache cache;
  const int staged = (size_t)m * sizeof(float) <= OPTIN_SMEM_BYTES;
  const size_t smem = staged ? (size_t)m * sizeof(float) : 0;
  const long long needed = (n + SG_THREADS / 32 - 1) / (SG_THREADS / 32);
  int blocks = 0;
  cudaError_t err = resident_grid(sparse_sampled_scores_kernel<T>, SG_THREADS, smem, needed,
                                  &cache, &blocks);
  if (err != cudaSuccess) return (int)err;
  sparse_sampled_scores_kernel<T><<<blocks, SG_THREADS, smem, s>>>(
      static_cast<const T*>(values), rows, r, blk, scores, n, bs, nnz_max, n_feat, m, staged);
  return (int)cudaGetLastError();
}

extern "C" int sparse_sampled_scores_launch(const void* values, const int* rows, const float* r,
                                            const long long* blk, float* scores, long long n,
                                            int bs, int nnz_max, long long n_feat, int m,
                                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(values, rows, r, blk, scores, n, bs, nnz_max, n_feat, m, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(values, rows, r, blk, scores, n, bs, nnz_max, n_feat, m, s);
  return (int)cudaErrorInvalidValue;
}
