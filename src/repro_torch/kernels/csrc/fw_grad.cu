// K2: the sampled linear-minimization oracle. sampled_scores replaces the
// Pallas kernel at src/repro/kernels/fw_grad/fw_grad.py:79; vertex_argmax
// replaces the XLA argmax of fw_vertex (src/repro/kernels/fw_grad/ops.py:27).
// See kernels/fw_grad.py for the bound and the design.
#include "common.cuh"

// scores[j] = -Xt[row_j] . r, row_j = blk[j / bs] * bs + j % bs, one warp per
// sampled row (warp_row_score: a row outside [0, p) scores 0).
template <typename T>
__global__ void sampled_scores_kernel(const T* __restrict__ X, const float* __restrict__ r,
                                      const long long* __restrict__ blk,
                                      float* __restrict__ scores, long long p, int m,
                                      long long n, int bs, int staged, int vec) {
  extern __shared__ __align__(16) float rs[];
  const float* v = r;
  if (staged) {
    stage(rs, r, m);
    v = rs;
  }
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= n) return;
  const long long row = blk[j / bs] * bs + j % bs;
  const float score = warp_row_score<T>(X, row, p, m, v, vec, lane);
  if (lane == 0) scores[j] = score;
}

// One block: i_star = the global index of the first max of |scores|, with
// indices >= p_valid masked to -1; g_star = its score.
__global__ void vertex_argmax_kernel(const float* __restrict__ scores,
                                     const long long* __restrict__ blk, long long n, int bs,
                                     long long p_valid, long long* __restrict__ i_star,
                                     float* __restrict__ g_star) {
  __shared__ float sb[32];
  __shared__ long long sj[32];
  float best = -INFINITY;
  long long bj = LLONG_MAX;
  for (long long j = threadIdx.x; j < n; j += blockDim.x) {
    const long long idx = blk[j / bs] * bs + j % bs;
    const float mag = idx < p_valid ? fabsf(scores[j]) : -1.0f;
    if (better(mag, j, best, bj)) {
      best = mag;
      bj = j;
    }
  }
  float unused = 0.f;
  warp_best(best, bj, unused);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sb[warp] = best;
    sj[warp] = bj;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    best = lane < nw ? sb[lane] : -INFINITY;
    bj = lane < nw ? sj[lane] : LLONG_MAX;
    warp_best(best, bj, unused);
    if (lane == 0) {
      *i_star = blk[bj / bs] * bs + bj % bs;
      *g_star = scores[bj];
    }
  }
}

extern "C" int sampled_scores_launch(const void* X, const float* r, const long long* blk,
                                     float* scores, long long p, int m, long long n, int bs,
                                     int dtype, void* stream) {
  const int threads = 256;
  const int rows_per_block = threads / 32;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const int staged = (size_t)m * sizeof(float) <= STAGE_LIMIT_BYTES;
  const size_t smem = staged ? (size_t)m * sizeof(float) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    const int vec = staged && rows_vectorizable<float>(X, m);
    sampled_scores_kernel<float><<<(unsigned)blocks, threads, smem, s>>>(
        static_cast<const float*>(X), r, blk, scores, p, m, n, bs, staged, vec);
  } else if (dtype == DT_BF16) {
    const int vec = staged && rows_vectorizable<__nv_bfloat16>(X, m);
    sampled_scores_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(X), r, blk, scores, p, m, n, bs, staged, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int vertex_argmax_launch(const float* scores, const long long* blk, long long n,
                                    int bs, long long p_valid, long long* i_star, float* g_star,
                                    void* stream) {
  vertex_argmax_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, blk, n, bs, p_valid, i_star, g_star);
  return (int)cudaGetLastError();
}
