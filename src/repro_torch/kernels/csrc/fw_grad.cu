// K2: the sampled linear-minimization oracle. sampled_scores replaces the
// Pallas kernel at src/repro/kernels/fw_grad/fw_grad.py:79; vertex_argmax
// replaces the XLA argmax of fw_vertex (src/repro/kernels/fw_grad/ops.py:27).
// See kernels/fw_grad.py for the bound and the design.
//
// Both kernels carry a lane axis (batched delta lanes, the counterpart of
// the reference's vmapped pallas_call) in their LANES instantiation:
// blockIdx.y runs lane lane_ids[blockIdx.y], whose operands lie a stride of
// elements past lane 0's (a stride of 0 shares an operand among the
// lanes). A lane's blocks compute exactly what a one-lane launch on that
// lane's operands computes, so each lane's result has its bits. The
// one-lane instantiation compiles none of the lane code.
#include "common.cuh"

// scores[j] = -Xt[row_j] . r, row_j = blk[j / bs] * bs + j % bs, one warp per
// sampled row (warp_row_score: a row outside [0, p) scores 0).
template <typename T, bool LANES>
__global__ void sampled_scores_kernel(const T* __restrict__ X, const float* __restrict__ r,
                                      const long long* __restrict__ blk,
                                      float* __restrict__ scores, long long p, int m,
                                      long long n, int bs, int staged, int vec,
                                      const int* __restrict__ lane_ids, long long r_stride,
                                      long long blk_stride, long long sc_stride) {
  extern __shared__ __align__(16) float rs[];
  if constexpr (LANES) {
    const long long ln = lane_ids[blockIdx.y];
    r += ln * r_stride;
    blk += ln * blk_stride;
    scores += ln * sc_stride;
  }
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

constexpr int AM_THREADS = 256;
constexpr int AM_WARPS = AM_THREADS / 32;

// The block-wide first max of (best, bj) under `better`, returned to
// thread 0 (the block's threads all take part).
__device__ __forceinline__ void block_best(float& best, long long& bj) {
  __shared__ float sb[AM_WARPS];
  __shared__ long long sj[AM_WARPS];
  float unused = 0.f;
  warp_best(best, bj, unused);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sb[warp] = best;
    sj[warp] = bj;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < AM_WARPS ? sb[lane] : -INFINITY;
    bj = lane < AM_WARPS ? sj[lane] : LLONG_MAX;
    warp_best(best, bj, unused);
  }
  __syncthreads();  // sb, sj free for the next call
}

// Whether lane l is one of the n listed lane ids.
__device__ __forceinline__ bool lane_listed(const int* __restrict__ lane_ids, int n, int l) {
  for (int k = 0; k < n; ++k)
    if (lane_ids[k] == l) return true;
  return false;
}

// The elastic-net's shifted score of index idx (< p_valid): raw +
// l2 * (scale * beta[idx]), in the reference's op order.
template <typename BT>
__device__ __forceinline__ float shifted(float raw, const BT* __restrict__ beta, long long idx,
                                         float scale, float l2) {
  return __fadd_rn(raw, __fmul_rn(l2, __fmul_rn(scale, to_f32(__ldg(beta + idx)))));
}

// i_star = the global index of the first max of |scores| (indices >=
// p_valid masked to -1), g_star = its score. Block b reduces the scores
// [b * chunk, (b + 1) * chunk) (chunk a multiple of 4) in quads of 4, 16
// bytes a load when `vec`; each thread walks the sampled blocks
// (sampled block q, offset r) by a fixed stride, with no division in the
// loop. The block's first max goes to part_best/part_j; the last block
// to finish (a ticket from `done`) reduces the partials under `better` and
// resets `done` to 0 for the next launch. `better` is a total order on
// (value, position), so the result does not depend on which block is last.
// With lanes, row y < n_run of the grid reduces lane lane_ids[y] with its
// own ticket done[y] and partials; block (0, 0) also writes i_star = -1
// and g_star = 0 for each of the n_lanes lanes that is not listed (a
// frozen lane, whose blocks are not launched; n_run 0: a grid of one block
// that only does that). With a shift (BT not void), the magnitude compared
// is |sel| (a masked index reads no beta), g_star is the winner's raw
// score and g_sel its sel, recomputed by the last block (the same bits;
// an index past p_valid, when every index is masked, reads beta[p_valid -
// 1] as the reference's clipped gather does); lane l's beta starts l *
// beta_stride elements in, its scale is scale[l].
template <bool LANES, typename BT>
__global__ void __launch_bounds__(AM_THREADS)
vertex_argmax_kernel(const float* __restrict__ scores, const long long* __restrict__ blk,
                     long long n, int bs, long long p_valid, long long chunk, int vec,
                     float* part_best, long long* part_j, unsigned int* done,
                     long long* __restrict__ i_star, float* __restrict__ g_star,
                     const int* __restrict__ lane_ids, int n_run, int n_lanes,
                     long long sc_stride, long long blk_stride, const void* beta_v,
                     long long beta_stride, const float* __restrict__ scale_p, float l2,
                     float* __restrict__ g_sel) {
  constexpr bool SHIFT = !std::is_void<BT>::value;
  using B = typename std::conditional<SHIFT, BT, float>::type;
  const B* beta = static_cast<const B*>(beta_v);
  __shared__ bool last;
  if constexpr (LANES) {
    if (blockIdx.x == 0 && blockIdx.y == 0) {
      for (int l = threadIdx.x; l < n_lanes; l += AM_THREADS) {
        if (!lane_listed(lane_ids, n_run, l)) {
          i_star[l] = -1;
          g_star[l] = 0.f;
          if constexpr (SHIFT) g_sel[l] = 0.f;
        }
      }
    }
    if ((int)blockIdx.y >= n_run) return;
    const long long ln = lane_ids[blockIdx.y];
    scores += ln * sc_stride;
    blk += ln * blk_stride;
    part_best += (size_t)blockIdx.y * gridDim.x;
    part_j += (size_t)blockIdx.y * gridDim.x;
    done += blockIdx.y;
    i_star += ln;
    g_star += ln;
    if constexpr (SHIFT) {
      beta += ln * beta_stride;
      scale_p += ln;
      g_sel += ln;
    }
  }
  float scale = 0.f;
  if constexpr (SHIFT) scale = *scale_p;
  const long long j0 = blockIdx.x * chunk;
  const long long j1 = j0 + chunk < n ? j0 + chunk : n;
  constexpr long long STRIDE = 4 * AM_THREADS;
  const long long step_q = STRIDE / bs;
  const int step_r = (int)(STRIDE % bs);
  long long j = j0 + 4 * threadIdx.x;
  long long q = j / bs;  // the sampled block of score j, and j's offset in it
  int r = (int)(j % bs);
  float best = -INFINITY;
  long long bj = LLONG_MAX;
  for (; j < j1; j += STRIDE) {
    float s[4];
    if (vec && j + 4 <= j1) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(scores + j));
      s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = j + c < j1 ? __ldg(scores + j + c) : 0.f;
    }
    long long qc = q;
    int rc = r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (rc == bs) {
        rc = 0;
        ++qc;
      }
      if (j + c < j1) {
        const long long idx = __ldg(blk + qc) * bs + rc;
        float mag = -1.0f;
        if (idx < p_valid) {
          if constexpr (SHIFT)
            mag = fabsf(shifted(s[c], beta, idx, scale, l2));
          else
            mag = fabsf(s[c]);
        }
        if (better(mag, j + c, best, bj)) {
          best = mag;
          bj = j + c;
        }
      }
      ++rc;
    }
    q += step_q;
    r += step_r;
    if (r >= bs) {
      r -= bs;
      ++q;
    }
  }
  block_best(best, bj);
  if (threadIdx.x == 0) {
    part_best[blockIdx.x] = best;
    part_j[blockIdx.x] = bj;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  best = -INFINITY;
  bj = LLONG_MAX;
  for (int b = threadIdx.x; b < gridDim.x; b += AM_THREADS) {
    const float ob = __ldcg(part_best + b);
    const long long oj = __ldcg(part_j + b);
    if (better(ob, oj, best, bj)) {
      best = ob;
      bj = oj;
    }
  }
  block_best(best, bj);
  if (threadIdx.x == 0) {
    const long long idx = blk[bj / bs] * bs + bj % bs;
    *i_star = idx;
    *g_star = scores[bj];
    if constexpr (SHIFT)
      *g_sel = shifted(scores[bj], beta, idx < p_valid ? idx : p_valid - 1, scale, l2);
    *done = 0;
  }
}

template <typename T>
static void launch_scores(const void* X, const float* r, const long long* blk, float* scores,
                          long long p, int m, long long n, int bs, int staged,
                          const int* lane_ids, long long r_stride, long long blk_stride,
                          long long sc_stride, dim3 grid, int threads, size_t smem,
                          cudaStream_t s) {
  const int vec = staged && rows_vectorizable<T>(X, m);
  if (lane_ids == nullptr)
    sampled_scores_kernel<T, false><<<grid, threads, smem, s>>>(
        static_cast<const T*>(X), r, blk, scores, p, m, n, bs, staged, vec, nullptr, 0, 0, 0);
  else
    sampled_scores_kernel<T, true><<<grid, threads, smem, s>>>(
        static_cast<const T*>(X), r, blk, scores, p, m, n, bs, staged, vec, lane_ids, r_stride,
        blk_stride, sc_stride);
}

// lane_ids == nullptr: one lane (the strides unused); otherwise n_run
// lanes, row y of the grid scoring lane lane_ids[y] of r (a row every
// r_stride floats), blk (every blk_stride ids; 0: shared) and scores
// (every sc_stride floats).
extern "C" int sampled_scores_launch(const void* X, const float* r, const long long* blk,
                                     float* scores, long long p, int m, long long n, int bs,
                                     const int* lane_ids, int n_run, long long r_stride,
                                     long long blk_stride, long long sc_stride, int dtype,
                                     void* stream) {
  const int threads = 256;
  const int rows_per_block = threads / 32;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (n_run < 0 || n_run > 65535 || (lane_ids == nullptr && n_run != 1))
    return (int)cudaErrorInvalidValue;
  if (n_run == 0) return (int)cudaSuccess;  // every lane frozen: nothing to score
  const dim3 grid((unsigned)blocks, (unsigned)n_run);
  const int staged = (size_t)m * sizeof(float) <= STAGE_LIMIT_BYTES;
  const size_t smem = staged ? (size_t)m * sizeof(float) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    launch_scores<float>(X, r, blk, scores, p, m, n, bs, staged, lane_ids, r_stride, blk_stride,
                         sc_stride, grid, threads, smem, s);
  } else if (dtype == DT_BF16) {
    launch_scores<__nv_bfloat16>(X, r, blk, scores, p, m, n, bs, staged, lane_ids, r_stride,
                                 blk_stride, sc_stride, grid, threads, smem, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool LANES, typename BT>
static void launch_argmax(dim3 grid, cudaStream_t s, const float* scores, const long long* blk,
                          long long n, int bs, long long p_valid, long long chunk, int vec,
                          float* part_best, long long* part_j, unsigned int* done,
                          long long* i_star, float* g_star, const int* lane_ids, int n_run,
                          int n_lanes, long long sc_stride, long long blk_stride,
                          const void* beta, long long beta_stride, const float* scale, float l2,
                          float* g_sel) {
  vertex_argmax_kernel<LANES, BT><<<grid, AM_THREADS, 0, s>>>(
      scores, blk, n, bs, p_valid, chunk, vec, part_best, part_j, done, i_star, g_star,
      lane_ids, n_run, n_lanes, sc_stride, blk_stride, beta, beta_stride, scale, l2, g_sel);
}

// scratch: the ticket counters (u32, 0 between launches), one a lane for
// lane_cap lanes, in whole 16-byte units; then lane_cap * blocks partial
// positions (int64) and as many partial values (f32). lane_ids ==
// nullptr: one lane (n_run 1, the strides unused); otherwise row y of the
// grid reduces lane lane_ids[y] of the n_lanes (scores every sc_stride
// floats, a multiple of 4; blk every blk_stride ids, 0: shared). beta ==
// nullptr: no shift; otherwise the elastic-net's shift with beta (of
// dtype beta_dtype, a row every beta_stride elements for lanes), the f32
// scale (one a lane) and l2, and the winners' selected scores in g_sel.
extern "C" int vertex_argmax_launch(const float* scores, const long long* blk, long long n,
                                    int bs, long long p_valid, int blocks, long long chunk,
                                    void* scratch, int lane_cap, long long* i_star,
                                    float* g_star, const int* lane_ids, int n_run, int n_lanes,
                                    long long sc_stride, long long blk_stride, const void* beta,
                                    long long beta_stride, int beta_dtype, const float* scale,
                                    float l2, float* g_sel, void* stream) {
  if (blocks < 1 || chunk % 4 != 0 || (blocks - 1) * chunk >= n || blocks * chunk < n)
    return (int)cudaErrorInvalidValue;
  if (n_run < 0 || n_run > lane_cap || n_run > 65535 || (lane_ids == nullptr && n_run != 1) ||
      (lane_ids != nullptr && (n_lanes < n_run || sc_stride % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  if (beta != nullptr && (scale == nullptr || g_sel == nullptr || p_valid < 1 ||
                          (beta_dtype != DT_F32 && beta_dtype != DT_BF16)))
    return (int)cudaErrorInvalidValue;
  unsigned int* done = static_cast<unsigned int*>(scratch);
  long long* part_j =
      reinterpret_cast<long long*>(static_cast<char*>(scratch) + 16 * ((lane_cap + 3) / 4));
  float* part_best = reinterpret_cast<float*>(part_j + (size_t)lane_cap * blocks);
  const int vec = reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  const dim3 grid(n_run > 0 ? blocks : 1, n_run > 0 ? n_run : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lanes = lane_ids != nullptr;
  const int n_l = lanes ? n_lanes : 1, n_r = lanes ? n_run : 1;
  const long long scs = lanes ? sc_stride : 0, bls = lanes ? blk_stride : 0;
#define REPRO_ARGMAX(L, BT)                                                                  \
  launch_argmax<L, BT>(grid, s, scores, blk, n, bs, p_valid, chunk, vec, part_best, part_j, \
                       done, i_star, g_star, lane_ids, n_r, n_l, scs, bls, beta, beta_stride, \
                       scale, l2, g_sel)
  if (beta == nullptr) {
    if (lanes)
      REPRO_ARGMAX(true, void);
    else
      REPRO_ARGMAX(false, void);
  } else if (beta_dtype == DT_F32) {
    if (lanes)
      REPRO_ARGMAX(true, float);
    else
      REPRO_ARGMAX(false, float);
  } else if (lanes) {
    REPRO_ARGMAX(true, __nv_bfloat16);
  } else {
    REPRO_ARGMAX(false, __nv_bfloat16);
  }
#undef REPRO_ARGMAX
  return (int)cudaGetLastError();
}
