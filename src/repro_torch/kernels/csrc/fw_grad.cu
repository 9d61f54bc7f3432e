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
// one-lane instantiation compiles none of the lane code. The lane argmax
// has a second route, argmax_lanes_cluster_kernel: one thread-block
// cluster a lane, its CTAs' winners reduced through distributed shared
// memory, with no ticket and no partials in device memory.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// scores[j] = -Xt[row_j] . r, row_j = blk[j / bs] * bs + j % bs, one warp per
// sampled row (warp_row_score: a row outside [0, p) scores 0).
//
// OWNED (a rank's tile of a mesh, the distributed backend): X holds the
// global rows [off, off + p) of the design and the sampled rows are
// global; an owned row scores against its local row row_j - off, any other
// writes +0.0, so a sum over the ranks that own the feature axis is each
// score (the reference's masked partial scores, distributed/backend.py:78-90).
template <typename T, bool LANES, bool OWNED = false>
__global__ void sampled_scores_kernel(const T* __restrict__ X, const float* __restrict__ r,
                                      const long long* __restrict__ blk,
                                      float* __restrict__ scores, long long p, int m,
                                      long long n, int bs, int staged, int vec,
                                      const int* __restrict__ lane_ids, long long r_stride,
                                      long long blk_stride, long long sc_stride,
                                      long long off) {
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
  if constexpr (OWNED) {
    const long long loc = row - off;
    if (loc < 0 || loc >= p) {
      if (lane == 0) scores[j] = 0.f;
      return;
    }
    const float score = warp_row_score<T>(X, loc, p, m, v, vec, lane);
    if (lane == 0) scores[j] = score;
  } else {
    const float score = warp_row_score<T>(X, row, p, m, v, vec, lane);
    if (lane == 0) scores[j] = score;
  }
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

// The support bitmap of a lane's beta, a row of two levels: the fine
// words (bit i % 32 of word i / 32 set wherever beta[i] may be nonzero, a
// superset), then the summary words (bit g % 32 of word g / 32 set where
// any of the coefficients [64 g, 64 g + 64) has its fine bit), each level
// a whole number of 16 bytes. Where a bit is clear, beta[i] is +-0,
// and with scale and l2 finite |raw + l2 * (scale * +-0)| is |raw| bit for
// bit, so the shift's gather is skipped. use_map says whether a lane may
// skip: a bitmap is given and scale and l2 are finite (scale * 0 is NaN
// for an infinite or NaN scale, and that NaN must win). The summary (8 KB
// a lane at p = 4,272,227) is staged in shared memory; the fine words
// (534 KB) are read only under a set summary bit. Only the cluster route
// reads and updates a bitmap.
constexpr int SUMMARY_SHIFT = 6;  // coefficients a summary bit covers: 64

__host__ __device__ constexpr long long support_fine_words(long long p) {
  return (p + 127) / 128 * 4;
}
__host__ __device__ constexpr long long support_summary_words(long long p) {
  return (((p + 63) >> SUMMARY_SHIFT) + 127) / 128 * 4;
}

// Bit idx of the summary words (in device or shared memory).
__device__ __forceinline__ bool summary_bit(const unsigned int* summary, long long idx) {
  const long long g = idx >> SUMMARY_SHIFT;
  return (summary[g >> 5] >> (g & 31)) & 1u;
}

__device__ __forceinline__ bool fine_bit(const unsigned int* __restrict__ support,
                                         long long idx) {
  return (__ldg(support + (idx >> 5)) >> (idx & 31)) & 1u;
}

// The winner's bits, fine and summary, set once the lane's scores were all
// read (a real index only): the tail writes beta[i_star] next.
__device__ __forceinline__ void mark_support(unsigned int* support, long long idx,
                                             long long p_valid) {
  if (support == nullptr || idx >= p_valid) return;
  const long long g = idx >> SUMMARY_SHIFT;
  atomicOr(support + (idx >> 5), 1u << (idx & 31));
  atomicOr(support + support_fine_words(p_valid) + (g >> 5), 1u << (g & 31));
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

// A candidate winner of the cluster route: the compared magnitude, the
// raw score, the selected score (a real index's: raw + l2 * (scale *
// beta[idx]) in the reference's op order), the position in the lane's
// sample order and the global index.
struct Cand {
  float mag;
  float raw;
  float sel;
  long long j;
  long long idx;
};

__device__ __forceinline__ Cand no_cand() { return Cand{-INFINITY, 0.f, 0.f, LLONG_MAX, 0}; }

// Warp-wide first max of the candidates under `better`; every lane ends
// with the winner and its payload.
__device__ __forceinline__ void warp_cand(Cand& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Cand x;
    x.mag = __shfl_xor_sync(0xffffffffu, c.mag, o);
    x.raw = __shfl_xor_sync(0xffffffffu, c.raw, o);
    x.sel = __shfl_xor_sync(0xffffffffu, c.sel, o);
    x.j = __shfl_xor_sync(0xffffffffu, c.j, o);
    x.idx = __shfl_xor_sync(0xffffffffu, c.idx, o);
    if (better(x.mag, x.j, c.mag, c.j)) c = x;
  }
}

// CTAs a cluster of the cluster route: 16, past the portable 8 (sm_90
// schedules up to 16; clusters of 8 measured slower)
constexpr int LANE_CLUSTER = 16;
constexpr int CL_QUADS = 1;  // quads of scores a thread has in flight
// the most summary bytes a CTA stages (the static shared memory beside them
// stays under the 48 KB a launch gets without an opt-in)
constexpr size_t CL_STAGE_BYTES = 40 * 1024;

// The halves of the cluster barrier: arrive (release, or relaxed where
// nothing written need be seen) and wait (acquire). Every thread of every
// CTA of the cluster takes part.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// i_star = -1, g_star = 0 (and g_sel = 0) for each of the n_lanes lanes
// that is not one of the n_run listed (a frozen lane); the block's threads
// share the lanes.
template <bool SHIFT>
__device__ __forceinline__ void write_frozen(const int* __restrict__ lane_ids, int n_run,
                                             int n_lanes, long long* __restrict__ i_star,
                                             float* __restrict__ g_star,
                                             float* __restrict__ g_sel) {
  for (int l = threadIdx.x; l < n_lanes; l += AM_THREADS) {
    if (!lane_listed(lane_ids, n_run, l)) {
      i_star[l] = -1;
      g_star[l] = 0.f;
      if constexpr (SHIFT) g_sel[l] = 0.f;
    }
  }
}

// The cluster route of the lane argmax (the LANES instantiation's
// function, bit for bit): cluster y (C = LANE_CLUSTER CTAs along x) reduces lane
// lane_ids[y]. CTA `rank` reduces the scores [rank * chunk, (rank + 1) *
// chunk) (chunk a multiple of 4; a CTA past n holds no candidate), a
// round of CL_QUADS quads of 4 a thread at a time (the rounds uniform in
// the CTA), with 16-byte loads of the scores (the rows start on 16 bytes)
// and, at block width 1 on a 16-byte aligned row, of the int64 ids; a
// round's loads are all issued before its bitmap words and beta gathers,
// and those before any comparison. With a bitmap, each CTA copies the
// lane's summary words into shared memory (cp.async, up to CL_STAGE_BYTES:
// stage_summary) while its first round's loads are in flight. Each
// thread keeps its winner's position, magnitude, raw and selected scores
// and index. A score whose shift the bitmap skips has sel = raw, the bits
// of raw + (+-0) while raw is neither 0 nor NaN; a raw score of 0 or NaN
// reads its beta (the sign of a zero shift, the NaN's payload), so every
// real winner's sel is the reference's; a masked winner (every index past
// p_valid) takes its sel from beta[p_valid - 1], read by rank 0. The
// barrier's first phase (arrived at the start, waited on after the CTA's
// reduction) makes sure every CTA runs before any writes to rank 0's
// shared memory: then each CTA writes its winner to slot `rank` of rank 0
// through distributed shared memory, and the second phase (release,
// acquire) makes them visible to rank 0, which reduces the C slots under
// `better`, writes the lane's outputs and sets the winner's bits of the
// lane's bitmap. The frozen lanes' (-1, 0, 0) are written by cluster 0's
// last CTA between its arrival and its wait; with n_run 0 the grid is one
// cluster whose first CTA does only that.
template <typename BT>
__global__ void __launch_bounds__(AM_THREADS, 2)
argmax_lanes_cluster_kernel(const float* __restrict__ scores, const long long* __restrict__ blk,
                            long long n, int bs, long long p_valid, long long chunk,
                            long long* __restrict__ i_star, float* __restrict__ g_star,
                            const int* __restrict__ lane_ids, int n_run, int n_lanes,
                            long long sc_stride, long long blk_stride, const void* beta_v,
                            long long beta_stride, const float* __restrict__ scale_p, float l2,
                            float* __restrict__ g_sel, unsigned int* support,
                            long long sup_stride, int stage_summary) {
  constexpr bool SHIFT = !std::is_void<BT>::value;
  using B = typename std::conditional<SHIFT, BT, float>::type;
  const B* beta = static_cast<const B*>(beta_v);
  extern __shared__ __align__(16) unsigned int summary_s[];
  __shared__ Cand warp_win[AM_WARPS];
  __shared__ Cand slots[LANE_CLUSTER];
  if ((int)blockIdx.y >= n_run) {  // n_run 0: one cluster, no barrier
    if (blockIdx.x == 0) write_frozen<SHIFT>(lane_ids, n_run, n_lanes, i_star, g_star, g_sel);
    return;
  }
  cluster_arrive_relaxed();  // phase 1: this CTA runs
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank(), C = cluster.num_blocks();
  const long long ln = lane_ids[blockIdx.y];
  scores += ln * sc_stride;
  blk += ln * blk_stride;
  float scale = 0.f;
  bool use_map = false, staged = false;
  const unsigned int* summary = nullptr;
  if constexpr (SHIFT) {
    beta += ln * beta_stride;
    if (support != nullptr) {
      support += ln * sup_stride;
      summary = support + support_fine_words(p_valid);
      if (stage_summary) {
        const int chunks = (int)(support_summary_words(p_valid) / 4);
        for (int k = threadIdx.x; k < chunks; k += AM_THREADS)
          cp_async16(summary_s + 4 * k, summary + 4 * k, true);
        cp_async_commit();
        summary = summary_s;
        staged = true;
      }
    }
    scale = scale_p[ln];
    use_map = support != nullptr && isfinite(scale) && isfinite(l2);
  }
  const long long j0 = (long long)rank * chunk;
  const long long j1 = j0 + chunk < n ? j0 + chunk : n;
  const bool vec_ids = bs == 1 && reinterpret_cast<uintptr_t>(blk + j0) % 16 == 0;
  constexpr long long STRIDE = 4 * AM_THREADS;
  Cand c = no_cand();
  for (long long jb = j0; jb < j1; jb += CL_QUADS * STRIDE) {  // the same rounds in the CTA
    const long long jr = jb + 4 * threadIdx.x;
    float s[CL_QUADS][4];
    long long id[CL_QUADS][4];
#pragma unroll
    for (int u = 0; u < CL_QUADS; ++u) {
      const long long j = jr + u * STRIDE;
      if (j + 4 <= j1) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(scores + j));
        s[u][0] = v.x; s[u][1] = v.y; s[u][2] = v.z; s[u][3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) s[u][k] = j + k < j1 ? __ldg(scores + j + k) : 0.f;
      }
      if (vec_ids && j + 4 <= j1) {
        const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(blk + j));
        const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(blk + j + 2));
        id[u][0] = a.x; id[u][1] = a.y; id[u][2] = b.x; id[u][3] = b.y;
      } else if (bs == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) id[u][k] = j + k < j1 ? __ldg(blk + j + k) : 0;
      } else if (j < j1) {  // block q = j / bs, offset r; n < 2^31 (the launcher's check)
        unsigned int q = (unsigned int)j / (unsigned int)bs;
        int r = (int)((unsigned int)j - q * (unsigned int)bs);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (r == bs) {
            r = 0;
            ++q;
          }
          id[u][k] = j + k < j1 ? __ldg(blk + q) * bs + r : 0;
          ++r;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) id[u][k] = 0;
      }
    }
    float mag[CL_QUADS][4], sel[CL_QUADS][4];
    if constexpr (SHIFT) {
      if (staged && jb == j0) {  // the first round: the summary has landed
        cp_async_wait<0>();
        __syncthreads();
      }
      // whether each score's shift needs beta: the summary bits first, then
      // the fine words they call for, then the gathers
      bool need[CL_QUADS][4];
#pragma unroll
      for (int u = 0; u < CL_QUADS; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool real = jr + u * STRIDE + k < j1 && id[u][k] < p_valid;
          need[u][k] = real && (!use_map || !(fabsf(s[u][k]) > 0.f) ||
                                summary_bit(summary, id[u][k]));
        }
      if (use_map) {
#pragma unroll
        for (int u = 0; u < CL_QUADS; ++u)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (need[u][k] && fabsf(s[u][k]) > 0.f) need[u][k] = fine_bit(support, id[u][k]);
      }
      float bv[CL_QUADS][4];
#pragma unroll
      for (int u = 0; u < CL_QUADS; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[u][k] = need[u][k] ? to_f32(__ldg(beta + id[u][k])) : 0.f;
#pragma unroll
      for (int u = 0; u < CL_QUADS; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sel[u][k] = need[u][k] ? __fadd_rn(s[u][k], __fmul_rn(l2, __fmul_rn(scale, bv[u][k])))
                                 : s[u][k];
          mag[u][k] = id[u][k] >= p_valid ? -1.0f : fabsf(sel[u][k]);
        }
    } else {
#pragma unroll
      for (int u = 0; u < CL_QUADS; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sel[u][k] = s[u][k];
          mag[u][k] = id[u][k] >= p_valid ? -1.0f : fabsf(s[u][k]);
        }
    }
#pragma unroll
    for (int u = 0; u < CL_QUADS; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long j = jr + u * STRIDE + k;
        if (j < j1 && better(mag[u][k], j, c.mag, c.j))
          c = Cand{mag[u][k], s[u][k], sel[u][k], j, id[u][k]};
      }
  }
  if (staged) cp_async_wait<0>();  // a CTA past n: its copy landed before it leaves
  // the CTA's winner, to warp 0
  warp_cand(c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_win[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < AM_WARPS ? warp_win[lane] : no_cand();
    warp_cand(c);
  }
  cluster_wait();  // phase 1 done: every CTA of the cluster runs
  if (threadIdx.x == 0) *cluster.map_shared_rank(&slots[rank], 0) = c;
  cluster_arrive();  // phase 2: this CTA's slot written
  if (blockIdx.y == 0 && rank == C - 1)
    write_frozen<SHIFT>(lane_ids, n_run, n_lanes, i_star, g_star, g_sel);
  cluster_wait();  // phase 2 done: rank 0 sees every slot
  if (rank == 0 && warp == 0) {
    c = lane < (int)C ? slots[lane] : no_cand();
    warp_cand(c);
    if (lane == 0) {
      i_star[ln] = c.idx;
      g_star[ln] = c.raw;
      if constexpr (SHIFT) {
        g_sel[ln] = c.idx < p_valid ? c.sel : shifted(c.raw, beta, p_valid - 1, scale, l2);
        mark_support(support, c.idx, p_valid);
      }
    }
  }
}

template <typename T, bool OWNED = false>
static void launch_scores(const void* X, const float* r, const long long* blk, float* scores,
                          long long p, int m, long long n, int bs, int staged,
                          const int* lane_ids, long long r_stride, long long blk_stride,
                          long long sc_stride, dim3 grid, int threads, size_t smem,
                          cudaStream_t s, long long off = 0) {
  const int vec = staged && rows_vectorizable<T>(X, m);
  if (lane_ids == nullptr)
    sampled_scores_kernel<T, false, OWNED><<<grid, threads, smem, s>>>(
        static_cast<const T*>(X), r, blk, scores, p, m, n, bs, staged, vec, nullptr, 0, 0, 0,
        off);
  else
    sampled_scores_kernel<T, true, OWNED><<<grid, threads, smem, s>>>(
        static_cast<const T*>(X), r, blk, scores, p, m, n, bs, staged, vec, lane_ids, r_stride,
        blk_stride, sc_stride, off);
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

// The OWNED instantiation of sampled_scores_launch (a rank's tile): X is
// the tile of p_local rows starting at global row `off`; blk holds global
// ids; an unowned position scores +0.0.
extern "C" int sampled_scores_owned_launch(const void* X, const float* r, const long long* blk,
                                           float* scores, long long p_local, int m, long long n,
                                           int bs, long long off, const int* lane_ids,
                                           int n_run, long long r_stride, long long blk_stride,
                                           long long sc_stride, int dtype, void* stream) {
  const int threads = 256;
  const int rows_per_block = threads / 32;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (n_run < 0 || n_run > 65535 || (lane_ids == nullptr && n_run != 1) || off < 0)
    return (int)cudaErrorInvalidValue;
  if (n_run == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)blocks, (unsigned)n_run);
  const int staged = (size_t)m * sizeof(float) <= STAGE_LIMIT_BYTES;
  const size_t smem = staged ? (size_t)m * sizeof(float) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    launch_scores<float, true>(X, r, blk, scores, p_local, m, n, bs, staged, lane_ids, r_stride,
                               blk_stride, sc_stride, grid, threads, smem, s, off);
  } else if (dtype == DT_BF16) {
    launch_scores<__nv_bfloat16, true>(X, r, blk, scores, p_local, m, n, bs, staged, lane_ids,
                                       r_stride, blk_stride, sc_stride, grid, threads, smem, s,
                                       off);
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

// The shift's arguments, shared by both routes: beta (nullptr: no shift)
// of dtype beta_dtype, scale and g_sel; a support bitmap (the cluster
// route's) only with a shift, sup_stride >= its words a lane.
static bool shift_args_ok(const void* beta, int beta_dtype, const float* scale,
                          const float* g_sel, long long p_valid, const unsigned int* support,
                          long long sup_stride) {
  if (beta == nullptr) return support == nullptr;
  const long long words = support_fine_words(p_valid) + support_summary_words(p_valid);
  return scale != nullptr && g_sel != nullptr && p_valid >= 1 &&
         (beta_dtype == DT_F32 || beta_dtype == DT_BF16) &&
         (support == nullptr || sup_stride >= words);
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
  if (!shift_args_ok(beta, beta_dtype, scale, g_sel, p_valid, nullptr, 0))
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

template <typename BT>
static cudaError_t launch_cluster(dim3 grid, cudaStream_t s, const float* scores,
                                  const long long* blk, long long n, int bs, long long p_valid,
                                  long long chunk, long long* i_star, float* g_star,
                                  const int* lane_ids, int n_run, int n_lanes,
                                  long long sc_stride, long long blk_stride, const void* beta,
                                  long long beta_stride, const float* scale, float l2,
                                  float* g_sel, unsigned int* support, long long sup_stride,
                                  int stage_summary, size_t smem) {
  auto* kernel = argmax_lanes_cluster_kernel<BT>;
  static bool allowed[64] = {};  // the non-portable cluster size, allowed once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (dev < 64) allowed[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)LANE_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(AM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, scores, blk, n, bs, p_valid, chunk, i_star, g_star,
                            lane_ids, n_run, n_lanes, sc_stride, blk_stride, beta, beta_stride,
                            scale, l2, g_sel, support, sup_stride, stage_summary);
}

// The cluster route of the lane argmax: a grid of (LANE_CLUSTER,
// max(n_run, 1)) CTAs in clusters of LANE_CLUSTER along x, cluster y
// reducing lane lane_ids[y] in LANE_CLUSTER ranges of a multiple of 4
// scores (n < 2^31); scores every sc_stride floats (a multiple of 4, the
// base on 16 bytes), blk every blk_stride ids (0: shared). The shift,
// g_sel as vertex_argmax_launch's; support (a shift only; nullptr: none):
// the lanes' bitmaps, a row every sup_stride words, their summary words
// staged in shared memory where they fit in CL_STAGE_BYTES and the rows
// lie on 16 bytes. A refused cluster launch returns its error (no other
// route is taken).
extern "C" int vertex_argmax_lanes_cluster_launch(
    const float* scores, const long long* blk, long long n, int bs, long long p_valid,
    long long* i_star, float* g_star, const int* lane_ids, int n_run, int n_lanes,
    long long sc_stride, long long blk_stride, const void* beta, long long beta_stride,
    int beta_dtype, const float* scale, float l2, float* g_sel, unsigned int* support,
    long long sup_stride, void* stream) {
  if (n < 1 || n >= (1LL << 31) || bs < 1) return (int)cudaErrorInvalidValue;
  if (lane_ids == nullptr || n_run < 0 || n_run > 65535 || n_lanes < n_run ||
      sc_stride % 4 != 0 || reinterpret_cast<uintptr_t>(scores) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (!shift_args_ok(beta, beta_dtype, scale, g_sel, p_valid, support, sup_stride))
    return (int)cudaErrorInvalidValue;
  const long long chunk = (n + 4 * LANE_CLUSTER - 1) / (4 * LANE_CLUSTER) * 4;
  const dim3 grid((unsigned int)LANE_CLUSTER, n_run > 0 ? (unsigned int)n_run : 1u);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t summary_bytes = (size_t)support_summary_words(p_valid) * 4;
  const int stage = support != nullptr && summary_bytes <= CL_STAGE_BYTES &&
                    sup_stride % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(support) % 16 == 0;
  const size_t smem = stage ? summary_bytes : 0;
#define REPRO_CLUSTER(BT)                                                                   \
  launch_cluster<BT>(grid, s, scores, blk, n, bs, p_valid, chunk, i_star, g_star, lane_ids, \
                     n_run, n_lanes, sc_stride, blk_stride, beta, beta_stride, scale, l2,   \
                     g_sel, support, sup_stride, stage, smem)
  cudaError_t e;
  if (beta == nullptr)
    e = REPRO_CLUSTER(void);
  else if (beta_dtype == DT_F32)
    e = REPRO_CLUSTER(float);
  else
    e = REPRO_CLUSTER(__nv_bfloat16);
#undef REPRO_CLUSTER
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
