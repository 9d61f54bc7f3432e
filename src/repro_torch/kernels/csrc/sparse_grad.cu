// K5: the sampled scores over the block-ELL layout (replaces the Pallas
// kernel at src/repro/kernels/sparse_grad/sparse_grad.py:87, entry
// sparse_sampled_scores at :64). See kernels/sparse_grad.py for the bound
// and the design.
//
// Both kernels carry a lane axis (batched delta lanes) in their LANES
// instantiation: row y of the grid scores lane lane_ids[y], whose
// residual, ids and scores lie a stride past lane 0's; the values and rows
// are shared. A feature's score does not depend on which warp or block
// computes it, so each lane's scores have the bits of a one-lane launch on
// its inputs. The one-lane instantiation compiles none of the lane code.
#include <type_traits>

#include "common.cuh"

// The lanes of a launch: the ids of the lanes that run and their operands'
// strides (unused by a one-lane launch).
struct LaneArgs {
  const int* lane_ids;
  long long r_stride, blk_stride, sc_stride;
};

// One 4-byte asynchronous copy (sm_80's cp.async), for a source that is
// not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

constexpr int SG_THREADS = 512;

// The sampled feature of score position j: blk[j / bs] * bs + j % bs
// (width 1: blk[j]).
__device__ __forceinline__ long long sampled_feature(const long long* __restrict__ blk,
                                                     long long j, int bs) {
  return bs == 1 ? blk[j] : blk[j / bs] * bs + j % bs;
}

// Where no ring fits (bf16 values, or a residual too long for shared
// memory beside the ring): one warp per sampled feature
// (warp_slot_score: a feature outside [0, n_feat) scores 0). A persistent
// grid: each block stages r once (when it fits), then its warps stride
// over the sampled features.
//
// OWNED (a rank's tile of a mesh): values and rows hold the n_feat local
// features of the global range [off, off + n_feat); blk holds global ids.
// An owned feature scores its local feature, any other writes +0.0 (the
// reference's masked K5 call, distributed/backend.py:110-130).
template <typename T, bool LANES, bool OWNED = false>
__global__ void __launch_bounds__(SG_THREADS)
sparse_sampled_scores_kernel(const T* __restrict__ values, const int* __restrict__ rows,
                             const float* __restrict__ r, const long long* __restrict__ blk,
                             float* __restrict__ scores, long long n, int bs, int nnz_max,
                             long long n_feat, int m, int staged, LaneArgs lanes,
                             long long off) {
  extern __shared__ __align__(16) float rs[];
  if constexpr (LANES) {  // this block's lane's operands
    const long long l = lanes.lane_ids[blockIdx.y];
    r += l * lanes.r_stride;
    blk += l * lanes.blk_stride;
    scores += l * lanes.sc_stride;
  }
  const float* v = r;
  if (staged) {
    stage(rs, r, m);
    v = rs;
  }
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (SG_THREADS / 32);
  for (long long j = (long long)blockIdx.x * (SG_THREADS / 32) + (threadIdx.x >> 5); j < n;
       j += nwarps) {
    const long long f = sampled_feature(blk, j, bs) - (OWNED ? off : 0);
    const float score = warp_slot_score<T>(values, rows, f, n_feat, nnz_max, v, lane);
    if (lane == 0) scores[j] = OWNED && (f < 0 || f >= n_feat) ? 0.f : score;
  }
}

// f32 values where a ring fits: one block of 1024 threads an SM; each warp
// takes a contiguous run [lo, lo + n) of the n_total score positions and
// streams its features, two at a time, through its ring (common.cuh's
// SlotRing, K7's scoring), the first pieces in flight while the residual
// is staged. Lane 0 of each half writes its feature's score.
struct SampledIds {  // feature f of a warp's run: the sampled feature of position lo + f
  const long long* blk;
  long long lo;
  int bs;
  __device__ __forceinline__ long long operator()(int f) const {
    return sampled_feature(blk, lo + f, bs);
  }
};

// OWNED: the local feature of an owned global id, -1 (scored 0 without a
// read) for any other.
struct OwnedIds {
  const long long* blk;
  long long lo, off, n_feat;
  int bs;
  __device__ __forceinline__ long long operator()(int f) const {
    const long long loc = sampled_feature(blk, lo + f, bs) - off;
    return loc >= 0 && loc < n_feat ? loc : -1;
  }
};

template <int NT, bool LANES, bool OWNED = false>
__global__ void __launch_bounds__(1024, 1)
sparse_ring_scores_kernel(const float* __restrict__ values, const int* __restrict__ rows,
                          const float* __restrict__ r, const long long* __restrict__ blk,
                          float* __restrict__ scores, long long n_total, int bs, int nnz_max,
                          long long n_feat, int m, int stride, LaneArgs lanes,
                          long long off) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (LANES) {  // this block's lane's operands
    const long long l = lanes.lane_ids[blockIdx.y];
    r += l * lanes.r_stride;
    blk += l * lanes.blk_stride;
    scores += l * lanes.sc_stride;
  }
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long nw = (long long)gridDim.x * RING_WARPS;
  const long long gw = (long long)blockIdx.x * RING_WARPS + warp;
  const long long lo = gw * n_total / nw;
  const int n = (int)((gw + 1) * n_total / nw - lo);
  // the residual by 16-byte cp.async, one group committed before the ring's
  // (the prologue's first wait completes it); zero-filled past m. A lane's
  // residual past lane 0 may not start on 16 bytes (m odd): 4-byte copies.
  float* rs = smem;
  if (!LANES || reinterpret_cast<uintptr_t>(r) % 16 == 0) {
    for (int c = tid; c < (m + 3) / 4; c += 1024)
      cp_async16_n(rs + 4 * c, r + 4 * c, 4 * min(4, m - 4 * c));
  } else {
    for (int k = tid; k < m; k += 1024) cp_async4(rs + k, r + k);
    if (tid < ((m + 3) & ~3) - m) rs[m + tid] = 0.f;
  }
  cp_async_commit();
  using Ids = typename std::conditional<OWNED, OwnedIds, SampledIds>::type;
  Ids ids;
  if constexpr (OWNED)
    ids = OwnedIds{blk, lo, off, n_feat, bs};
  else
    ids = SampledIds{blk, lo, bs};
  SlotRing<NT, Ids> ring(values, rows, n_feat, nnz_max, stride, smem + ((m + 3) & ~3), ids, n,
                         1);
  ring.prologue();
  __syncthreads();  // every thread's share of the residual
  for (int pi = 0; pi < ring.npairs; ++pi) {
    const float sc = ring.score_pair(rs);
    const int f = 2 * pi + ring.h;
    if (ring.q == 0 && f < n) {
      if constexpr (OWNED)
        scores[lo + f] = ids(f) < 0 ? 0.f : sc;
      else
        scores[lo + f] = sc;
    }
  }
  cp_async_wait<0>();
}

// A lane's blocks when n_run lanes share a resident grid of `resident`
// blocks: an equal share of it, at least one, and no more than the
// `needed` of one lane (one lane: min(needed, resident), as before).
static int lane_share(int resident, long long needed, int n_run) {
  const int share = resident / n_run < 1 ? 1 : resident / n_run;
  return (int)(needed < share ? needed : share);
}

template <typename T, bool LANES, bool OWNED = false>
static int launch_warps(const void* values, const int* rows, const float* r,
                        const long long* blk, float* scores, long long n, int bs, int nnz_max,
                        long long n_feat, int m, LaneArgs lanes, int n_run, cudaStream_t s,
                        long long off = 0) {
  static GridCache cache;
  const int staged = (size_t)m * sizeof(float) <= OPTIN_SMEM_BYTES;
  const size_t smem = staged ? (size_t)m * sizeof(float) : 0;
  const long long needed = (n + SG_THREADS / 32 - 1) / (SG_THREADS / 32);
  int blocks = 0;
  cudaError_t err = resident_grid(sparse_sampled_scores_kernel<T, LANES, OWNED>, SG_THREADS,
                                  smem, LLONG_MAX, &cache, &blocks);
  if (err != cudaSuccess) return (int)err;
  blocks = lane_share(blocks, needed, n_run);
  sparse_sampled_scores_kernel<T, LANES, OWNED><<<dim3(blocks, n_run), SG_THREADS, smem, s>>>(
      static_cast<const T*>(values), rows, r, blk, scores, n, bs, nnz_max, n_feat, m, staged,
      lanes, off);
  return (int)cudaGetLastError();
}

// About 8 features a warp at the least: a block stages the whole residual,
// which is not worth it for fewer.
constexpr long long RING_FEATURES_PER_BLOCK = RING_WARPS * 8;

template <bool LANES, bool OWNED = false>
static int launch_ring(const float* values, const int* rows, const float* r,
                       const long long* blk, float* scores, long long n, int bs, int nnz_max,
                       long long n_feat, int m, int slots, int stride, LaneArgs lanes,
                       int n_run, cudaStream_t s, long long off = 0) {
  static GridCache caches[4];
  if (!ring_plan_ok(nnz_max, slots, stride)) return (int)cudaErrorInvalidValue;
  const size_t smem = ring_smem_bytes(m, stride);
  if (smem > OPTIN_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const int nt = (slots + 31) / 32;
  const void* kernels[] = {(const void*)sparse_ring_scores_kernel<1, LANES, OWNED>,
                           (const void*)sparse_ring_scores_kernel<2, LANES, OWNED>,
                           (const void*)sparse_ring_scores_kernel<3, LANES, OWNED>,
                           (const void*)sparse_ring_scores_kernel<4, LANES, OWNED>};
  const long long needed = (n + RING_FEATURES_PER_BLOCK - 1) / RING_FEATURES_PER_BLOCK;
  int blocks = 0;
  cudaError_t err =
      resident_grid(kernels[nt - 1], 1024, smem, LLONG_MAX, &caches[nt - 1], &blocks);
  if (err != cudaSuccess) return (int)err;
  blocks = lane_share(blocks, needed, n_run);
  void* args[] = {&values, &rows,   &r, &blk,    &scores, &n,     &bs,
                  &nnz_max, &n_feat, &m, &stride, &lanes,  &off};
  err = cudaLaunchKernel(kernels[nt - 1], dim3(blocks, n_run), dim3(1024), args, smem, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it again
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// depth 0: the warp-per-feature kernel; otherwise the ring kernel of
// `slots`-slot pieces a `stride` apart (f32 values only). lane_ids ==
// nullptr: one lane (n_run 1, the strides unused); otherwise row y of the
// grid scores lane lane_ids[y]: r every r_stride floats, blk every
// blk_stride ids (0: shared), scores every sc_stride floats.
extern "C" int sparse_sampled_scores_launch(const void* values, const int* rows, const float* r,
                                            const long long* blk, float* scores, long long n,
                                            int bs, int nnz_max, long long n_feat, int m,
                                            int depth, int slots, int stride,
                                            const int* lane_ids, int n_run, long long r_stride,
                                            long long blk_stride, long long sc_stride, int dtype,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_run < 0 || n_run > 65535 || (lane_ids == nullptr && n_run != 1))
    return (int)cudaErrorInvalidValue;
  if (n_run == 0) return (int)cudaSuccess;  // every lane frozen: nothing to score
  const LaneArgs lanes{lane_ids, r_stride, blk_stride, sc_stride};
  if (depth != 0) {
    if (depth != RING_DEPTH || dtype != DT_F32 || n > INT_MAX) return (int)cudaErrorInvalidValue;
    const float* v = static_cast<const float*>(values);
    return lane_ids == nullptr
               ? launch_ring<false>(v, rows, r, blk, scores, n, bs, nnz_max, n_feat, m, slots,
                                    stride, lanes, n_run, s)
               : launch_ring<true>(v, rows, r, blk, scores, n, bs, nnz_max, n_feat, m, slots,
                                   stride, lanes, n_run, s);
  }
  if (dtype == DT_F32)
    return lane_ids == nullptr
               ? launch_warps<float, false>(values, rows, r, blk, scores, n, bs, nnz_max, n_feat,
                                            m, lanes, n_run, s)
               : launch_warps<float, true>(values, rows, r, blk, scores, n, bs, nnz_max, n_feat,
                                           m, lanes, n_run, s);
  if (dtype == DT_BF16)
    return lane_ids == nullptr
               ? launch_warps<__nv_bfloat16, false>(values, rows, r, blk, scores, n, bs, nnz_max,
                                                    n_feat, m, lanes, n_run, s)
               : launch_warps<__nv_bfloat16, true>(values, rows, r, blk, scores, n, bs, nnz_max,
                                                   n_feat, m, lanes, n_run, s);
  return (int)cudaErrorInvalidValue;
}

// The OWNED instantiations of sparse_sampled_scores_launch (a rank's tile
// of n_feat local features, the global range [off, off + n_feat)): the
// same routes and arguments, blk holding global ids.
extern "C" int sparse_sampled_scores_owned_launch(
    const void* values, const int* rows, const float* r, const long long* blk, float* scores,
    long long n, int bs, int nnz_max, long long n_feat, int m, long long off, int depth,
    int slots, int stride, const int* lane_ids, int n_run, long long r_stride,
    long long blk_stride, long long sc_stride, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_run < 0 || n_run > 65535 || (lane_ids == nullptr && n_run != 1) || off < 0)
    return (int)cudaErrorInvalidValue;
  if (n_run == 0) return (int)cudaSuccess;
  const LaneArgs lanes{lane_ids, r_stride, blk_stride, sc_stride};
  if (depth != 0) {
    if (depth != RING_DEPTH || dtype != DT_F32 || n > INT_MAX) return (int)cudaErrorInvalidValue;
    const float* v = static_cast<const float*>(values);
    return lane_ids == nullptr
               ? launch_ring<false, true>(v, rows, r, blk, scores, n, bs, nnz_max, n_feat, m,
                                          slots, stride, lanes, n_run, s, off)
               : launch_ring<true, true>(v, rows, r, blk, scores, n, bs, nnz_max, n_feat, m,
                                         slots, stride, lanes, n_run, s, off);
  }
  if (dtype == DT_F32)
    return lane_ids == nullptr
               ? launch_warps<float, false, true>(values, rows, r, blk, scores, n, bs, nnz_max,
                                                  n_feat, m, lanes, n_run, s, off)
               : launch_warps<float, true, true>(values, rows, r, blk, scores, n, bs, nnz_max,
                                                 n_feat, m, lanes, n_run, s, off);
  if (dtype == DT_BF16)
    return lane_ids == nullptr
               ? launch_warps<__nv_bfloat16, false, true>(values, rows, r, blk, scores, n, bs,
                                                          nnz_max, n_feat, m, lanes, n_run, s,
                                                          off)
               : launch_warps<__nv_bfloat16, true, true>(values, rows, r, blk, scores, n, bs,
                                                         nnz_max, n_feat, m, lanes, n_run, s,
                                                         off);
  return (int)cudaErrorInvalidValue;
}
