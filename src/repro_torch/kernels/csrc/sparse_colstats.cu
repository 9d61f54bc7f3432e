// K6: the setup pass over the block-ELL layout, zty = sum vals * y[rows]
// and znorm2 = sum vals^2 per feature in one sweep (replaces the Pallas
// kernel at src/repro/kernels/sparse_colstats/sparse_colstats.py:55, entry
// sparse_colstats_fused at :44). See kernels/sparse_colstats.py for the
// bound, the design and the planner that picks the tile, the stages and
// the staging of y.
#include "common.cuh"

constexpr int SC_THREADS = 1024;
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int SC_MAX_STAGES = 8;

// The tile's row slots, 16 bytes (4 slots) at a time, fetched only where
// one of the 4 value slots beside them holds a nonzero (sign bit ignored):
// a skipped chunk reads as row 0, and its zero values add exact zeros.
template <typename T> __device__ __forceinline__ bool any_stored(const T* v4);
template <> __device__ __forceinline__ bool any_stored<float>(const float* v4) {
  const uint4 q = *reinterpret_cast<const uint4*>(v4);
  return ((q.x | q.y | q.z | q.w) & 0x7fffffffu) != 0;
}
template <> __device__ __forceinline__ bool any_stored<__nv_bfloat16>(const __nv_bfloat16* v4) {
  const uint2 q = *reinterpret_cast<const uint2*>(v4);
  return ((q.x | q.y) & 0x7fff7fffu) != 0;
}

// Wait until at most n (0-2) of this thread's row groups are pending.
__device__ __forceinline__ void wait_rows(int n) {
  if (n == 0) {
    cp_async_wait<0>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<2>();
  }
}

// One feature's sums by one warp in slot_dot's order, written by lane 0.
template <typename T>
__device__ __forceinline__ void feature_sums(const T* values, const int* rows, long long f,
                                             int nnz_max, const float* v, int lane, float* zty,
                                             float* zn2) {
  float dot = 0.f, sq = 0.f;
  slot_dot<T, true>(values, rows, f, nnz_max, v, lane, dot, sq);
  dot = warp_sum(dot);
  sq = warp_sum(sq);
  if (lane == 0) {
    zty[f] = dot;
    zn2[f] = sq;
  }
}

// One level of warp_sum's butterfly on the 2 * O partials left in s.
template <int O>
__device__ __forceinline__ void fold(float (&s)[16]) {
#pragma unroll
  for (int l = 0; l < O; ++l) s[l] = s[l] + s[l + O];
}

// warp_sum's butterfly, taken by one thread over the 32 lane partials
// a[0..31]: the same additions of the same operands, so the same bits.
__device__ __forceinline__ float tree_sum32(const float* a) {
  float s[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) s[l] = a[l] + a[l + 16];
  fold<8>(s);
  fold<4>(s);
  fold<2>(s);
  fold<1>(s);
  return s[0];
}

// Lane partials of a tile held in shared memory: warp k computes, for
// feature j = lane, lane + 32, ..., the partial that lane k of slot_dot
// would (slots k, k + 32, ... in order) and leaves it at part[j * 33 + k]
// (dot) and part[PS + j * 33 + k] (sq); 33 keeps the writes and the
// tree's reads free of bank conflicts. Four slots at a time: their values
// and rows first, then their y, then the fmas in slot order.
template <typename T>
__device__ __forceinline__ void tile_partials(const T* __restrict__ vs,
                                              const int* __restrict__ rs, int tile_feats,
                                              int nnz_max, const float* __restrict__ v, int lane,
                                              int k, float* __restrict__ part) {
  const int ps = tile_feats * 33;
  for (int j = lane; j < tile_feats; j += 32) {
    const int base = j * nnz_max;
    float dot = 0.f, sq = 0.f;
    for (int s0 = k; s0 < nnz_max; s0 += 4 * 32) {
      float x[4], g[4];
      int r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = s0 + 32 * u < nnz_max;
        x[u] = in ? to_f32(vs[base + s0 + 32 * u]) : 0.f;
        r[u] = in ? rs[base + s0 + 32 * u] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) g[u] = s0 + 32 * u < nnz_max ? v[r[u]] : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + 32 * u < nnz_max) {
          dot = fmaf(x[u], g[u], dot);
          sq = fmaf(x[u], x[u], sq);
        }
      }
    }
    part[j * 33 + k] = dot;
    part[ps + j * 33 + k] = sq;
  }
}

// A persistent grid of 32 warps a block. The first p / tile_feats *
// tile_feats features (tile_feats a multiple of 32) come in tiles; block
// b takes tiles b, b + grid, ... in turn. Tile i's values arrive by one
// bulk copy into value stage i % stages, started stages - lag - 1 tiles
// ahead; once they have landed, every thread fetches the tile's stored
// row chunks into row slot i % (lag + 1) (cp.async, one group a tile);
// `lag` tiles later the block takes the tile's lane partials
// (tile_partials, into one of two partial buffers), and one tile after
// that 2 * tile_feats / 32 warps add them, a thread a feature and a sum
// (tree_sum32), and write zty and znorm2 coalesced. One __syncthreads a
// tile orders it all; a stage or slot is refilled only after the
// __syncthreads that follows its last reader. The last p % tile_feats
// features (or all of them, tile_feats = 0) are summed from global
// memory, a warp a feature. STAGED: y is staged in shared memory.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(SC_THREADS)
sparse_colstats_kernel(const T* __restrict__ values, const int* __restrict__ rows,
                       const float* __restrict__ y, float* __restrict__ zty,
                       float* __restrict__ zn2, long long p, int nnz_max, int m, int tile_feats,
                       int stages, int lag, int y_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[SC_MAX_STAGES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ys = reinterpret_cast<float*>(smem);
  if (STAGED)
    for (int i = threadIdx.x; i < m; i += SC_THREADS) ys[i] = y[i];
  const float* v = STAGED ? ys : y;
  const long long n_tiles = tile_feats ? p / tile_feats : 0;
  const int mine = n_tiles > blockIdx.x ? (int)((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  const int tile_slots = tile_feats * nnz_max;
  const uint32_t val_bytes = (uint32_t)tile_slots * sizeof(T);
  T* vring = reinterpret_cast<T*>(smem + y_bytes);             // stages x values
  int* rring = reinterpret_cast<int*>(smem + y_bytes + (size_t)stages * val_bytes);
  float* parts = reinterpret_cast<float*>(rring + (size_t)(lag + 1) * tile_slots);
  auto part_buf = [&](int t) { return parts + (t & 1) * 2 * tile_feats * 33; };
  auto tile_of = [&](int i) { return blockIdx.x + (long long)i * gridDim.x; };
  auto load_values = [&](int i, int s) {  // thread 0: tile i's values into stage s
    mbar_expect_tx(&full[s], val_bytes);
    bulk_copy_to_shared(vring + s * tile_slots, values + tile_of(i) * tile_slots, val_bytes,
                        &full[s]);
  };
  // Stages advance one a tile, in the same order for every role (no
  // division in the loop): value stages for the tile waited for (vw, its
  // barrier's phase parity vph), summed (vc) and, on thread 0, started (vi);
  // row slots for the tile fetched (rw) and summed (rc).
  auto next = [](int& s, int n) { s = s + 1 == n ? 0 : s + 1; };

  if (mine > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
      mbar_fence_init();
    }
    __syncthreads();
    const int ahead = stages - lag - 1;  // value tiles in flight
    int vw = 0, vc = 0, vi = 0, rw = 0, rc = 0;
    uint32_t vph = 0;
    if (threadIdx.x == 0)
      for (; vi < ahead && vi < mine; ++vi) load_values(vi, vi);
    vi = ahead;
    for (int i = 0; i <= mine + lag; ++i) {
      wait_rows(lag - 1);  // this thread's rows of tile i - lag are in
      __syncthreads();     // ... every thread's; tile i - lag - 1 is summed
      if (threadIdx.x == 0 && i + ahead < mine) {
        load_values(i + ahead, vi);  // into tile i - lag - 1's value stage
        next(vi, stages);
      }
      if (i < mine) {  // tile i's rows into tile i - lag - 1's row slot
        mbar_wait(&full[vw], vph);
        const T* vs = vring + vw * tile_slots;
        int* rs = rring + rw * tile_slots;
        const int* rg = rows + tile_of(i) * tile_slots;
        for (int c = threadIdx.x; c < tile_slots / 4; c += SC_THREADS)
          cp_async16(rs + 4 * c, rg + 4 * c, any_stored<T>(vs + 4 * c));
        if (vw + 1 == stages) vph ^= 1u;
        next(vw, stages);
        next(rw, lag + 1);
      }
      cp_async_commit();
      const int t = i - lag;
      // tile t - 1's sums: two warps each 32 features, one for zty, one
      // for znorm2; the last warps, which have the fewest slots
      const int sum_warp = SC_WARPS - 1 - warp;
      if (t >= 1 && sum_warp < tile_feats / 16) {
        const int j = (sum_warp >> 1) * 32 + lane, sq = sum_warp & 1;
        const float* part = part_buf(t - 1) + sq * tile_feats * 33;
        (sq ? zn2 : zty)[tile_of(t - 1) * tile_feats + j] = tree_sum32(part + j * 33);
      }
      if (t >= 0 && t < mine) {
        tile_partials<T>(vring + vc * tile_slots, rring + rc * tile_slots, tile_feats, nnz_max,
                         v, lane, warp, part_buf(t));
        next(vc, stages);
        next(rc, lag + 1);
      }
    }
  } else if (STAGED) {
    __syncthreads();
  }
  for (long long f = n_tiles * tile_feats + (long long)blockIdx.x * SC_WARPS + warp; f < p;
       f += (long long)gridDim.x * SC_WARPS)
    feature_sums<T>(values, rows, f, nnz_max, v, lane, zty, zn2);
}

template <typename T>
static int launch(const void* values, const int* rows, const float* y, float* zty, float* zn2,
                  long long p, int nnz_max, int m, int tile_feats, int stages, int lag,
                  int y_bytes, cudaStream_t s) {
  static GridCache cache[2];  // y read through L2, y staged
  const size_t slots = (size_t)tile_feats * nnz_max;
  const size_t smem = (size_t)y_bytes + stages * slots * sizeof(T) +
                      (lag + 1) * slots * sizeof(int) + (size_t)tile_feats * 2 * 2 * 33 * 4;
  const bool ring_ok = tile_feats == 0 ? stages == 0 && lag == 0
                                       : tile_feats % 32 == 0 && tile_feats <= 16 * SC_WARPS &&
                                             stages <= SC_MAX_STAGES && lag >= 1 && lag <= 3 &&
                                             stages >= lag + 2;
  if (!ring_ok || smem > OPTIN_SMEM_BYTES || (y_bytes && (size_t)y_bytes < (size_t)m * 4) ||
      y_bytes % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = tile_feats ? p / tile_feats : 0;
  const long long tail_blocks = (p - n_tiles * tile_feats + SC_WARPS - 1) / SC_WARPS;
  const long long needed = n_tiles > tail_blocks ? n_tiles : tail_blocks;
  int blocks = 0;
  auto kernel = y_bytes ? sparse_colstats_kernel<T, true> : sparse_colstats_kernel<T, false>;
  cudaError_t err = resident_grid(kernel, SC_THREADS, smem, needed,
                                  y_bytes ? &cache[1] : &cache[0], &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, SC_THREADS, smem, s>>>(static_cast<const T*>(values), rows, y, zty, zn2, p,
                                          nnz_max, m, tile_feats, stages, lag, y_bytes);
  return (int)cudaGetLastError();
}

extern "C" int sparse_colstats_launch(const void* values, const int* rows, const float* y,
                                      float* zty, float* zn2, long long p, int nnz_max, int m,
                                      int tile_feats, int stages, int lag, int y_bytes,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(values, rows, y, zty, zn2, p, nnz_max, m, tile_feats, stages, lag,
                         y_bytes, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(values, rows, y, zty, zn2, p, nnz_max, m, tile_feats, stages,
                                 lag, y_bytes, s);
  return (int)cudaErrorInvalidValue;
}
