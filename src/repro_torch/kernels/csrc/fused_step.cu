// K4 and K7: K fused FW iterations per launch, on the dense layout (K4,
// replaces the Pallas kernel at src/repro/kernels/fused_step/fused_step.py:259
// through its entry dense_fused_chunk at :310) and on the block-ELL layout
// (K7, the same kernel through sparse_fused_chunk at :376); and the replay
// of their step records into the O(p) coefficient state (replaces the XLA
// fori_loop of src/repro/core/engine.py:387, _fused_replay). See
// kernels/fused_step.py for the bounds and the design.
//
// Both chunks run one persistent cooperative grid with one grid sync a
// step, and share what follows a step's scoring (end_step). K4 scores in
// fused_chunk_kernel; K7 scores in sparse_ring_chunk_kernel, which streams
// its features' slots through a ring in shared memory for each warp, or,
// where no ring fits beside the residual, in fused_chunk_kernel too.
//
// Scalar algebra: common.cuh's lasso_line_search, sf_recursion,
// coeff_increment and stop_stats, the op order of core/fw_lasso.py and
// core/engine.py in _rn intrinsics (one copy, shared with the unfused
// step's tail in step_tail.cu); the elastic-net's en_line_search and
// q_recursion in its chunks.
//
// The elastic-net's chunk (each kernel's EN instantiation; the lasso's
// compile none of it) is the reference's alpha ledger
// (src/repro/kernels/fused_step/fused_step.py:137-139, 158-162, 226-230):
// every block keeps, at the front of its dynamic shared memory (K slots,
// ledger_bytes(K)), the running product P of
// (1 - lam) and one slot (i*_t, c_t) a step, every slot rescaled by
// (1 - lam) each step and slot s set to lam_s * delta_t_s. A scored
// coordinate i selects on sel = raw + l2 * a_i, a_i = P * alpha_s + the
// slots of i (added in slot order); the partials carry (|sel|, raw,
// position) and thread 0 recomputes the winner's a_i and sel from the
// same ledger (the same bits), then runs the EN line search and Q's
// recursion; Q's exact refresh is the engine's, after the replay. Its
// records also carry the step's sampled gap, gap scale and Q (the inputs of
// the stall test), where the lasso's write zeros. The dense scores
// go through warp_row_score, K2's per-row dot, and its residual update is
// K3's op sequence; the sparse scores go through warp_slot_score, K5's
// slot dot, or the ring's copy of its order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int FC_THREADS = 512;  // fused_chunk_kernel's block
constexpr int FC_WARPS = FC_THREADS / 32;
// record row: lam, delta_t, raw, sel, stall flag, then the EN chunk's gap,
// gap scale and Q before the step (the lasso's: 0, 0, 0)
constexpr int REC = 8;
constexpr int RP_THREADS = 1024;  // the replay's block, all of it for a renorm

struct __align__(16) Partial {
  float mag;
  float raw;
  long long j;
};

// Another block's partial, read from L2 (ld.global.cg): this block's L1
// may still hold the slot's value from two steps before.
__device__ __forceinline__ Partial load_partial(const Partial* q) {
  union {
    float4 v;
    Partial q;
  } u;
  u.v = __ldcg(reinterpret_cast<const float4*>(q));
  return u.q;
}

// Block-wide first max of each thread's (mag, j, raw); thread 0 ends with
// the winner. Every block that holds the same candidates gets the same
// winner: `better` is a total order on (mag, j).
template <int WARPS>
__device__ __forceinline__ void block_best(float& mag, long long& j, float& raw, float* smag,
                                           long long* sj, float* sraw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(mag, j, raw);
  if (lane == 0) {
    smag[warp] = mag;
    sj[warp] = j;
    sraw[warp] = raw;
  }
  __syncthreads();
  if (warp == 0) {
    mag = lane < WARPS ? smag[lane] : -INFINITY;
    j = lane < WARPS ? sj[lane] : LLONG_MAX;
    raw = lane < WARPS ? sraw[lane] : 0.f;
    warp_best(mag, j, raw);
  }
  __syncthreads();  // smag/sj/sraw free again
}

// The two layouts the chunk runs on. Each gives the per-row score of a
// sampled coordinate against the block's residual copy (one warp) and the
// eq. 10 update of that copy by the step's winner (the whole block).

// Dense Xt (p, m) (K4): K2's row dot; K3's op order for eq. 10; y staged
// in shared memory beside the residual.
struct DenseRows {
  static constexpr bool kStageY = true;
  const float* X;
  long long p;
  int m;
  int vec;

  __device__ __forceinline__ float score(long long row, const float* rs, int lane) const {
    return warp_row_score<float>(X, row, p, m, rs, vec, lane);
  }
  template <int THREADS>
  __device__ __forceinline__ void update(float* rs, const float* yv, long long i, float lam,
                                         float dt) const {
    const float one_m = __fsub_rn(1.f, lam);
    const float* z = X + i * (long long)m;
    for (int k = threadIdx.x; k < m; k += THREADS) {
      const float a = __fmul_rn(one_m, rs[k]);
      const float b = __fmul_rn(lam, __fsub_rn(yv[k], __fmul_rn(dt, z[k])));
      rs[k] = __fadd_rn(a, b);
    }
  }
};

// Block-ELL slots (K7): K5's slot dot; the op order of
// step_tail.py's sparse_residual_update, out = (1 - lam) r + lam y over m and
// then out[rows] += (-lam * dt) * vals over the winner's slots. A
// feature's real rows are distinct, so the slots' adds are independent;
// a padded slot (value 0) adds nothing and is skipped, so the shared
// row 0 of the padding sees no race. y is read through L2, which leaves
// shared memory to the residual (and the ring).
struct SparseSlots {
  static constexpr bool kStageY = false;
  const float* values;
  const int* rows;
  long long n_feat;  // padded features in the arrays
  int m;
  int nnz_max;

  __device__ __forceinline__ float score(long long f, const float* rs, int lane) const {
    return warp_slot_score<float>(values, rows, f, n_feat, nnz_max, rs, lane);
  }
  template <int THREADS>
  __device__ __forceinline__ void update(float* rs, const float* yv, long long i, float lam,
                                         float dt) const {
    const float one_m = __fsub_rn(1.f, lam);
    for (int k = threadIdx.x; k < m; k += THREADS)
      rs[k] = __fadd_rn(__fmul_rn(one_m, rs[k]), __fmul_rn(lam, __ldg(yv + k)));
    __syncthreads();
    const float c = __fmul_rn(-lam, dt);
    const long long base = i * nnz_max;
    for (int k = threadIdx.x; k < nnz_max; k += THREADS) {
      const float v = values[base + k];
      if (v != 0.f) atomicAdd(rs + rows[base + k], __fmul_rn(c, v));
    }
  }
};

// The chunk's inputs and outputs, the same for both layouts.
struct ChunkArgs {
  const float* y;
  const float* r0;
  const float* s0;
  const float* f0;
  const float* q0;
  const float* delta;
  const long long* idx;  // (K, kappa) sampled coordinates
  const float* zty_s;
  const float* zn2_s;
  int m;
  int K;
  long long kappa;
  long long k0;
  long long max_iters;
  int refresh_every;
  float eps_den;
  float gap_rtol;
  long long* i_star_out;
  float* recs;
  unsigned char* no_prog_out;
  float* r_out;
  float* s_out;
  Partial* partials;  // 2 x gridDim.x, indexed by step parity
  const float* alpha_s;  // (K, kappa) chunk-start alpha at idx; the EN chunk's
  float l2;
};

// The elastic-net's alpha ledger, one copy a block at the front of its
// dynamic shared memory, written by thread 0: K slot ids, K slot values,
// then P (ledger_bytes(K), kernels/fused_step.py's).
struct Ledger {
  long long* idx;  // slot t: i*_t
  float* add;      // slot t: c_t, rescaled by every later step
  float* P;        // prod(1 - lam) over the chunk's live steps
};

__host__ __device__ __forceinline__ size_t ledger_bytes(int K) {
  return ((size_t)12 * K + 4 + 15) & ~(size_t)15;
}

// a_i of coordinate id at step s: P * alpha0 + its slots among the first s.
__device__ __forceinline__ float ledger_alpha(const Ledger& led, long long id, float alpha0,
                                              int s) {
  float corr = 0.f;
  for (int t = 0; t < s; ++t)
    if (led.idx[t] == id) corr = __fadd_rn(corr, led.add[t]);
  return __fadd_rn(__fmul_rn(*led.P, alpha0), corr);
}

// The magnitude an EN chunk's scored coordinate (id `id` at step s,
// chunk-start alpha `alpha0`, loaded before its score so that the load
// overlaps it; raw score `raw`) competes with: |raw + l2 * a_i|.
__device__ __forceinline__ float select_mag(const ChunkArgs& a, const Ledger& led, int s,
                                            long long id, float alpha0, float raw) {
  return fabsf(__fadd_rn(raw, __fmul_rn(a.l2, ledger_alpha(led, id, alpha0, s))));
}

// A block's scratch for the end of a step, and the scalars its thread 0
// hands the block.
template <int WARPS>
struct StepShared {
  float smag[WARPS], sraw[WARPS], sv[2][WARPS];
  long long sj[WARPS];
  float lam, dt;
  long long i;
  int active, refresh;
};

// Step s once every warp of the block has scored its share and holds its
// first max (mag, j, raw): the block's first max goes to partials[s % 2];
// one grid sync; every block reduces all partials in the same order,
// computes the line search and the S/F recursions redundantly on thread 0
// (identical scalars everywhere; S and F live there), block 0 writes the
// records, and every block updates its own shared-memory residual with the
// winner (Layout::update) and, on the refresh cadence, recomputes S and F.
template <int THREADS, class Layout, bool EN>
__device__ __forceinline__ void end_step(const Layout& L, const ChunkArgs& a,
                                         cg::grid_group& grid, StepShared<THREADS / 32>& sh,
                                         const Ledger& led, float* rs, const float* yv, int s,
                                         float mag, long long j, float raw, float delta, float& S,
                                         float& F, float& Q) {
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  block_best<WARPS>(mag, j, raw, sh.smag, sh.sj, sh.sraw);
  Partial* part = a.partials + (s & 1) * gridDim.x;
  if (tid == 0) part[blockIdx.x] = Partial{mag, raw, j};
  grid.sync();

  // ---- every block: the step's winner, then the scalar algebra -----------
  mag = -INFINITY;
  raw = 0.f;
  j = LLONG_MAX;
  for (int b = tid; b < (int)gridDim.x; b += THREADS) {
    const Partial q = load_partial(part + b);
    if (better(q.mag, q.j, mag, j)) {
      mag = q.mag;
      j = q.j;
      raw = q.raw;
    }
  }
  block_best<WARPS>(mag, j, raw, sh.smag, sh.sj, sh.sraw);
  if (tid == 0) {
    const long long flat = (long long)s * a.kappa + j;
    const long long i_star = a.idx[flat];
    const float zty = a.zty_s[flat], zn2 = a.zn2_s[flat];
    float g_sel = raw, a_star = 0.f;  // lasso: the selected score is the linear one
    const float q_in = Q;
    LineSearch ls;
    if constexpr (EN) {
      a_star = ledger_alpha(led, i_star, a.alpha_s[flat], s);
      g_sel = __fadd_rn(raw, __fmul_rn(a.l2, a_star));
      ls = en_line_search(raw, g_sel, a_star, delta, S, F, Q, zty, zn2, a.l2, a.eps_den,
                          a.gap_rtol);
    } else {
      ls = lasso_line_search(raw, delta, S, F, zty, zn2, a.eps_den, a.gap_rtol);
    }
    const float lam = ls.lam, dt = ls.dt;
    const bool no_prog = ls.no_prog;
    const long long kg = a.k0 + s;
    const bool active = kg < a.max_iters;
    if (active) {
      sf_recursion(S, F, ls.g_lin, lam, dt, zty, zn2);
      if constexpr (EN) {  // Q, then the ledger (this block's copy)
        Q = q_recursion(Q, lam, dt, a_star);
        const float one_m = __fsub_rn(1.f, lam);
        *led.P = __fmul_rn(*led.P, one_m);
        for (int t = 0; t < s; ++t) led.add[t] = __fmul_rn(led.add[t], one_m);
        led.add[s] = __fmul_rn(lam, dt);
        led.idx[s] = i_star;
      }
    }
    sh.lam = lam;
    sh.dt = dt;
    sh.i = i_star;
    sh.active = active;
    sh.refresh = active && (kg % a.refresh_every) == (a.refresh_every - 1);
    if (blockIdx.x == 0) {
      float* rec = a.recs + (long long)s * REC;
      rec[0] = lam;
      rec[1] = dt;
      rec[2] = raw;
      rec[3] = g_sel;
      rec[4] = no_prog ? 1.f : 0.f;
      if constexpr (EN) {
        rec[5] = ls.num;
        rec[6] = ls.gap_scale;
        rec[7] = q_in;
      } else {
        rec[5] = rec[6] = rec[7] = 0.f;
      }
      a.i_star_out[s] = i_star;
      a.no_prog_out[s] = no_prog;
    }
  }
  __syncthreads();

  // ---- eq. 10 on this block's residual + the refresh ----------------------
  if (sh.active) {
    L.template update<THREADS>(rs, yv, sh.i, sh.lam, sh.dt);
    __syncthreads();
    if (sh.refresh) {  // exact S = ||v||^2, F = v.y with v = y - R, fixed order
      float vv = 0.f, vy = 0.f;
      for (int i = tid; i < a.m; i += THREADS) {
        const float yi = yv[i];
        const float v = __fsub_rn(yi, rs[i]);
        vv = fmaf(v, v, vv);
        vy = fmaf(v, yi, vy);
      }
      vv = warp_sum(vv);
      vy = warp_sum(vy);
      if (lane == 0) {
        sh.sv[0][warp] = vv;
        sh.sv[1][warp] = vy;
      }
      __syncthreads();
      if (tid == 0) {
        S = 0.f;
        F = 0.f;
        for (int w = 0; w < WARPS; ++w) {
          S = __fadd_rn(S, sh.sv[0][w]);
          F = __fadd_rn(F, sh.sv[1][w]);
        }
      }
    }
  }
  __syncthreads();
}

// Block 0 writes the final residual and (S, F, Q) (the lasso's Q: q0).
template <int THREADS, bool EN>
__device__ __forceinline__ void end_chunk(const ChunkArgs& a, const float* rs, float S,
                                          float F, float Q) {
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < a.m; i += THREADS) a.r_out[i] = rs[i];
  if (threadIdx.x == 0) {
    a.s_out[0] = S;
    a.s_out[1] = F;
    a.s_out[2] = EN ? Q : *a.q0;
  }
}

// The block's ledger at the front of its dynamic shared memory: EN chunks
// start it at P = 1 (a slot is written before it is read; a barrier
// follows before any read); the lasso's chunk has none (null pointers).
template <bool EN>
__device__ __forceinline__ Ledger chunk_ledger(float* smem, int K) {
  if constexpr (EN) {
    Ledger led{reinterpret_cast<long long*>(smem), smem + 2 * K, smem + 3 * K};
    if (threadIdx.x == 0) *led.P = 1.f;
    return led;
  } else {
    return Ledger{nullptr, nullptr, nullptr};
  }
}

// Where the rest of a block's dynamic shared memory starts: past the EN
// ledger, at the front for the lasso's chunk.
template <bool EN>
__device__ __forceinline__ float* past_ledger(float* smem, int K) {
  if constexpr (EN) {
    return smem + ledger_bytes(K) / sizeof(float);
  } else {
    return smem;
  }
}

// K4, and K7 where no ring fits: every warp scores the sampled coordinates
// c = its grid-wide warp index + multiples of the grid's warps straight
// from device memory, one coordinate at a time, against its block's copy
// of the residual.
template <class Layout, bool EN>
__global__ void __launch_bounds__(FC_THREADS, 2)
fused_chunk_kernel(Layout L, ChunkArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const Ledger led = chunk_ledger<EN>(smem, a.K);
  float* rs = past_ledger<EN>(smem, a.K);  // this block's live residual (m)
  float* ys = rs + ((a.m + 3) & ~3);       // y (m), when the layout stages it
  const float* yv = Layout::kStageY ? ys : a.y;
  __shared__ StepShared<FC_WARPS> sh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < a.m; i += FC_THREADS) {
    rs[i] = a.r0[i];
    if (Layout::kStageY) ys[i] = a.y[i];
  }
  // the scalar state lives in thread 0 of every block
  float S = *a.s0, F = *a.f0, Q = EN ? *a.q0 : 0.f;
  const float delta = *a.delta;
  __syncthreads();

  const long long gwarp = (long long)blockIdx.x * FC_WARPS + warp;
  const long long nwarps = (long long)gridDim.x * FC_WARPS;
  for (int s = 0; s < a.K; ++s) {
    const long long* ids = a.idx + (long long)s * a.kappa;
    float mag = -INFINITY, raw = 0.f;
    long long j = LLONG_MAX;
    for (long long c = gwarp; c < a.kappa; c += nwarps) {
      if constexpr (EN) {
        const long long id = ids[c];
        const float alpha0 = a.alpha_s[(long long)s * a.kappa + c];  // overlaps the score
        const float sc = L.score(id, rs, lane);
        const float sm = select_mag(a, led, s, id, alpha0, sc);
        if (better(sm, c, mag, j)) {
          mag = sm;
          j = c;
          raw = sc;
        }
      } else {
        const float sc = L.score(ids[c], rs, lane);
        if (better(fabsf(sc), c, mag, j)) {
          mag = fabsf(sc);
          j = c;
          raw = sc;
        }
      }
    }
    end_step<FC_THREADS, Layout, EN>(L, a, grid, sh, led, rs, yv, s, mag, j, raw, delta, S, F,
                                     Q);
  }
  end_chunk<FC_THREADS, EN>(a, rs, S, F, Q);
}

// K7 where a ring fits beside the residual: one block of 1024 threads a
// SM, each warp streaming its features through a ring of its own in
// shared memory (common.cuh's SlotRing, K5's scoring too). Every step
// splits its kappa positions into one contiguous run per warp of the grid,
// [lo, lo + n); the warp's sequence is the K steps' runs, one after the
// other, so the last ticks of step s have already started the first pieces
// of step s + 1, which land during the step's grid sync, reduction and
// O(m) residual pass; only their gathers wait for it.
struct ChunkIds {  // feature f of a warp's sequence: step f / n, position lo + f % n
  const long long* idx;
  long long kappa, lo;
  int n;
  __device__ __forceinline__ long long operator()(int f) const {
    const int s = f / n;
    return idx[s * kappa + lo + (f - s * n)];
  }
};

template <int NT, bool EN>
__global__ void __launch_bounds__(1024, 1)
sparse_ring_chunk_kernel(SparseSlots L, ChunkArgs a, int stride) {
  constexpr int THREADS = 1024, WARPS = THREADS / 32;
  static_assert(WARPS == RING_WARPS, "the ring's layout assumes 1024-thread blocks");
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  __shared__ StepShared<WARPS> sh;
  const Ledger led = chunk_ledger<EN>(smem, a.K);
  const int tid = threadIdx.x, warp = tid >> 5;
  float* rs = past_ledger<EN>(smem, a.K);  // this block's live residual (m)
  for (int i = tid; i < a.m; i += THREADS) rs[i] = a.r0[i];
  float S = *a.s0, F = *a.f0, Q = EN ? *a.q0 : 0.f;
  const float delta = *a.delta;

  // the warp's sequence has K * n < 2^31 features (sparse_fused_chunk_launch)
  const long long nw = (long long)gridDim.x * WARPS, gw = (long long)blockIdx.x * WARPS + warp;
  const long long lo = gw * a.kappa / nw;
  const int n = (int)((gw + 1) * a.kappa / nw - lo);
  SlotRing<NT, ChunkIds> ring(L.values, L.rows, L.n_feat, L.nnz_max, stride,
                              rs + ((a.m + 3) & ~3), ChunkIds{a.idx, a.kappa, lo, n}, n, a.K);
  ring.prologue();
  __syncthreads();  // the residual

  for (int s = 0; s < a.K; ++s) {
    float mag = -INFINITY, raw = 0.f;
    long long j = LLONG_MAX;
    for (int pi = 0; pi < ring.npairs; ++pi) {
      if constexpr (EN) {
        const long long c = lo + 2 * pi + ring.h;
        const bool real = 2 * pi + ring.h < n;
        long long id = 0;  // the feature's id and chunk-start alpha, in flight
        float alpha0 = 0.f;  // while its pair is scored
        if (real) {
          id = __ldg(a.idx + (long long)s * a.kappa + c);
          alpha0 = __ldg(a.alpha_s + (long long)s * a.kappa + c);
        }
        const float sc = ring.score_pair(rs);
        const float sm = select_mag(a, led, s, id, alpha0, sc);
        if (real && better(sm, c, mag, j)) {
          mag = sm;
          j = c;
          raw = sc;
        }
      } else {
        const float sc = ring.score_pair(rs);
        const long long c = lo + 2 * pi + ring.h;
        if (2 * pi + ring.h < n && better(fabsf(sc), c, mag, j)) {
          mag = fabsf(sc);
          j = c;
          raw = sc;
        }
      }
    }
    end_step<THREADS, SparseSlots, EN>(L, a, grid, sh, led, rs, a.y, s, mag, j, raw, delta, S,
                                       F, Q);
  }
  cp_async_wait<0>();
  end_chunk<THREADS, EN>(a, rs, S, F, Q);
}

// The replay: warp 0 walks the K records in order with apply_coeff_update's
// op sequence, in registers. Each batch of up to 32 records is loaded in
// one parallel round (lane t: record t and then beta[i_star[t]]); record t
// takes its values from lane t by shuffles; a coordinate that wins again
// in the batch is forwarded (every lane holding that coordinate takes the
// new value), and at the batch's end each distinct coordinate is written
// once, with its final value, by the last lane that holds it. A renorm
// (new_scale < renorm_threshold) stops the walk at its record: the whole
// block multiplies beta by new_scale (__fmul_rn), warp 0 multiplies the
// values it holds by the same factor, and the walk goes on from there. No
// block barrier is taken otherwise.
__global__ void __launch_bounds__(RP_THREADS)
fused_replay_kernel(float* __restrict__ beta, long long p, const float* __restrict__ scale_in,
                    const float* __restrict__ maxabs_in, const float* __restrict__ step_inf_in,
                    const int* __restrict__ stall_in, const long long* __restrict__ i_star,
                    const float* __restrict__ lam, long long lam_stride,
                    const float* __restrict__ dt, long long dt_stride,
                    const unsigned char* __restrict__ no_prog, int K, long long k0,
                    long long max_iters, float renorm_threshold, float eps_den, float tol,
                    float* __restrict__ f_out, int* __restrict__ stall_out) {
  __shared__ float sh_factor;
  __shared__ int sh_renorm;
  const int lane = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;
  const long long live = max(0LL, min((long long)K, max_iters - k0));
  float scale = *scale_in, maxabs = *maxabs_in, step_inf = *step_inf_in;
  int stall = *stall_in;
  // lane t's record of the batch, and the coefficient it holds
  long long ri = 0;
  float rlam = 0.f, rdt = 0.f, rb = 0.f;
  int rnp = 0;
  // record t's scalars, kept across a renorm's pause
  float a_star = 0.f, one_m = 0.f, new_scale = 0.f, lam_t = 0.f, dt_t = 0.f, b_t = 0.f;
  long long i_t = 0;
  int np_t = 0;
  long long t = 0;
  bool paused = false;  // record t waits for (or has had) its renorm
  for (;;) {
    if (walker) {
      for (; t < live; ++t) {
        const int l = (int)(t & 31);
        if (!paused) {
          if (l == 0) {  // a new batch: one round of record loads, one of gathers
            const long long tt = t + lane;
            ri = -1 - lane;  // a dead lane matches no coordinate
            if (tt < live) {
              ri = i_star[tt];
              rlam = lam[tt * lam_stride];
              rdt = dt[tt * dt_stride];
              rnp = no_prog[tt];
              rb = beta[ri];
            }
          }
          i_t = __shfl_sync(0xffffffffu, ri, l);
          lam_t = __shfl_sync(0xffffffffu, rlam, l);
          dt_t = __shfl_sync(0xffffffffu, rdt, l);
          np_t = __shfl_sync(0xffffffffu, rnp, l);
          b_t = __shfl_sync(0xffffffffu, rb, l);
          a_star = __fmul_rn(scale, b_t);
          one_m = __fsub_rn(1.f, lam_t);
          new_scale = __fmul_rn(scale, one_m);
          if (new_scale < renorm_threshold) {
            paused = true;
            if (lane == 0) sh_factor = new_scale;
            break;  // the block multiplies beta, then record t goes on
          }
        }
        if (paused) {  // beta *= new_scale: the values held here too
          rb = __fmul_rn(rb, new_scale);
          b_t = __fmul_rn(b_t, new_scale);
          scale = 1.f;
          paused = false;
        } else {
          scale = new_scale;
        }
        const float bi = __fadd_rn(b_t, coeff_increment(dt_t, lam_t, scale, eps_den));
        if (ri == i_t) rb = bi;
        stop_stats(lam_t, one_m, dt_t, a_star, __fmul_rn(scale, bi), np_t, tol, maxabs, step_inf,
                   stall);
        if (l == 31 || t + 1 == live) {  // the batch's coordinates, once each
          const unsigned same = __match_any_sync(0xffffffffu, ri);
          if (ri >= 0 && lane == 31 - __clz(same)) beta[ri] = rb;
          __syncwarp();  // the next batch's gathers see these writes
        }
      }
      if (lane == 0) sh_renorm = paused;
    }
    __syncthreads();
    if (!sh_renorm) break;
    const float f = sh_factor;
    for (long long q = threadIdx.x; q < p; q += RP_THREADS) beta[q] = __fmul_rn(beta[q], f);
    __syncthreads();  // sh_renorm and sh_factor are rewritten by the next pause
  }
  if (threadIdx.x == 0) {
    f_out[0] = scale;
    f_out[1] = maxabs;
    f_out[2] = step_inf;
    *stall_out = stall;
  }
}

// ---- host side --------------------------------------------------------------

// Dynamic shared memory of fused_chunk_kernel: the EN chunk's ledger of
// `slots` = K slots (none: 0), the residual, and y beside it when the
// layout stages y.
template <class Layout>
static size_t chunk_smem_bytes(int m, int slots) {
  return (slots ? ledger_bytes(slots) : 0) +
         (size_t)(((m + 3) & ~3) + (Layout::kStageY ? m : 0)) * sizeof(float);
}

// K7's kernel for a plan: depth 0, fused_chunk_kernel (512 threads);
// otherwise the ring kernel (1024 threads) of ceil(slots / 32) slots a
// lane; the lasso's (ledger 0) or the elastic-net's instantiation with a
// ledger of `ledger` = K slots.
struct SparseChoice {
  const void* kernel;
  int threads;
  size_t smem;
  GridCache* cache;
};

static cudaError_t sparse_choice(int m, int nnz_max, int threads, int depth, int slots,
                                 int stride, int ledger, SparseChoice* out) {
  static GridCache caches[2][5];
  const int en = ledger > 0;
  if (depth == 0) {
    if (threads != FC_THREADS || slots != 0 || stride != 0) return cudaErrorInvalidValue;
    *out = {en ? (const void*)fused_chunk_kernel<SparseSlots, true>
               : (const void*)fused_chunk_kernel<SparseSlots, false>,
            FC_THREADS, chunk_smem_bytes<SparseSlots>(m, ledger), &caches[en][0]};
  } else {
    if (threads != 1024 || depth != RING_DEPTH || !ring_plan_ok(nnz_max, slots, stride))
      return cudaErrorInvalidValue;
    const void* kernels[2][4] = {{(const void*)sparse_ring_chunk_kernel<1, false>,
                                  (const void*)sparse_ring_chunk_kernel<2, false>,
                                  (const void*)sparse_ring_chunk_kernel<3, false>,
                                  (const void*)sparse_ring_chunk_kernel<4, false>},
                                 {(const void*)sparse_ring_chunk_kernel<1, true>,
                                  (const void*)sparse_ring_chunk_kernel<2, true>,
                                  (const void*)sparse_ring_chunk_kernel<3, true>,
                                  (const void*)sparse_ring_chunk_kernel<4, true>}};
    const int nt = (slots + 31) / 32;
    *out = {kernels[en][nt - 1], 1024,
            (en ? ledger_bytes(ledger) : 0) + ring_smem_bytes(m, stride), &caches[en][nt]};
  }
  return out->smem > OPTIN_SMEM_BYTES ? cudaErrorInvalidValue : cudaSuccess;
}

static const void* dense_kernel(int en) {
  return en ? (const void*)fused_chunk_kernel<DenseRows, true>
            : (const void*)fused_chunk_kernel<DenseRows, false>;
}

// The cooperative grid of a kernel on the current device: every SM's worth
// of resident blocks, as the occupancy calculator allows (resident_grid,
// which also raises the shared-memory limit on the device).
static int coop_blocks(const void* kernel, int threads, size_t smem, GridCache* cache,
                       int* blocks) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = resident_grid(kernel, threads, smem, LLONG_MAX, cache, blocks);
  return (int)err;
}

static int coop_launch(const void* kernel, int threads, size_t smem, void** args, int blocks,
                       void* stream) {
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it again
    return (int)err;
  }
  return (int)cudaGetLastError();
}

static ChunkArgs chunk_args(const float* y, const float* r0, const float* s0, const float* f0,
                            const float* q0, const float* delta, const long long* idx,
                            const float* zty_s, const float* zn2_s, int m, int K,
                            long long kappa, long long k0, long long max_iters,
                            int refresh_every, float eps_den, float gap_rtol,
                            long long* i_star, float* recs, unsigned char* no_prog,
                            float* r_out, float* s_out, void* partials, const float* alpha_s,
                            float l2) {
  return ChunkArgs{y,         r0,      s0,         f0,       q0,      delta,
                   idx,       zty_s,   zn2_s,      m,        K,       kappa,
                   k0,        max_iters, refresh_every, eps_den, gap_rtol, i_star,
                   recs,      no_prog, r_out,      s_out,    static_cast<Partial*>(partials),
                   alpha_s,   l2};
}

// `ledger`: 0, the lasso's chunk; K, the elastic-net's with its K-slot ledger.
extern "C" int dense_fused_chunk_blocks(int m, int ledger, int* blocks) {
  static GridCache caches[2];
  const size_t smem = chunk_smem_bytes<DenseRows>(m, ledger);
  if (smem > OPTIN_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  return coop_blocks(dense_kernel(ledger > 0), FC_THREADS, smem, &caches[ledger > 0], blocks);
}

extern "C" int sparse_fused_chunk_blocks(int m, int nnz_max, int threads, int depth, int slots,
                                         int stride, int ledger, int* blocks) {
  SparseChoice c;
  cudaError_t err = sparse_choice(m, nnz_max, threads, depth, slots, stride, ledger, &c);
  if (err != cudaSuccess) return (int)err;
  return coop_blocks(c.kernel, c.threads, c.smem, c.cache, blocks);
}

// alpha_s == nullptr: the lasso's chunk; otherwise the elastic-net's, with
// its (K, kappa) chunk-start alpha values and l2, and a K-slot ledger.
extern "C" int dense_fused_chunk_launch(const float* X, long long p, const float* y,
                                        const float* r0, const float* s0, const float* f0,
                                        const float* q0, const float* delta,
                                        const long long* idx, const float* zty_s,
                                        const float* zn2_s, int m, int K, long long kappa,
                                        long long k0,
                                        long long max_iters, int refresh_every, float eps_den,
                                        float gap_rtol, long long* i_star, float* recs,
                                        unsigned char* no_prog, float* r_out, float* s_out,
                                        void* partials, int blocks, const float* alpha_s,
                                        float l2, void* stream) {
  const int en = alpha_s != nullptr;
  const size_t smem = chunk_smem_bytes<DenseRows>(m, en ? K : 0);
  if (smem > OPTIN_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  DenseRows L{X, p, m, rows_vectorizable<float>(X, m)};
  ChunkArgs a = chunk_args(y, r0, s0, f0, q0, delta, idx, zty_s, zn2_s, m, K, kappa, k0,
                           max_iters, refresh_every, eps_den, gap_rtol, i_star, recs, no_prog,
                           r_out, s_out, partials, alpha_s, l2);
  void* args[] = {&L, &a};
  return coop_launch(dense_kernel(en), FC_THREADS, smem, args, blocks, stream);
}

extern "C" int sparse_fused_chunk_launch(const float* values, const int* rows,
                                         long long n_feat, int nnz_max, int threads, int depth,
                                         int slots, int stride, const float* y,
                                         const float* r0, const float* s0, const float* f0,
                                         const float* q0, const float* delta,
                                         const long long* idx, const float* zty_s,
                                         const float* zn2_s, int m, int K, long long kappa,
                                         long long k0,
                                         long long max_iters, int refresh_every, float eps_den,
                                         float gap_rtol, long long* i_star, float* recs,
                                         unsigned char* no_prog, float* r_out, float* s_out,
                                         void* partials, int blocks, const float* alpha_s,
                                         float l2, void* stream) {
  const int en = alpha_s != nullptr;
  SparseChoice c;
  cudaError_t err = sparse_choice(m, nnz_max, threads, depth, slots, stride, en ? K : 0, &c);
  if (err != cudaSuccess) return (int)err;
  // the ring kernel counts a warp's features (K * ceil(kappa / its warps)) in 32 bits
  if (depth && (long long)K * (kappa / (32LL * blocks) + 1) > INT_MAX) return (int)cudaErrorInvalidValue;
  SparseSlots L{values, rows, n_feat, m, nnz_max};
  ChunkArgs a = chunk_args(y, r0, s0, f0, q0, delta, idx, zty_s, zn2_s, m, K, kappa, k0,
                           max_iters, refresh_every, eps_den, gap_rtol, i_star, recs, no_prog,
                           r_out, s_out, partials, alpha_s, l2);
  void* direct[] = {&L, &a};
  void* ring[] = {&L, &a, &stride};
  return coop_launch(c.kernel, c.threads, c.smem, depth ? ring : direct, blocks, stream);
}

extern "C" int fused_replay_launch(float* beta, long long p, const float* scale,
                                   const float* maxabs, const float* step_inf, const int* stall,
                                   const long long* i_star, const float* lam,
                                   long long lam_stride, const float* dt, long long dt_stride,
                                   const unsigned char* no_prog, int K, long long k0,
                                   long long max_iters, float renorm_threshold, float eps_den,
                                   float tol, float* f_out, int* stall_out, void* stream) {
  fused_replay_kernel<<<1, RP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      beta, p, scale, maxabs, step_inf, stall, i_star, lam, lam_stride, dt, dt_stride,
      no_prog, K, k0, max_iters, renorm_threshold, eps_den, tol, f_out, stall_out);
  return (int)cudaGetLastError();
}

// A kernel that does nothing, for timing a launch on its own.
__global__ void empty_kernel() {}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
