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
// Scalar algebra: every op is a separate _rn intrinsic in the op order of
// core/fw_lasso.py (ls_closed_form, sf_recursion) and core/engine.py
// (apply_coeff_update), so nvcc cannot contract into FMAs. The dense scores
// go through warp_row_score, K2's per-row dot, and its residual update is
// K3's op sequence; the sparse scores go through warp_slot_score, K5's
// slot dot, or the ring's copy of its order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int FC_THREADS = 512;  // fused_chunk_kernel's block
constexpr int FC_WARPS = FC_THREADS / 32;
constexpr int REC = 8;  // record row: lam, delta_t, raw, sel, stall flag, 0, 0, 0
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

// torch's NaN rules: maximum/clamp propagate NaN, sign(NaN) = 0
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.f), 1.f);
}
__device__ __forceinline__ float sign_of(float g) {
  return (float)((0.f < g) - (g < 0.f));
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
// sparse.ops.sparse_residual_update, out = (1 - lam) r + lam y over m and
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
};

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
template <int THREADS, class Layout>
__device__ __forceinline__ void end_step(const Layout& L, const ChunkArgs& a,
                                         cg::grid_group& grid, StepShared<THREADS / 32>& sh,
                                         float* rs, const float* yv, int s, float mag,
                                         long long j, float raw, float delta, float& S,
                                         float& F) {
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
    const float g = raw;  // lasso: the selected score is the linear one
    const float dt = __fmul_rn(-delta, sign_of(g));
    const float g_lin = __fadd_rn(g, zty);
    // ls_closed_form (eq. 8)
    const float dtg = __fmul_rn(dt, g);
    const float num = __fsub_rn(__fsub_rn(S, dtg), F);
    const float den = __fadd_rn(__fsub_rn(S, __fmul_rn(__fmul_rn(2.f, dt), g_lin)),
                                __fmul_rn(__fmul_rn(dt, dt), zn2));
    const float lam = clamp01(__fdiv_rn(num, clamp_min_nan(den, a.eps_den)));
    const float gap_scale = __fadd_rn(__fadd_rn(S, fabsf(F)), fabsf(dtg));
    const bool no_prog = num <= __fmul_rn(a.gap_rtol, gap_scale);
    const long long kg = a.k0 + s;
    const bool active = kg < a.max_iters;
    if (active) {
      // sf_recursion
      const float one_m = __fsub_rn(1.f, lam);
      const float sa = __fmul_rn(__fmul_rn(one_m, one_m), S);
      const float sb = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, dt), lam), one_m), g_lin);
      const float sc = __fmul_rn(__fmul_rn(__fmul_rn(dt, dt), __fmul_rn(lam, lam)), zn2);
      S = __fadd_rn(__fadd_rn(sa, sb), sc);
      F = __fadd_rn(__fmul_rn(one_m, F), __fmul_rn(__fmul_rn(dt, lam), zty));
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
      rec[2] = g;
      rec[3] = g;
      rec[4] = no_prog ? 1.f : 0.f;
      rec[5] = rec[6] = rec[7] = 0.f;
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

// Block 0 writes the final residual and (S, F, Q).
template <int THREADS>
__device__ __forceinline__ void end_chunk(const ChunkArgs& a, const float* rs, float S,
                                          float F) {
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < a.m; i += THREADS) a.r_out[i] = rs[i];
  if (threadIdx.x == 0) {
    a.s_out[0] = S;
    a.s_out[1] = F;
    a.s_out[2] = *a.q0;
  }
}

// K4, and K7 where no ring fits: every warp scores the sampled coordinates
// c = its grid-wide warp index + multiples of the grid's warps straight
// from device memory, one coordinate at a time, against its block's copy
// of the residual.
template <class Layout>
__global__ void __launch_bounds__(FC_THREADS, 2)
fused_chunk_kernel(Layout L, ChunkArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                     // this block's live residual (m)
  float* ys = smem + ((a.m + 3) & ~3);  // y (m), when the layout stages it
  const float* yv = Layout::kStageY ? ys : a.y;
  __shared__ StepShared<FC_WARPS> sh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < a.m; i += FC_THREADS) {
    rs[i] = a.r0[i];
    if (Layout::kStageY) ys[i] = a.y[i];
  }
  // the scalar state lives in thread 0 of every block
  float S = *a.s0, F = *a.f0;
  const float delta = *a.delta;
  __syncthreads();

  const long long gwarp = (long long)blockIdx.x * FC_WARPS + warp;
  const long long nwarps = (long long)gridDim.x * FC_WARPS;
  for (int s = 0; s < a.K; ++s) {
    const long long* ids = a.idx + (long long)s * a.kappa;
    float mag = -INFINITY, raw = 0.f;
    long long j = LLONG_MAX;
    for (long long c = gwarp; c < a.kappa; c += nwarps) {
      const float sc = L.score(ids[c], rs, lane);
      if (better(fabsf(sc), c, mag, j)) {
        mag = fabsf(sc);
        j = c;
        raw = sc;
      }
    }
    end_step<FC_THREADS>(L, a, grid, sh, rs, yv, s, mag, j, raw, delta, S, F);
  }
  end_chunk<FC_THREADS>(a, rs, S, F);
}

// K7 where a ring fits beside the residual: one block of 1024 threads a
// SM, each warp with a ring of RING_DEPTH stages of its own in shared
// memory. Every step splits its kappa positions into one contiguous run
// per warp of the grid, [lo, lo + n), taken two features at a time: half
// h of the warp (lanes 16 h .. 16 h + 15) scores feature 2 pi + h of pair
// pi. A feature comes in pieces of `slots` (nnz_max up to 124, or a
// multiple of 32: kernels/fused_step.py's plan); the pairs' pieces stream,
// without a break at the step boundaries, through the warp's ring, a
// pair's piece a tick:
//
//  - ids: lane l holds the id of feature 32 w + l of the warp's sequence
//    (step q / n, position lo + q % n) for the window w of the pair
//    fetched next and the window after it (one load a lane per 32
//    features, handed out by shuffles);
//  - tick u reads stage u % D and then starts the row slots of tick
//    u + D/2's pieces (whose values have landed) and the value slots of
//    tick u + D's into the stage just read, one cp.async group a tick, so
//    waiting until at most D/2 - 1 groups pend brings both;
//  - a stage holds, for each half, the 16-byte chunks that cover its
//    piece (a feature's slots start at 4 * nnz_max * f bytes, 16-byte
//    aligned only for some f): lane q of the half copies value chunks q
//    and q + 16 and, beside them, the same row chunks, but only where one
//    of the chunk's 4 values is nonzero (sign bit ignored): a zero-filled
//    row chunk makes a padded slot or a stored zero gather rs[0] * 0, an
//    exact 0 for a finite residual, as the plain dot's rs[row] * 0 does.
//    Lane q = 0 writes the piece's place and slots (0 for an id outside
//    [0, n_feat), which scores -0 without a read) to its Meta;
//  - lane q sums slot_dot's lane-q and lane-(q + 16) partials (slots
//    q + 32 t and q + 16 + 32 t, in order, across the pieces), adds them
//    and finishes warp_sum's butterfly in the half (xor 8, 4, 2, 1): the
//    same additions of the same operands as warp_slot_score, so the same
//    bits.
//
// So the last ticks of step s have already started the first pieces of
// step s + 1, which land during the step's grid sync, reduction and O(m)
// residual pass; only their gathers wait for it.
constexpr int RING_DEPTH = 4;

struct Meta {
  long long at;  // the first chunk's first float in the arrays
  int sh;        // where the piece starts in its first chunk (0-3)
  int cnt;       // the piece's slots; 0: nothing to read
};

template <int NT>
__global__ void __launch_bounds__(1024, 1)
sparse_ring_chunk_kernel(SparseSlots L, ChunkArgs a, int stride) {
  constexpr int THREADS = 1024, WARPS = THREADS / 32, D = RING_DEPTH, HALF = D / 2;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  __shared__ StepShared<WARPS> sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, h = lane >> 4, q = lane & 15;
  const int nnz = L.nnz_max;
  const int ps = nnz <= 32 * NT ? nnz : 32 * NT;  // slots a piece
  const int pieces = (nnz + ps - 1) / ps;
  const long long total = L.n_feat * nnz;  // floats in each array
  float* rs = smem;  // this block's live residual (m)
  float* ring = smem + ((a.m + 3) & ~3) + (size_t)warp * D * 4 * stride;
  Meta* meta = reinterpret_cast<Meta*>(smem + ((a.m + 3) & ~3) + (size_t)WARPS * D * 4 * stride) +
               warp * D * 2;
  auto half_stage = [&](int st) { return ring + (st * 4 + 2 * h) * stride; };  // values, rows
  for (int i = tid; i < a.m; i += THREADS) rs[i] = a.r0[i];
  float S = *a.s0, F = *a.f0;
  const float delta = *a.delta;

  // the warp's sequence has K * n < 2^31 features (sparse_fused_chunk_launch)
  const long long nw = (long long)gridDim.x * WARPS, gw = (long long)blockIdx.x * WARPS + warp;
  const long long lo = gw * a.kappa / nw;
  const int n = (int)((gw + 1) * a.kappa / nw - lo), npairs = (n + 1) / 2, total_q = n * a.K;
  auto window = [&](int w) -> long long {  // the id of feature 32 w + lane
    const int f = 32 * w + lane;
    if (f >= total_q) return -1;
    const int s = f / n;
    return a.idx[s * a.kappa + lo + (f - s * n)];
  };
  long long win = window(0), win_next = window(1);
  int wcur = 0;
  // the value cursor: step vs, pair vpi (its first feature vqa in the
  // sequence), piece vp; vfirst: this half's feature's first slot (or -1)
  long long vfirst = -1;
  int vs = 0, vpi = 0, vqa = 0, vp = 0;

  auto clamp = [&](long long at) { return (int)min(16LL, 4 * (total - at)); };
  auto fetch_values = [&](int st) {  // the next tick's value chunks into stage st
    Meta mm{0, 0, 0};
    if (vs < a.K) {
      if (vp == 0) {
        const int f = vqa + h;
        const long long f0 = __shfl_sync(0xffffffffu, win, f & 31);
        const long long f1 = __shfl_sync(0xffffffffu, win_next, f & 31);
        const long long id = (f >> 5) == wcur ? f0 : f1;
        vfirst = 2 * vpi + h < n && id >= 0 && id < L.n_feat ? id * nnz : -1;
      }
      if (vfirst >= 0) {
        const long long g0 = vfirst + (long long)ps * vp;
        mm.sh = (int)(g0 & 3);
        mm.at = g0 - mm.sh;
        mm.cnt = min(ps, nnz - ps * vp);
      }
      if (++vp == pieces) {
        vp = 0;
        if (++vpi == npairs) {
          vpi = 0;
          vqa = ++vs * n;
        } else {
          vqa += 2;
        }
        if ((vqa >> 5) > wcur) {  // a pair moves on by at most 2 features
          win = win_next;
          win_next = window(++wcur + 1);
        }
      }
    }
    if (q == 0) meta[st * 2 + h] = mm;
    const int nch = (mm.sh + mm.cnt + 3) >> 2;
    float* vdst = half_stage(st);
#pragma unroll
    for (int c = q; c < 32; c += 16)
      if (c < nch) cp_async16_n(vdst + 4 * c, L.values + mm.at + 4 * c, clamp(mm.at + 4 * c));
  };
  auto fetch_rows = [&](int st) {  // stage st's row chunks, beside its stored values
    const Meta mm = meta[st * 2 + h];
    const int nch = (mm.sh + mm.cnt + 3) >> 2;
    float* vsrc = half_stage(st);
#pragma unroll
    for (int c = q; c < 32; c += 16) {
      if (c < nch) {  // value chunk c came by this lane's own copy
        const uint4 w = *reinterpret_cast<const uint4*>(vsrc + 4 * c);
        const bool stored = ((w.x | w.y | w.z | w.w) & 0x7fffffffu) != 0;
        cp_async16_n(vsrc + stride + 4 * c, L.rows + mm.at + 4 * c,
                     stored ? clamp(mm.at + 4 * c) : 0);
      }
    }
  };

  // groups: the values of ticks 0 .. D-1, then the rows of 0 .. D/2-1,
  // then one a tick
  for (int t = 0; t < D; ++t) {
    fetch_values(t);
    cp_async_commit();
  }
  for (int t = 0; t < HALF; ++t) {
    cp_async_wait<D - 1>();  // tick t's values (this lane's chunks)
    __syncwarp();            // its Metas
    fetch_rows(t);
    cp_async_commit();
  }
  __syncthreads();  // the residual

  int cs = 0;  // the stage read next; its rows went out D/2 ticks before
  for (int s = 0; s < a.K; ++s) {
    float mag = -INFINITY, raw = 0.f;
    long long j = LLONG_MAX;
    for (int pi = 0; pi < npairs; ++pi) {
      float dot0 = 0.f, dot1 = 0.f;  // slot_dot's lane-q and lane-(q + 16) partials
      for (int pc = 0; pc < pieces; ++pc) {
        cp_async_wait<HALF - 1>();
        __syncwarp();  // every lane's chunks of stage cs, and its Metas
        const Meta mm = meta[cs * 2 + h];
        const float* vs_ = half_stage(cs) + mm.sh;
        const int* rw = reinterpret_cast<const int*>(vs_ + stride);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int k = q + 32 * t;
          if (k < mm.cnt) dot0 = fmaf(vs_[k], rs[rw[k]], dot0);
          if (k + 16 < mm.cnt) dot1 = fmaf(vs_[k + 16], rs[rw[k + 16]], dot1);
        }
        __syncwarp();  // stage cs read by every lane before it is refilled
        fetch_rows((cs + HALF) & (D - 1));
        fetch_values(cs);
        cp_async_commit();
        cs = (cs + 1) & (D - 1);
      }
      float v = dot0 + dot1;  // warp_sum's xor-16 level, then the rest in the half
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const float sc = -v;
      const long long c = lo + 2 * pi + h;
      if (2 * pi + h < n && better(fabsf(sc), c, mag, j)) {
        mag = fabsf(sc);
        j = c;
        raw = sc;
      }
    }
    end_step<THREADS>(L, a, grid, sh, rs, a.y, s, mag, j, raw, delta, S, F);
  }
  cp_async_wait<0>();
  end_chunk<THREADS>(a, rs, S, F);
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
        const float coef = __fdiv_rn(__fmul_rn(dt_t, lam_t), clamp_min_nan(scale, eps_den));
        const float bi = __fadd_rn(b_t, coef);
        if (ri == i_t) rb = bi;
        const float alpha_new = __fmul_rn(scale, bi);
        step_inf = __fmul_rn(lam_t, nan_max(maxabs, fabsf(__fsub_rn(dt_t, a_star))));
        maxabs = nan_max(__fmul_rn(one_m, maxabs), fabsf(alpha_new));
        stall = (step_inf <= tol || np_t) ? stall + 1 : 0;
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

// Dynamic shared memory of fused_chunk_kernel: the residual, and y beside
// it when the layout stages y.
template <class Layout>
static size_t chunk_smem_bytes(int m) {
  return (size_t)(((m + 3) & ~3) + (Layout::kStageY ? m : 0)) * sizeof(float);
}

// Dynamic shared memory of sparse_ring_chunk_kernel: the residual, then
// each warp's RING_DEPTH stages of two pieces' `stride` value and `stride`
// row slots, then their Metas (kernels/fused_step.py's
// RingPlan.smem_bytes).
static size_t ring_smem_bytes(int m, int stride) {
  return ((size_t)((m + 3) & ~3) + (size_t)32 * RING_DEPTH * 4 * stride) * sizeof(float) +
         (size_t)32 * RING_DEPTH * 2 * sizeof(Meta);
}

// K7's kernel for a plan: depth 0, fused_chunk_kernel (512 threads);
// otherwise the ring kernel (1024 threads) of ceil(slots / 32) slots a
// lane.
struct SparseChoice {
  const void* kernel;
  int threads;
  size_t smem;
  GridCache* cache;
};

static cudaError_t sparse_choice(int m, int nnz_max, int threads, int depth, int slots,
                                 int stride, SparseChoice* out) {
  static GridCache caches[5];
  if (depth == 0) {
    if (threads != FC_THREADS || slots != 0 || stride != 0) return cudaErrorInvalidValue;
    *out = {(const void*)fused_chunk_kernel<SparseSlots>, FC_THREADS,
            chunk_smem_bytes<SparseSlots>(m), &caches[0]};
  } else {
    const bool ok = nnz_max >= 1 && threads == 1024 && depth == RING_DEPTH &&
                    (slots == nnz_max ? slots <= 124 : slots % 32 == 0 && slots < nnz_max) &&
                    slots <= 128 && stride % 4 == 0 && stride >= slots + 3;
    if (!ok) return cudaErrorInvalidValue;
    const void* kernels[] = {(const void*)sparse_ring_chunk_kernel<1>,
                             (const void*)sparse_ring_chunk_kernel<2>,
                             (const void*)sparse_ring_chunk_kernel<3>,
                             (const void*)sparse_ring_chunk_kernel<4>};
    const int nt = (slots + 31) / 32;
    *out = {kernels[nt - 1], 1024, ring_smem_bytes(m, stride), &caches[nt]};
  }
  return out->smem > OPTIN_SMEM_BYTES ? cudaErrorInvalidValue : cudaSuccess;
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
                            float* r_out, float* s_out, void* partials) {
  return ChunkArgs{y,         r0,      s0,         f0,       q0,      delta,
                   idx,       zty_s,   zn2_s,      m,        K,       kappa,
                   k0,        max_iters, refresh_every, eps_den, gap_rtol, i_star,
                   recs,      no_prog, r_out,      s_out,    static_cast<Partial*>(partials)};
}

extern "C" int dense_fused_chunk_blocks(int m, int* blocks) {
  static GridCache cache;
  return coop_blocks((const void*)fused_chunk_kernel<DenseRows>, FC_THREADS,
                     chunk_smem_bytes<DenseRows>(m), &cache, blocks);
}

extern "C" int sparse_fused_chunk_blocks(int m, int nnz_max, int threads, int depth, int slots,
                                         int stride, int* blocks) {
  SparseChoice c;
  cudaError_t err = sparse_choice(m, nnz_max, threads, depth, slots, stride, &c);
  if (err != cudaSuccess) return (int)err;
  return coop_blocks(c.kernel, c.threads, c.smem, c.cache, blocks);
}

extern "C" int dense_fused_chunk_launch(const float* X, long long p, const float* y,
                                        const float* r0, const float* s0, const float* f0,
                                        const float* q0, const float* delta,
                                        const long long* idx, const float* zty_s,
                                        const float* zn2_s, int m, int K, long long kappa,
                                        long long k0,
                                        long long max_iters, int refresh_every, float eps_den,
                                        float gap_rtol, long long* i_star, float* recs,
                                        unsigned char* no_prog, float* r_out, float* s_out,
                                        void* partials, int blocks, void* stream) {
  DenseRows L{X, p, m, rows_vectorizable<float>(X, m)};
  ChunkArgs a = chunk_args(y, r0, s0, f0, q0, delta, idx, zty_s, zn2_s, m, K, kappa, k0,
                           max_iters, refresh_every, eps_den, gap_rtol, i_star, recs, no_prog,
                           r_out, s_out, partials);
  void* args[] = {&L, &a};
  return coop_launch((const void*)fused_chunk_kernel<DenseRows>, FC_THREADS,
                     chunk_smem_bytes<DenseRows>(m), args, blocks, stream);
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
                                         void* partials, int blocks, void* stream) {
  SparseChoice c;
  cudaError_t err = sparse_choice(m, nnz_max, threads, depth, slots, stride, &c);
  if (err != cudaSuccess) return (int)err;
  // the ring kernel counts a warp's features (K * ceil(kappa / its warps)) in 32 bits
  if (depth && (long long)K * (kappa / (32LL * blocks) + 1) > INT_MAX) return (int)cudaErrorInvalidValue;
  SparseSlots L{values, rows, n_feat, m, nnz_max};
  ChunkArgs a = chunk_args(y, r0, s0, f0, q0, delta, idx, zty_s, zn2_s, m, K, kappa, k0,
                           max_iters, refresh_every, eps_den, gap_rtol, i_star, recs, no_prog,
                           r_out, s_out, partials);
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
