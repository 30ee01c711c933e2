// stage_probe.cu — the stage probe's units (K8a-K8f) for Hopper (sm_90a).
//
// Replaces: nomad_tpu/parallel/stage_probe.py `_stage_fns` (:56: the
// jitted `feasibility` :65, `fit` :73, `score` :77, `argmax` :95 and
// `scatter` :109) and `probe_fused`'s `fused_wave` (:196, the wave grid
// of ops/place.py `bulk_wave_grid` + `bulk_run_lengths` + order +
// scatter in one program).  The plain PyTorch versions are
// nomad_tpu_torch/ops/stage_probe.py `*_plain`; `argmax_model` and
// `fused_wave_model` there are K8d's and K8f's algorithm in PyTorch.
//
// These reproduce the probe, not production's wave: the probe has no
// strict set, and its scatter does not mask the run lengths by the wave
// set (`run[order]`), so rows outside the wave take instances after the
// wave rows, in row order (ROADMAP queue C).
//
// What bounds them on this card, at the bench's shape (N = 10,000, M =
// 16, R = 4): K8a-K8c are elementwise with an R-wide reduction, and
// bound by bytes (K8a writes the f32[N, M, R] grid, 2.6 MB; K8b reads its
// cpu and mem columns back: 8 bytes of each 16-byte cell, but a 32-byte
// sector brings all 16; K8c reads the fit and writes the score, 8 bytes a
// cell).  K8a-K8c are one thread per (row, m) cell in 32-bit index
// arithmetic; K8a reads a row as float4 and stores a cell's usage as one
// float4, so a warp's stores are 512 contiguous bytes (a thread taking 4
// cells of a row, its stores 64 bytes apart across lanes, measured
// slower: PERF.md); K8b loads a cell's (cpu, mem) as one float2.  K8e
// is one cluster of PROBE_CLUSTER blocks over the greedy positions: one
// cluster scan of run[order[k]] gives each position its prefix, and the
// thread of position k writes row order[k] (a 16-byte usage row and its
// co-placements) directly; order is a permutation, so each row is
// written once, and no pass over the rows follows.  K8d and K8f are
// bound by latency: a top-2 over every row, then each row's run and its
// place in the greedy order, each step waiting on the one before across
// all rows.  The reference's order is a stable
// argsort of where(wave, -cur, +inf), and every wave row has cur == top1,
// so its keys take two values: the order is a stable partition (the wave
// rows in row order, then the others in row order), and a row's place in
// it is a prefix count in row order.  So K8d and K8f sort nothing: one
// thread-block cluster of PROBE_CLUSTER blocks (a row a thread up to
// 16,384 rows, a few contiguous rows a thread past that) takes the top-2
// (warp, block, then the blocks' results through distributed shared
// memory) and one exclusive scan of a pair of ints a row in row order
// (block scan, then a prefix over the blocks' totals through
// distributed shared memory): three cluster barriers in all.  K8f
// evaluates a row's m = 1 cell once and keeps it in registers (RPT rows
// a thread; rows past those, only past 131,072 rows, evaluate their
// cells again in the later passes), and spreads the cells over the
// cluster's SMs.
//
// Numerics: -fmad=false, powf, fit/18 as a multiply by the f32
// reciprocal 1.0f/18.0f (what XLA compiles the reference's division by
// that constant into), and every other division a true division, in the
// reference's order of operations.  The top-2 ranks in lax.top_k's
// total order (a NaN by its sign: the card's +NaN above +inf).

#include <cooperative_groups.h>

#include "bulk_common.cuh"
#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = 4;              // resource dims (cpu, mem, disk, net)
// blocks of K8d's, K8e's and K8f's cluster: 16, past the portable 8
// (allowed by cluster_launch), measured faster than 8 for K8d and K8f at
// 10,000 to 131,072 rows (PERF.md)
constexpr int PROBE_CLUSTER = 16;
constexpr int RPT = 8;            // rows a K8e/K8f thread keeps in registers
constexpr int FEAS_NT = 256;      // threads of a K8a block
constexpr int FIT_NT = 256;       // threads of a K8b block
constexpr int SCORE_NT = 256;     // threads of a K8c block

// K8d's, K8e's and K8f's cluster exchange: the warps' parts, the block's
// part the other blocks read, and the cluster's result for the block.
struct PartShared {
  unsigned ka[NW], kb[NW];        // warps' top-2 keys
  int sx[NW], sy[NW];             // warps' pair sums
  unsigned top[2];                // the block's top-2 keys (read remotely)
  int tot[2];                     // the block's pair totals (read remotely)
  unsigned gtop[2];               // the cluster's top-2 keys
  int gpre[2], gall[2];           // the lower blocks' totals, all blocks'
};

// The anti-affinity divisor: the reference's jnp.maximum(desired_f, 1),
// which keeps a NaN (fmaxf alone gives 1 for one).
__host__ __device__ __forceinline__ float desired_div(float desired_f) {
  return desired_f != desired_f ? desired_f : fmaxf(desired_f, 1.0f);
}

// The score stack of one cell from its fit (the reference's `score`).
__device__ __forceinline__ float cell_score(float fit, int coll, float m,
                                            float div, float pen,
                                            bool aff_on, float aff) {
  // -(coll_m + 1) / div as XLA compiles the reference: (x - 1) + 1
  // folded to x, which differs once coll + m passes 2^24
  const float coll_1 = (float)coll + m;
  const float coll_m = coll_1 - 1.0f;
  float total = fit;
  float n_sc = 1.0f;
  const float anti = -coll_1 / div;
  const bool has_coll = coll_m > 0.0f;
  total = total + (has_coll ? anti : 0.0f);
  n_sc = n_sc + (has_coll ? 1.0f : 0.0f);
  total = total - pen;
  n_sc = n_sc + pen;
  total = total + (aff_on ? aff : 0.0f);
  n_sc = n_sc + (aff_on ? 1.0f : 0.0f);
  return total / n_sc;
}

// util = used + m * demand and its fit check (the reference's
// `feasibility`), for one row and one m
__device__ __forceinline__ bool cell_util(const float* cap, const float* used,
                                          const float* dem, float m,
                                          float* u) {
  bool f = true;
#pragma unroll
  for (int d = 0; d < R; ++d) {
    const float md = m * dem[d];
    u[d] = used[d] + md;
    f = f && (u[d] <= cap[d]);
  }
  return f;
}

// K8a: util_m f32[N, M, R], fits_m bool[N, M], a thread a cell c = i *
// M + m (32-bit index arithmetic: the launch keeps N * M below 2^31).
// The row's capacity and usage are read as float4 (the wrapper refuses
// unaligned rows; the M threads of a row read the same 32 bytes), the
// cell's usage is one float4 store, so a warp stores 512 contiguous
// bytes, and its fit one byte (32 contiguous bytes a warp).
__global__ void __launch_bounds__(FEAS_NT)
feasibility_kernel(const float4* __restrict__ cap,
                   const float4* __restrict__ used,
                   const float* __restrict__ demand,
                   const uint8_t* __restrict__ feasible,
                   const float* __restrict__ ms, int n, int M,
                   float4* __restrict__ util_m,
                   uint8_t* __restrict__ fits_m) {
  const unsigned c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (unsigned)n * (unsigned)M) return;
  const unsigned i = c / (unsigned)M;
  const float dem[R] = {demand[0], demand[1], demand[2], demand[3]};
  const float4 c4 = cap[i], u4 = used[i];
  const float cp[R] = {c4.x, c4.y, c4.z, c4.w};
  const float us[R] = {u4.x, u4.y, u4.z, u4.w};
  float u[R];
  const bool f = cell_util(cp, us, dem, ms[c - i * (unsigned)M], u);
  util_m[c] = make_float4(u[0], u[1], u[2], u[3]);
  fits_m[c] = (f && feasible[i] != 0) ? 1 : 0;
}

// K8b: fit_m f32[N, M] = score_fit(cap, util_m, binpack) / 18.  A thread
// a cell in 32-bit arithmetic (the launch keeps N * M below 2^31), so a
// warp's 32 consecutive cells coalesce (a thread taking adjacent cells
// spreads a warp's accesses apart: a K8a draft so made measured slower,
// PERF.md).  The fit reads only cpu and mem: one 8-byte load of the
// cell's (cpu, mem) usage and one of its row's capacity (the wrapper
// refuses rows that are not 16-byte aligned), and a 4-byte store.
__global__ void __launch_bounds__(FIT_NT)
fit_kernel(const float2* __restrict__ cap, const float2* __restrict__ util_m,
           unsigned cells, unsigned M, float* __restrict__ fit_m) {
  const unsigned c = blockIdx.x * FIT_NT + threadIdx.x;
  if (c >= cells) return;
  static_assert(RES_CPU == 0 && RES_MEM == 1, "(cpu, mem) lead a row");
  const float2 u = util_m[(size_t)c * (R / 2)];
  const float2 cp = cap[(size_t)(c / M) * (R / 2)];
  const float uu[2] = {u.x, u.y}, cc[2] = {cp.x, cp.y};
  fit_m[c] = score_fit(cc, uu, 0) * (1.0f / 18.0f);
}

// K8c: score_m f32[N, M], a thread a cell c = i * M + m in 32-bit
// arithmetic (the launch keeps N * M below 2^31), the row one 32-bit
// division by M, so a warp's 32 consecutive cells read fit_m and write
// score_m as 128 contiguous bytes.  The cells of a row in a warp load
// its collisions, penalty and affinity at one address each, which the
// card serves as one request a warp (a form with one lane a row loading
// them and shuffles handing them out measured slower, as did 2 and 4
// cells a thread at the bench's 10,000 x 16 and blocks of 128, 512 or
// 1,024 threads: PERF.md).  `div` is the host's desired_div(desired_f).
__global__ void __launch_bounds__(SCORE_NT)
score_kernel(const float* __restrict__ fit_m, const int* __restrict__ coll,
             const float* __restrict__ ms, float div,
             const float* __restrict__ penalty,
             const float* __restrict__ affinity, int has_affinity,
             unsigned cells, unsigned M, float* __restrict__ score_m) {
  const unsigned c = blockIdx.x * SCORE_NT + threadIdx.x;
  if (c >= cells) return;
  const unsigned i = c / M;
  const float aff = affinity[i];
  score_m[c] = cell_score(fit_m[c], coll[i], ms[c - i * M], div, penalty[i],
                          has_affinity != 0 && aff != 0.0f, aff);
}

// ------------------------------------- K8d, K8e and K8f: the cluster

// This thread's rows [lo, hi): block `rank` of the cluster owns a
// contiguous range of the n rows, its threads contiguous runs of it in
// thread order, so thread order within the cluster is row order.
__device__ __forceinline__ void thread_rows(int n, cg::cluster_group& cl,
                                            int* lo, int* hi) {
  const int blocks = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int rpb = (n + blocks - 1) / blocks;
  const int blo = min(rank * rpb, n), bhi = min(blo + rpb, n);
  const int per = (bhi - blo + (int)blockDim.x - 1) / (int)blockDim.x;
  *lo = min(blo + (int)threadIdx.x * per, bhi);
  *hi = min(*lo + per, bhi);
}

// The cluster's top-2 keys (lax.top_k's order) of every thread's (a, b),
// in every thread: warps, then the block, stored for the other blocks;
// one cluster barrier; each block merges all blocks' parts.
template <bool J>
__device__ void cluster_top2(unsigned& a, unsigned& b, PartShared& sm,
                             cg::cluster_group& cl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (int)blockDim.x >> 5;
  warp_key_top2(a, b);
  jitter<J>(1);
  if (lane == 0) {
    sm.ka[warp] = a;
    sm.kb[warp] = b;
  }
  __syncthreads();
  jitter<J>(2);
  if (warp == 0) {
    a = lane < nw ? sm.ka[lane] : 0u;
    b = lane < nw ? sm.kb[lane] : 0u;
    warp_key_top2(a, b);
    jitter<J>(3);
    if (lane == 0) {
      sm.top[0] = a;
      sm.top[1] = b;
    }
  }
  cl.sync();                      // every block's top-2 is stored
  jitter<J>(4);
  if (warp == 0) {
    a = b = 0u;
    if (lane < (int)cl.num_blocks()) {
      const unsigned* t = cl.map_shared_rank(sm.top, lane);
      a = t[0];
      b = t[1];
    }
    warp_key_top2(a, b);
    jitter<J>(5);
    if (lane == 0) {
      sm.gtop[0] = a;
      sm.gtop[1] = b;
    }
  }
  __syncthreads();
  jitter<J>(6);
  a = sm.gtop[0];
  b = sm.gtop[1];
}

// inclusive warp scan of a pair
__device__ __forceinline__ void warp_scan2(int& x, int& y) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int px = __shfl_up_sync(0xffffffffu, x, o);
    const int py = __shfl_up_sync(0xffffffffu, y, o);
    if (lane >= o) {
      x += px;
      y += py;
    }
  }
}

// The exclusive prefix, in row order, of every thread's pair v over the
// cluster's threads; *all gets the cluster's totals.  A block scan, the
// block's totals stored for the other blocks, one cluster barrier, then
// each block's warp 0 sums the totals of the blocks before it.  Every
// thread arrives at the cluster barrier's first half after its block's
// last remote read: the kernel waits on it before it exits.
template <bool J>
__device__ int2 cluster_scan2(int2 v, PartShared& sm, cg::cluster_group& cl,
                              int2* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (int)blockDim.x >> 5;
  const int rank = (int)cl.block_rank();
  int x = v.x, y = v.y;
  warp_scan2(x, y);
  jitter<J>(7);
  if (lane == 31) {
    sm.sx[warp] = x;
    sm.sy[warp] = y;
  }
  __syncthreads();
  jitter<J>(8);
  int wx = lane < nw ? sm.sx[lane] : 0, wy = lane < nw ? sm.sy[lane] : 0;
  warp_scan2(wx, wy);
  // this thread's exclusive prefix within the block, and the block's total
  const int bx = __shfl_sync(0xffffffffu, wx, 31);
  const int by = __shfl_sync(0xffffffffu, wy, 31);
  const int px = __shfl_sync(0xffffffffu, wx, (warp + 31) & 31);
  const int py = __shfl_sync(0xffffffffu, wy, (warp + 31) & 31);
  int2 ex = make_int2((warp ? px : 0) + x - v.x, (warp ? py : 0) + y - v.y);
  if (threadIdx.x == 0) {
    jitter<J>(9);
    sm.tot[0] = bx;
    sm.tot[1] = by;
  }
  cl.sync();                      // every block's totals are stored
  jitter<J>(10);
  if (warp == 0) {
    int tx = 0, ty = 0;
    if (lane < (int)cl.num_blocks()) {
      const int* t = cl.map_shared_rank(sm.tot, lane);
      tx = t[0];
      ty = t[1];
    }
    warp_scan2(tx, ty);
    const int ax = __shfl_sync(0xffffffffu, tx, 31);
    const int ay = __shfl_sync(0xffffffffu, ty, 31);
    const int qx = __shfl_sync(0xffffffffu, tx, (rank + 31) & 31);
    const int qy = __shfl_sync(0xffffffffu, ty, (rank + 31) & 31);
    jitter<J>(11);
    if (lane == 0) {
      sm.gpre[0] = rank ? qx : 0;
      sm.gpre[1] = rank ? qy : 0;
      sm.gall[0] = ax;
      sm.gall[1] = ay;
    }
  }
  cluster_arrive();               // no more reads of other blocks
  __syncthreads();
  jitter<J>(12);
  ex.x += sm.gpre[0];
  ex.y += sm.gpre[1];
  *all = make_int2(sm.gall[0], sm.gall[1]);
  return ex;
}

// K8d: run i32[N] (leading m's that fit and beat `second`, m = 1
// forced) and order i32[N] (stable argsort of where(wave, -cur, inf)):
// a row's place in the order is its wave count or its count outside the
// wave before it in row order (the pair scan), the wave rows first.
template <bool J>
__global__ void __launch_bounds__(NT, 1)
argmax_kernel(const uint8_t* __restrict__ fits_m,
              const float* __restrict__ score_m,
              const float* __restrict__ ms, int n, int M,
              int* __restrict__ run, int* __restrict__ order) {
  __shared__ PartShared sm;
  cg::cluster_group cl = cg::this_cluster();
  int lo, hi;
  thread_rows(n, cl, &lo, &hi);
  auto cur_of = [&](int i) -> float {
    const size_t r0 = (size_t)i * M;
    return fits_m[r0] ? score_m[r0] : -INFINITY;
  };

  unsigned ka = 0u, kb = 0u;
  for (int i = lo; i < hi; ++i) key_top2_push(ka, kb, orderable(cur_of(i)));
  cluster_top2<J>(ka, kb, sm, cl);
  const float top1 = from_orderable(ka), top2 = from_orderable(kb);

  int2 c = make_int2(0, 0);       // rows in the wave, rows outside it
  for (int i = lo; i < hi; ++i) {
    const size_t r0 = (size_t)i * M;
    const bool fits = fits_m[r0] != 0;
    const float cur = fits ? score_m[r0] : -INFINITY;
    const float second = (cur == top1) ? top2 : top1;
    int r = 0;
    for (int m = 0; m < M; ++m) {
      const bool ok = fits_m[r0 + m] != 0 &&
                      (score_m[r0 + m] > second || ms[m] == 1.0f);
      if (!ok) break;
      r = m + 1;
    }
    run[i] = r;
    if (fits && cur == top1) ++c.x; else ++c.y;
  }
  int2 all;
  int2 pre = cluster_scan2<J>(c, sm, cl, &all);
  // Where top1 is -inf the wave rows' key -cur is +inf, every other
  // row's too: every key ties and the order is the rows' own.
  const bool ident = top1 == -INFINITY;
  for (int i = lo; i < hi; ++i) {
    const bool wave = cur_of(i) == top1 && fits_m[(size_t)i * M] != 0;
    const int k = wave ? pre.x++ : all.x + pre.y++;
    order[ident ? i : k] = i;
  }
  cluster_wait();                 // no block reads this one's totals now
}

// K8e: used2 f32[N, R], coll2 i32[N], placed i32.  One cluster whose
// threads own contiguous runs of the greedy positions k (thread order is
// position order): one cluster scan of run[order[k]] gives each
// position its exclusive prefix, and the thread of position k writes row
// order[k]: per_node = clip(count - prefix, 0, run), used2 = used +
// per_node * demand (one float4 load and store), coll2 = coll +
// per_node.  order is a permutation of the rows (the wrapper's
// contract), so every row is written exactly once, by one thread.  The
// prefix is held in 64 bits; placed is clip(count, 0, all runs), the sum
// of the clipped runs (runs are >= 0, K8d's).  A thread keeps its first
// RPT positions' rows and runs in registers and reads past those again.
template <bool J>
__global__ void __launch_bounds__(NT, 1)
scatter_kernel(const int* __restrict__ run, const int* __restrict__ order,
               int count, const float4* __restrict__ used,
               const float* __restrict__ demand,
               const int* __restrict__ coll, int n,
               float4* __restrict__ used2, int* __restrict__ coll2,
               int* __restrict__ placed) {
  __shared__ PartShared sm;
  cg::cluster_group cl = cg::this_cluster();
  int lo, hi;
  thread_rows(n, cl, &lo, &hi);
  const int cnt = hi - lo;
  int rows[RPT], runs[RPT];
  int local = 0;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (k < cnt) {
      rows[k] = order[lo + k];
      runs[k] = run[rows[k]];
      local += runs[k];
    }
  }
  for (int k = lo + RPT; k < hi; ++k) local += run[order[k]];
  int2 all;
  const int2 pre = cluster_scan2<J>(make_int2(local, 0), sm, cl, &all);
  const float dem[R] = {demand[0], demand[1], demand[2], demand[3]};
  long long prefix = pre.x;
  auto put = [&](int row, int r) {
    const int pn = (int)min(max((long long)count - prefix, 0ll),
                            (long long)r);
    prefix += r;
    const float pf = (float)pn;
    const float4 u = used[row];
    used2[row] = make_float4(u.x + pf * dem[0], u.y + pf * dem[1],
                             u.z + pf * dem[2], u.w + pf * dem[3]);
    coll2[row] = coll[row] + pn;
  };
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (k < cnt) put(rows[k], runs[k]);
  for (int k = lo + RPT; k < hi; ++k) {
    const int row = order[k];
    put(row, run[row]);
  }
  if (cl.block_rank() == 0 && threadIdx.x == 0)
    *placed = (int)min(max((long long)count, 0ll), (long long)all.x);
  cluster_wait();                 // no block reads this one's totals now
}

// K8f: the fused wave, K8a-K8e in one program without the [N, M] grid
// and without an order: each row's cells are evaluated on the fly, and a
// row's prefix in the greedy order comes from the pair scan of (its run
// if in the wave, its run if not): a wave row's is the wave runs before
// it, another row's the wave's total plus the other runs before it (all
// runs before it where top1 is -inf).  placed = clip(count, 0, all runs),
// the sum of the clipped runs.
template <bool J>
__global__ void __launch_bounds__(NT, 1)
fused_wave_kernel(const float* __restrict__ cap,
                  const float* __restrict__ used,
                  const float* __restrict__ demand,
                  const uint8_t* __restrict__ feasible,
                  const float* __restrict__ affinity, int has_affinity,
                  float desired_f, const float* __restrict__ penalty,
                  const int* __restrict__ coll, int count, int M, int n,
                  float* __restrict__ used2, int* __restrict__ coll2,
                  int* __restrict__ placed) {
  __shared__ PartShared sm;
  cg::cluster_group cl = cg::this_cluster();
  int lo, hi;
  thread_rows(n, cl, &lo, &hi);
  const int cnt = hi - lo;
  const float div = desired_div(desired_f);
  float dem[R];
#pragma unroll
  for (int d = 0; d < R; ++d) dem[d] = demand[d];

  // one cell of bulk_wave_grid: fits and score of row i with m placed
  auto cell = [&](int i, float m, float* score) -> bool {
    float u[R];
    const float* cp = cap + (size_t)i * R;
    const bool f = cell_util(cp, used + (size_t)i * R, dem, m, u) &&
                   feasible[i] != 0;
    const float fit = score_fit(cp, u, 0) * (1.0f / 18.0f);
    const float aff = affinity[i];
    *score = cell_score(fit, coll[i], m, div, penalty[i],
                        has_affinity != 0 && aff != 0.0f, aff);
    return f;
  };

  // the m = 1 cells: the first RPT rows' kept in registers
  float s1[RPT];
  unsigned f1 = 0u;
  unsigned ka = 0u, kb = 0u;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (k < cnt) {
      float s;
      const bool f = cell(lo + k, 1.0f, &s);
      s1[k] = s;
      f1 |= (f ? 1u : 0u) << k;
      key_top2_push(ka, kb, orderable(f ? s : -INFINITY));
    }
  }
  for (int i = lo + RPT; i < hi; ++i) {
    float s;
    const bool f = cell(i, 1.0f, &s);
    key_top2_push(ka, kb, orderable(f ? s : -INFINITY));
  }
  cluster_top2<J>(ka, kb, sm, cl);
  const float top1 = from_orderable(ka), top2 = from_orderable(kb);

  // a row's run (m = 1 forced, then while it fits and beats `second`)
  // and whether it is in the wave
  auto run_of = [&](int i, bool fits, float s_1, bool* wave) -> int {
    const float cur = fits ? s_1 : -INFINITY;
    const float second = (cur == top1) ? top2 : top1;
    *wave = fits && cur == top1;
    if (!fits) return 0;
    int r = 1;
    for (int m = 2; m <= M; ++m) {
      float s;
      if (!(cell(i, (float)m, &s) && s > second)) break;
      r = m;
    }
    return r;
  };
  int rn[RPT];
  unsigned wv = 0u;
  int2 c = make_int2(0, 0);       // runs in the wave, runs outside it
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (k < cnt) {
      bool w;
      rn[k] = run_of(lo + k, (f1 >> k) & 1u, s1[k], &w);
      wv |= (w ? 1u : 0u) << k;
      (w ? c.x : c.y) += rn[k];
    }
  }
  for (int i = lo + RPT; i < hi; ++i) {
    float s;
    const bool f = cell(i, 1.0f, &s);
    bool w;
    const int r = run_of(i, f, s, &w);
    (w ? c.x : c.y) += r;
  }
  int2 all;
  int2 pre = cluster_scan2<J>(c, sm, cl, &all);
  const bool ident = top1 == -INFINITY;   // every key ties (see K8d)

  // the row's instances: its run clipped by what the rows before it in
  // the greedy order took
  auto place = [&](int i, int r, bool w) {
    const long long prefix = ident ? (long long)pre.x + pre.y
                                   : (w ? pre.x : (long long)all.x + pre.y);
    (w ? pre.x : pre.y) += r;
    const int pn = (int)min(max((long long)count - prefix, 0ll),
                            (long long)r);
    const float pf = (float)pn;
#pragma unroll
    for (int d = 0; d < R; ++d) {
      const float inc = pf * dem[d];
      used2[(size_t)i * R + d] = used[(size_t)i * R + d] + inc;
    }
    coll2[i] = coll[i] + pn;
  };
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (k < cnt) place(lo + k, rn[k], (wv >> k) & 1u);
  for (int i = lo + RPT; i < hi; ++i) {
    float s;
    const bool f = cell(i, 1.0f, &s);
    bool w;
    const int r = run_of(i, f, s, &w);
    place(i, r, w);
  }
  if (cl.block_rank() == 0 && threadIdx.x == 0)
    *placed = (int)min(max((long long)count, 0ll),
                       (long long)all.x + all.y);
  cluster_wait();                 // no block reads this one's totals now
}

// K8d's, K8e's and K8f's cluster: PROBE_CLUSTER blocks of the fewest whole
// warps that give each thread one row (at most NT)
int probe_threads(int n) {
  const int rpb = (n + PROBE_CLUSTER - 1) / PROBE_CLUSTER;
  return min(NT, max(32, (rpb + 31) / 32 * 32));
}

}  // namespace

extern "C" int feasibility_launch(const float* cap, const float* used,
                                  const float* demand, const uint8_t* feasible,
                                  const float* ms, int n, int M,
                                  float* util_m, uint8_t* fits_m,
                                  void* stream) {
  const long long cells = (long long)n * M;
  if (n < 1 || M < 1 || cells >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  feasibility_kernel<<<(int)((cells + FEAS_NT - 1) / FEAS_NT), FEAS_NT, 0,
                       (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(cap),
      reinterpret_cast<const float4*>(used), demand, feasible, ms, n, M,
      reinterpret_cast<float4*>(util_m), fits_m);
  return (int)cudaGetLastError();
}

extern "C" int fit_launch(const float* cap, const float* util_m, int n, int M,
                          float* fit_m, void* stream) {
  const long long cells = (long long)n * M;
  if (n < 1 || M < 1 || cells >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned c = (unsigned)cells;
  fit_kernel<<<(c + FIT_NT - 1) / FIT_NT, FIT_NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(cap),
      reinterpret_cast<const float2*>(util_m), c, (unsigned)M, fit_m);
  return (int)cudaGetLastError();
}

extern "C" int score_launch(const float* fit_m, const int* coll,
                            const float* ms, float desired_f,
                            const float* penalty, const float* affinity,
                            int has_affinity, int n, int M, float* score_m,
                            void* stream) {
  const long long cells = (long long)n * M;
  if (n < 1 || M < 1 || cells >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned c = (unsigned)cells;
  score_kernel<<<(c + SCORE_NT - 1) / SCORE_NT, SCORE_NT, 0,
                 (cudaStream_t)stream>>>(
      fit_m, coll, ms, desired_div(desired_f), penalty, affinity,
      has_affinity, c, (unsigned)M, score_m);
  return (int)cudaGetLastError();
}

extern "C" int argmax_launch(const uint8_t* fits_m, const float* score_m,
                             const float* ms, int n, int M, int* run,
                             int* order, void* stream) {
  if (n < 2 || M < 1) return (int)cudaErrorInvalidValue;
  return (int)cluster_launch(
      jitter_on ? &argmax_kernel<true> : &argmax_kernel<false>,
      PROBE_CLUSTER, probe_threads(n), 0, 0, (cudaStream_t)stream, fits_m,
      score_m, ms, n, M, run, order);
}

extern "C" int scatter_launch(const int* run, const int* order, int count,
                              const float* used, const float* demand,
                              const int* coll, int n, float* used2,
                              int* coll2, int* placed, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  return (int)cluster_launch(
      jitter_on ? &scatter_kernel<true> : &scatter_kernel<false>,
      PROBE_CLUSTER, probe_threads(n), 0, 0, (cudaStream_t)stream, run,
      order, count, reinterpret_cast<const float4*>(used), demand, coll, n,
      reinterpret_cast<float4*>(used2), coll2, placed);
}

extern "C" int fused_wave_launch(const float* cap, const float* used,
                                 const float* demand, const uint8_t* feasible,
                                 const float* affinity, int has_affinity,
                                 float desired_f, const float* penalty,
                                 const int* coll, int count, int fill_grid,
                                 int n, float* used2, int* coll2, int* placed,
                                 void* stream) {
  if (n < 2 || fill_grid < 1) return (int)cudaErrorInvalidValue;
  return (int)cluster_launch(
      jitter_on ? &fused_wave_kernel<true> : &fused_wave_kernel<false>,
      PROBE_CLUSTER, probe_threads(n), 0, 0, (cudaStream_t)stream, cap,
      used, demand, feasible, affinity, has_affinity, desired_f, penalty,
      coll, count, fill_grid, n, used2, coll2, placed);
}

// The delays of cluster.cuh at K8d's, K8e's and K8f's exchange sites, for the
// launches that follow on `stream` (0: none).
extern "C" int stage_probe_set_jitter(int seed, void* stream) {
  return (int)set_jitter(seed, (cudaStream_t)stream);
}

extern "C" int stage_probe_cluster_size() { return PROBE_CLUSTER; }
