// sharded.cu — the shard-local kernels of the sharded serving path (K7),
// for Hopper (sm_90a).
//
// Replaces: the device work inside nomad_tpu/parallel/sharded.py's
// shard_map bodies — `_place_step_sharded` (the scan step of
// `place_eval_batch_sharded` and `place_batch_sharded`) and the wave
// loop, eval tail and basis merge of `place_bulk_batch_sharded`.  The
// plain PyTorch versions are nomad_tpu_torch/ops/sharded.py `*_plain`;
// they must agree exactly on every output (records and state included).
//
// One launch works on ONE node shard (rows [off, off + n) of an N-row
// world) on that shard's device; parallel/sharded.py sequences them and
// gathers the records they write between them:
//   K7a scan_local   one scan slot: score the local rows, write the
//                    shard's record (local best and its global row, the
//                    fit score and spread value indices there, local
//                    n_eval/n_exh, local top-5).  The winner is always
//                    some shard's local best, so ONE gather a slot does
//                    (the reference takes two: pmax/pmin, then a psum of
//                    the masked spread-index gather).
//   K7b scan_apply   from the gathered records the global selection
//                    (max score, lowest global row among ties, the
//                    stable merge of the top-5 lists, equal to the
//                    single-chip top_k's order); carry updates on this
//                    shard's rows and its spread-count replica; shard 0
//                    writes the slot's packed row.
//   K7c bulk_stats   one bulk wave's statistics on the shard (top-2 of
//                    cur, max m = 2 score, any fit) and cur into the
//                    gathered [N] score vector; with `begin`, the eval's
//                    start (deltas into the carry, coll0, lane state),
//                    and the eval's tail where it ends at its start.
//                    One thread-block cluster a launch (below).
//   K7d bulk_run     the fill run of every local row in the wave set
//                    (strict if the gathered top score beats s*, else
//                    the ties), into the gathered [N] run vector.
//   K7e bulk_order   the greedy order over the gathered vectors (the
//                    same on every shard): only its first
//                    min(remaining, |wave|) rows can take instances, so
//                    they are selected (the rows at the top score in
//                    row order, or a radix select) and only they are
//                    sorted; this shard's share of it, the lane state
//                    and the stop test; the eval's tail when it ends.
//   K7f bulk_counts  psum of the shards' n_eval/n_exh partials.
//   K7g basis_merge  used_tot = u0 + psum_wave(exact - u0).
// Every bulk launch for an eval whose lane state says `done` returns at
// once, so the host may read the flag after the wave instead of before
// each launch.
//
// What bounds it on this card: latency.  A scan slot reads ~44 bytes a
// local row (~0.7 MB over 16K rows, all shards) and a bulk wave about as
// much plus the gathered [N] vectors; at 3.35 TB/s that is well under a
// microsecond, while each slot or wave is two or three dependent
// launches per shard with a gather between them.  One persistent block
// of 1024 threads per launch (K7a, K7d, K7e), as K2/K4 were; K7c spreads
// its row pass over a cluster of STATS_CLUSTER blocks whose parts meet
// in block 0's shared memory over one cluster barrier (its exchange
// sites take the random delays of cluster.cuh under sharded_set_jitter).
//
// Numerics: compiled without fast math and with -fmad=false; powf; the
// reference's operation order, so scores are the plain versions' bit
// for bit (fit/18 as a multiply by the f32 reciprocal, as XLA compiles
// the reference's division by that constant).

#include <cooperative_groups.h>

#include "bulk_common.cuh"
#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = NRES;
constexpr int TOPK = 5;
constexpr int OUTW = 5 + 2 * TOPK;
constexpr int MAXK = 64;
constexpr float BIGF = 3.4e38f;
constexpr int BIGI = 0x7fffffff;
// the scan record (ops/sharded.py REC_*), i32 words, floats as bits
constexpr int REC_BEST = 0, REC_ROW = 1, REC_FIT = 2, REC_NEVAL = 3,
              REC_NEXH = 4, REC_TOPS = 5, REC_TOPI = REC_TOPS + TOPK,
              REC_V = REC_TOPI + TOPK, SCAN_REC = REC_V + MAXK;
// bulk statistics, lane state and partial counts (ops/sharded.py)
constexpr int STATS_W = 4;
constexpr int ST_PLACED = 0, ST_WAVES = 1, ST_STUCK = 2, ST_DONE = 3;
constexpr int COUNTS_W = 4;

// ------------------------------------------------------------- the scan

// a ranks before b: larger value, or equal value and lower row
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

struct Top {
  float v[TOPK];
  int i[TOPK];
};

__device__ __forceinline__ void top_init(Top& t) {
#pragma unroll
  for (int k = 0; k < TOPK; ++k) { t.v[k] = -INFINITY; t.i[k] = BIGI; }
}

__device__ __forceinline__ void top_insert(Top& t, float v, int i) {
  if (!before(v, i, t.v[TOPK - 1], t.i[TOPK - 1])) return;
  int k = TOPK - 1;
  while (k > 0 && before(v, i, t.v[k - 1], t.i[k - 1])) {
    t.v[k] = t.v[k - 1];
    t.i[k] = t.i[k - 1];
    --k;
  }
  t.v[k] = v;
  t.i[k] = i;
}

// one shard's scan operands (ops/sharded.py ScanShard)
struct ScanArgs {
  const float* cap;           // f32[n, R]
  float* used;                // f32[n, R] carry
  const uint8_t* feas;        // bool[G, n]
  const float* aff;           // f32[G, n]
  const uint8_t* pen;         // bool[G, n]
  const int* tg0;             // i32[G, n]
  const int* cap0;            // i32[G, n]
  const int* vidx;            // i32[G, K, n]
  const uint8_t* has_aff;     // bool[G]
  const int* desired;         // i32[G]
  const float* sdes;          // f32[G, K, V1]
  const uint8_t* targeted;    // bool[G, K]
  const float* wfrac;         // f32[G, K]
  const float* counts0;       // f32[G, K, V1]
  const uint8_t* active;      // bool[G, K]
  const float* demand;        // f32[S, R]
  const int* slot_tg;         // i32[S]
  const uint8_t* slot_active; // bool[S]
  int* tg_count;              // i32[G, n] carry
  int* place_cap;             // i32[G, n] carry
  float* counts;              // f32[G, K, V1] carry
  int G, n, K, V1, off;
};

struct ScanShared {
  float tv[NT][TOPK];
  int ti[NT][TOPK];
  int a[NW], b[NW];
  float minc[MAXK], maxc[MAXK], wfrac[MAXK];
  uint8_t anyp[MAXK], active[MAXK], targeted[MAXK];
};

__global__ void __launch_bounds__(NT, 1)
scan_local_kernel(ScanArgs a, const float* __restrict__ used_in,
                  const int* __restrict__ drows,
                  const float* __restrict__ dvals, int D, int s, int init,
                  int* __restrict__ recs, int shard, int spread_alg) {
  __shared__ ScanShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n, K = a.K, V1 = a.V1, V = V1 - 1;
  const int kloc = min(TOPK, n);
  int* rec = recs + (size_t)shard * SCAN_REC;
  float* recf = reinterpret_cast<float*>(rec);

  if (init) {
    // the eval's start: usage carry, its deltas in order, other carries
    if (used_in)
      for (int i = tid; i < n * R; i += NT) a.used[i] = used_in[i];
    __syncthreads();
    if (tid == 0 && drows) {
      for (int k = 0; k < D; ++k) {
        const int r = drows[k] - a.off;
        if (r < 0 || r >= n) continue;
        for (int d = 0; d < R; ++d)
          a.used[r * R + d] = a.used[r * R + d] + dvals[k * R + d];
      }
    }
    for (int i = tid; i < a.G * n; i += NT) {
      a.tg_count[i] = a.tg0[i];
      a.place_cap[i] = a.cap0[i];
    }
    for (int i = tid; i < a.G * K * V1; i += NT) a.counts[i] = a.counts0[i];
    __syncthreads();
  }

  if (!a.slot_active[s]) {
    // every local row scores -inf: the lowest rows head the top list
    for (int w = tid; w < SCAN_REC; w += NT) {
      int v = 0;
      if (w == REC_BEST) v = __float_as_int(-INFINITY);
      else if (w == REC_ROW) v = a.off;
      else if (w >= REC_TOPS && w < REC_TOPI) v = __float_as_int(-INFINITY);
      else if (w >= REC_TOPI && w < REC_V)
        v = (w - REC_TOPI < kloc) ? a.off + (w - REC_TOPI) : BIGI;
      rec[w] = v;
    }
    return;
  }

  const int g = a.slot_tg[s];
  float dem[R];
#pragma unroll
  for (int d = 0; d < R; ++d) dem[d] = a.demand[s * R + d];

  // -- per-spread statistics of group g: min/max over placed values
  if (tid < K) {
    const int gk = g * K + tid;
    const float* c = a.counts + (size_t)gk * V1;
    float mn = BIGF, mx = -BIGF;
    bool anyp = false;
    for (int v = 0; v < V; ++v) {
      const float x = c[v];
      const bool placed = x > 0.0f;
      anyp = anyp || placed;
      mn = fminf(mn, placed ? x : BIGF);
      mx = fmaxf(mx, placed ? x : -BIGF);
    }
    sh.minc[tid] = mn;
    sh.maxc[tid] = mx;
    sh.anyp[tid] = anyp;
    sh.active[tid] = a.active[gk];
    sh.targeted[tid] = a.targeted[gk];
    sh.wfrac[tid] = a.wfrac[gk];
  }
  __syncthreads();
  bool any_active = false;
  for (int k = 0; k < K; ++k) any_active = any_active || sh.active[k];

  const bool has_aff = a.has_aff[g] != 0;
  const float desired_div = fmaxf((float)a.desired[g], 1.0f);

  Top top;
  top_init(top);
  int n_eval = 0, n_exh = 0;
  for (int i = tid; i < n; i += NT) {
    const size_t gi = (size_t)g * n + i;
    const bool feas = a.feas[gi] != 0 && a.place_cap[gi] != 0;
    float cap[R], u[R];
    bool fits = feas;
#pragma unroll
    for (int d = 0; d < R; ++d) {
      cap[d] = a.cap[i * R + d];
      u[d] = a.used[i * R + d] + dem[d];
      fits = fits && (u[d] <= cap[d]);
    }
    const float fit = score_fit(cap, u, spread_alg) * (1.0f / 18.0f);
    float total = fit;
    float nsc = 1.0f;

    const float coll = (float)a.tg_count[gi];
    const float anti = -(coll + 1.0f) / desired_div;
    const bool hc = coll > 0.0f;
    total = total + (hc ? anti : 0.0f);
    nsc = nsc + (hc ? 1.0f : 0.0f);

    const bool pen = a.pen[gi] != 0;
    total = total - (pen ? 1.0f : 0.0f);
    nsc = nsc + (pen ? 1.0f : 0.0f);

    const float aff = a.aff[gi];
    const bool aff_on = has_aff && (aff != 0.0f);
    total = total + (aff_on ? aff : 0.0f);
    nsc = nsc + (aff_on ? 1.0f : 0.0f);

    float sboost = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int gk = g * K + k;
      const int v = a.vidx[(size_t)gk * n + i];
      const bool missing = v >= V;
      const int safe = min(v, V);
      const float cur = a.counts[(size_t)gk * V1 + safe];
      const float des = a.sdes[(size_t)gk * V1 + safe];
      // targeted spread: ((desired - (used+1)) / desired) * weight_frac
      float t = -1.0f;
      if (!missing && des >= 0.0f)
        t = ((des - (cur + 1.0f)) / fmaxf(des, 1e-9f)) * sh.wfrac[k];
      // even spread: delta vs min/max of placed values
      const float mn = sh.minc[k], mx = sh.maxc[k];
      const float mn_ = fmaxf(mn, 1e-9f);
      float e;
      if (cur != mn) e = (mn - cur) / mn_;
      else e = (mn == mx) ? -1.0f : (mx - mn) / mn_;
      if (missing) e = -1.0f;
      if (!sh.anyp[k]) e = 0.0f;
      const float boost = sh.targeted[k] ? t : e;
      sboost = sboost + (sh.active[k] ? boost : 0.0f);
    }
    const bool sb_on = any_active && (sboost != 0.0f);
    total = total + (sb_on ? sboost : 0.0f);
    nsc = nsc + (sb_on ? 1.0f : 0.0f);

    const float masked = fits ? total / nsc : -INFINITY;
    top_insert(top, masked, a.off + i);
    n_eval += feas ? 1 : 0;
    n_exh += (feas && !fits) ? 1 : 0;
  }

  // -- the shard's top-5 (its head is the local argmax) and counts
#pragma unroll
  for (int k = 0; k < TOPK; ++k) { sh.tv[tid][k] = top.v[k]; sh.ti[tid][k] = top.i[k]; }
  n_eval = warp_sum(n_eval);
  n_exh = warp_sum(n_exh);
  if (lane == 0) { sh.a[warp] = n_eval; sh.b[warp] = n_exh; }
  __syncthreads();
  for (int stride = NT / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      float av[TOPK], bv[TOPK], rv[TOPK];
      int ai[TOPK], bi[TOPK], ri[TOPK];
#pragma unroll
      for (int k = 0; k < TOPK; ++k) {
        av[k] = sh.tv[tid][k]; ai[k] = sh.ti[tid][k];
        bv[k] = sh.tv[tid + stride][k]; bi[k] = sh.ti[tid + stride][k];
      }
      int x = 0, y = 0;
#pragma unroll
      for (int k = 0; k < TOPK; ++k) {
        if (before(bv[y], bi[y], av[x], ai[x])) { rv[k] = bv[y]; ri[k] = bi[y]; ++y; }
        else { rv[k] = av[x]; ri[k] = ai[x]; ++x; }
      }
#pragma unroll
      for (int k = 0; k < TOPK; ++k) { sh.tv[tid][k] = rv[k]; sh.ti[tid][k] = ri[k]; }
    }
    __syncthreads();
  }

  if (tid == 0) {
    int ne = 0, nx = 0;
    for (int w = 0; w < NW; ++w) { ne += sh.a[w]; nx += sh.b[w]; }
    const float best = sh.tv[0][0];
    const int row = sh.ti[0][0];
    for (int w = 0; w < SCAN_REC; ++w) rec[w] = 0;
    recf[REC_BEST] = best;
    rec[REC_ROW] = row;
    rec[REC_NEVAL] = ne;
    rec[REC_NEXH] = nx;
    for (int k = 0; k < TOPK; ++k) {
      recf[REC_TOPS + k] = (k < kloc) ? sh.tv[0][k] : -INFINITY;
      rec[REC_TOPI + k] = (k < kloc) ? sh.ti[0][k] : BIGI;
    }
    if (best > -INFINITY) {
      const int li = row - a.off;
      float cap[R], u[R];
      for (int d = 0; d < R; ++d) {
        cap[d] = a.cap[li * R + d];
        u[d] = a.used[li * R + d] + dem[d];
      }
      recf[REC_FIT] = score_fit(cap, u, spread_alg) * (1.0f / 18.0f);
      for (int k = 0; k < K; ++k)
        rec[REC_V + k] = a.vidx[((size_t)g * K + k) * n + li];
    }
  }
}

// One warp; thread 0 merges the gathered records and applies the pick.
__global__ void scan_apply_kernel(ScanArgs a, int s,
                                  const int* __restrict__ recs, int nsh,
                                  float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  const float* recf = reinterpret_cast<const float*>(recs);
  const int n = a.n, K = a.K, V1 = a.V1;
  const int kloc = min(TOPK, n);
  const int g = a.slot_tg[s];
  // pmax of the best scores, pmin of the rows that hold it
  float gb = -INFINITY;
  for (int j = 0; j < nsh; ++j) gb = fmaxf(gb, recf[j * SCAN_REC + REC_BEST]);
  int sel = BIGI, win = -1;
  if (gb > -INFINITY) {
    for (int j = 0; j < nsh; ++j) {
      const int row = recs[j * SCAN_REC + REC_ROW];
      if (recf[j * SCAN_REC + REC_BEST] == gb && row < sel) { sel = row; win = j; }
    }
  }
  const bool ok = sel < BIGI;
  if (ok) {
    const int lr = sel - a.off;
    if (lr >= 0 && lr < n) {
      for (int d = 0; d < R; ++d)
        a.used[lr * R + d] = a.used[lr * R + d] + a.demand[s * R + d];
      const size_t gs = (size_t)g * n + lr;
      a.tg_count[gs] += 1;
      if (a.place_cap[gs] > 0) a.place_cap[gs] -= 1;
    }
    for (int k = 0; k < K; ++k) {
      const int v = recs[win * SCAN_REC + REC_V + k];
      if (a.active[g * K + k] && v < V1 - 1)
        a.counts[((size_t)g * K + k) * V1 + v] += 1.0f;
    }
  }
  if (out == nullptr) return;
  float* o = out + (size_t)s * OUTW;
  int ne = 0, nx = 0;
  for (int j = 0; j < nsh; ++j) {
    ne += recs[j * SCAN_REC + REC_NEVAL];
    nx += recs[j * SCAN_REC + REC_NEXH];
  }
  o[0] = ok ? (float)sel : -1.0f;
  o[1] = ok ? gb : 0.0f;
  o[2] = ok ? recf[win * SCAN_REC + REC_FIT] + 0.0f : 0.0f;
  o[3] = (float)ne;
  o[4] = (float)nx;
  // stable merge of the shards' lists: each pick is the first entry, in
  // (score desc, position asc) order, after the previous pick
  float ps = INFINITY;
  int pp = -1;
  for (int k = 0; k < TOPK; ++k) {
    float bs = -INFINITY;
    int bp = -1;
    for (int j = 0; j < nsh; ++j) {
      for (int q = 0; q < kloc; ++q) {
        const int p = j * kloc + q;
        const float v = recf[j * SCAN_REC + REC_TOPS + q];
        const bool after = v < ps || (v == ps && p > pp);
        if (after && (bp < 0 || before(v, p, bs, bp))) { bs = v; bp = p; }
      }
    }
    ps = bs;
    pp = bp;
    const int j = bp / kloc, q = bp % kloc;
    o[5 + k] = (float)recs[j * SCAN_REC + REC_TOPI + q];
    o[5 + TOPK + k] = bs;
  }
}

// ------------------------------------------------------------- the bulk

// one shard of one lane (ops/sharded.py BulkShard); per-eval operands
// are [E, ...] with eval e at e * (its row size), outputs at e * ostride
struct BulkArgs {
  const float* cap;          // f32[n, R]
  float* used;               // f32[n, R] chain carry
  float* exact;              // f32[n, R] exact carry
  float* delta;              // f32[n, R] the eval's local deltas
  int* coll;                 // i32[n]
  const uint8_t* feas;       // bool[E, n]
  const float* aff;          // f32[E, n]
  const uint8_t* pen;        // bool[E, n]
  const int* coll0;          // i32[E, n]
  const uint8_t* has_aff;    // bool[E]
  const int* desired;        // i32[E]
  const float* demand;       // f32[E, R]
  const int* count;          // i32[E]
  const int* drows;          // i32[E, D] or null
  const float* dvals;        // f32[E, D, R]
  int* assign;               // i32[E, ostride]
  float* scores;             // f32[E, ostride]
  int* partial;              // i32[E, COUNTS_W]
  int* state;                // i32[4]
  int n, N, off, D, ostride;
};

struct Eval {
  const uint8_t* feas;
  const float* aff;
  const uint8_t* pen;
  int* assign;
  float* scores;
  bool has_aff;
  float desired_div;
  int count;
  float dem[R];
};

__device__ __forceinline__ Eval eval_of(const BulkArgs& a, int e) {
  Eval v;
  v.feas = a.feas + (size_t)e * a.n;
  v.aff = a.aff + (size_t)e * a.n;
  v.pen = a.pen + (size_t)e * a.n;
  v.assign = a.assign + (size_t)e * a.ostride;
  v.scores = a.scores + (size_t)e * a.ostride;
  v.has_aff = a.has_aff[e] != 0;
  v.desired_div = fmaxf((float)a.desired[e], 1.0f);
  v.count = a.count[e];
#pragma unroll
  for (int d = 0; d < R; ++d) v.dem[d] = a.demand[e * R + d];
  return v;
}

__device__ __forceinline__ void load_row(BulkRow& r, const BulkArgs& a,
                                         const Eval& v, int i) {
#pragma unroll
  for (int d = 0; d < R; ++d) {
    r.cap[d] = a.cap[i * R + d];
    r.used[d] = a.used[i * R + d];
  }
  r.coll = (float)a.coll[i];
  r.feas = v.feas[i] != 0;
  r.pen = v.pen[i] != 0;
  r.aff = v.aff[i];
  r.aff_on = v.has_aff && (r.aff != 0.0f);
}

// rows [lo, hi) of the shard's n that one of `blocks` blocks owns
__device__ __forceinline__ void block_rows(int n, int blocks, int rank,
                                           int* lo, int* hi) {
  const int rpb = (n + blocks - 1) / blocks;
  *lo = min(rank * rpb, n);
  *hi = min(*lo + rpb, n);
}

// x + a * dem, per resource dim
__device__ __forceinline__ float4 add_scaled(float4 x, float a,
                                             const float* dem) {
  return make_float4(x.x + a * dem[0], x.y + a * dem[1], x.z + a * dem[2],
                     x.w + a * dem[3]);
}

__device__ __forceinline__ float4 minus(float4 x, float4 y) {
  return make_float4(x.x - y.x, x.y - y.y, x.z - y.z, x.w - y.w);
}

// Writes v into the usage row *p, which held `old`, where that changes a
// bit (a row that takes nothing gets the plain versions' `x + 0 *
// demand`, which only turns -0.0 into +0.0 or a NaN into the card's
// NaN); returns whether it wrote.
__device__ __forceinline__ bool store_changed(float4* p, float4 old,
                                              float4 v) {
  if (__float_as_uint(v.x) == __float_as_uint(old.x) &&
      __float_as_uint(v.y) == __float_as_uint(old.y) &&
      __float_as_uint(v.z) == __float_as_uint(old.z) &&
      __float_as_uint(v.w) == __float_as_uint(old.w))
    return false;
  *p = v;
  return true;
}

// ------------------------------------------------------ K7c bulk_stats

// blocks of K7c's cluster: on the H100, 16 is faster than 8 and than one
// block at n = 4,096 and 32,768 rows a shard (PERF.md)
constexpr int STATS_CLUSTER = 16;

// A thread's, warp's or block's share of a K7c launch: the top-2 of cur,
// the best m = 2 score, any fit; the tail's n_eval and n_exh.
struct StatsPart {
  float a, b, smax;
  int fit, ne, nx;
};

__device__ __forceinline__ StatsPart stats_none() {
  return StatsPart{-INFINITY, -INFINITY, -INFINITY, 0, 0, 0};
}

// every lane returns the warp's merged part (all 32 lanes call it)
__device__ __forceinline__ void warp_part(StatsPart& p) {
  warp_top2(p.a, p.b);
  p.smax = warp_max(p.smax);
  p.fit = __any_sync(0xffffffffu, p.fit != 0) ? 1 : 0;
  p.ne = warp_sum(p.ne);
  p.nx = warp_sum(p.nx);
}

struct StatsShared {
  StatsPart warp[NW];
  StatsPart slot[STATS_CLUSTER];   // block 0's: one per block
};

// The launch's first half of a cluster barrier: every thread arrives
// once it is running; `cluster_wait` (before the first store into
// another block's shared memory) then knows every block has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The cluster's merged part, in thread 0 of block 0 (*lead); every block
// stores its part into block 0's slot before the one cluster barrier, so
// only block 0 reads distributed shared memory and no block waits after.
// Every thread of the launch calls cluster_arrive() before it.
template <bool J>
__device__ StatsPart cluster_part(StatsPart p, StatsShared& sm,
                                  cg::cluster_group& cl, bool* lead) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (int)blockDim.x >> 5;
  const int rank = (int)cl.block_rank();
  warp_part(p);
  jitter<J>(1);
  if (lane == 0) sm.warp[warp] = p;
  __syncthreads();
  jitter<J>(2);
  cluster_wait();        // block 0 has started: its slots may be written
  if (warp == 0) {
    StatsPart q = lane < nw ? sm.warp[lane] : stats_none();
    warp_part(q);
    jitter<J>(3);
    if (lane == 0) cl.map_shared_rank(sm.slot, 0)[rank] = q;
  }
  cl.sync();
  jitter<J>(4);
  StatsPart r = stats_none();
  if (rank == 0 && warp == 0) {
    r = lane < (int)cl.num_blocks() ? sm.slot[lane] : stats_none();
    warp_part(r);
  }
  *lead = rank == 0 && threadIdx.x == 0;
  return r;
}

// The eval's deltas on this block's rows [lo, hi): each distinct local
// row goes to the thread of its first entry, which adds that row's
// entries in entry order (`_add_deltas_local`) and keeps delta = used
// after - used before.  Rows outside this shard drop.
__device__ void apply_deltas(const BulkArgs& a, int e, int lo, int hi) {
  const int* rows = a.drows + (size_t)e * a.D;
  const float* vals = a.dvals + (size_t)e * a.D * R;
  for (int k = threadIdx.x; k < a.D; k += blockDim.x) {
    const int g = rows[k];
    const int r = g - a.off;
    if (r < lo || r >= hi) continue;
    bool first = true;
    for (int j = 0; j < k && first; ++j) first = rows[j] != g;
    if (!first) continue;
    float u0[R], u[R];
#pragma unroll
    for (int d = 0; d < R; ++d) u0[d] = u[d] = a.used[r * R + d];
    for (int j = k; j < a.D; ++j) {
      if (rows[j] != g) continue;
#pragma unroll
      for (int d = 0; d < R; ++d) u[d] = u[d] + vals[j * R + d];
    }
#pragma unroll
    for (int d = 0; d < R; ++d) {
      a.used[r * R + d] = u[d];
      a.delta[r * R + d] = u[d] - u0[d];
    }
  }
}

// One K7c launch is one cluster of STATS_CLUSTER blocks; block b owns a
// contiguous range of the shard's rows, its threads take them in turn.
// With `begin` and deltas: delta = used - used on every row (+0.0, or NaN
// where used is not finite), a barrier, the deltas applied by their
// rows' threads (used and delta of those rows), a barrier; coll and
// assign restart in the row pass.  An eval that ends at its start (count
// 0: a lane pad) runs its tail instead of the row pass.  The row pass
// scores m = 1 and m = 2 and writes cur; the blocks' parts meet in block
// 0 over one cluster barrier.
template <bool J>
__global__ void __cluster_dims__(STATS_CLUSTER, 1, 1) __launch_bounds__(NT, 1)
bulk_stats_kernel(BulkArgs a, int e, int begin, float* __restrict__ stats,
                  float* __restrict__ cur_g, int shard, int spread,
                  int max_waves) {
  __shared__ StatsShared sm;
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)cl.block_rank();
  int lo, hi;
  block_rows(a.n, (int)cl.num_blocks(), rank, &lo, &hi);
  const Eval v = eval_of(a, e);
  const int* c0 = a.coll0 + (size_t)e * a.n;
  int* st = a.state;
  bool tail = false;
  if (begin) {
    tail = !(0 < v.count && 0 < max_waves);
    if (a.drows) {
      const float4* used4 = reinterpret_cast<const float4*>(a.used);
      float4* delta4 = reinterpret_cast<float4*>(a.delta);
      for (int i = lo + tid; i < hi; i += nt)
        delta4[i] = minus(used4[i], used4[i]);
      __syncthreads();
      jitter<J>(5);
      apply_deltas(a, e, lo, hi);
      __syncthreads();
      jitter<J>(6);
    }
    if (rank == 0 && tid == 0) {
      st[ST_PLACED] = 0;
      st[ST_WAVES] = 0;
      st[ST_STUCK] = 0;
      st[ST_DONE] = tail ? 1 : 0;
    }
  } else if (st[ST_DONE]) {
    return;
  }
  cluster_arrive();

  StatsPart p = stats_none();
  for (int i = lo + tid; i < hi; i += nt) {
    BulkRow r;
    load_row(r, a, v, i);
    if (begin) {
      const int c = c0[i];
      a.coll[i] = c;
      v.assign[i] = 0;
      r.coll = (float)c;
    }
    bool f1, f2;
    float s1, s2;
    grid_cell(r, v.dem, 1.0f, v.desired_div, spread, &f1, &s1);
    if (tail) {
      // the eval's tail (assign is 0): scores, counts, exact carry +
      // 0 * demand, deltas backed out
      v.scores[i] = f1 ? s1 : -INFINITY;
      p.ne += r.feas ? 1 : 0;
      p.nx += (r.feas && !f1) ? 1 : 0;
      float4* exact4 = reinterpret_cast<float4*>(a.exact);
      const float4 x = exact4[i];
      store_changed(&exact4[i], x, add_scaled(x, 0.0f, v.dem));
      if (a.drows) {
        float4* used4 = reinterpret_cast<float4*>(a.used);
        const float4 u = used4[i];
        const float4 dl = reinterpret_cast<const float4*>(a.delta)[i];
        store_changed(&used4[i], u, minus(u, dl));
      }
      continue;
    }
    grid_cell(r, v.dem, 2.0f, v.desired_div, spread, &f2, &s2);
    const float cur = f1 ? s1 : -INFINITY;
    cur_g[a.off + i] = cur;
    top2_push(p.a, p.b, cur);
    if (f2) p.smax = fmaxf(p.smax, s2);
    p.fit |= f1 ? 1 : 0;
  }
  bool lead;
  const StatsPart t = cluster_part<J>(p, sm, cl, &lead);
  if (!lead) return;
  if (tail) {
    int* o = a.partial + (size_t)e * COUNTS_W;
    o[0] = 0;
    o[1] = t.ne;
    o[2] = t.nx;
    o[3] = 0;
  } else {
    float* o = stats + (size_t)shard * STATS_W;
    o[0] = t.a;
    o[1] = t.b;
    o[2] = t.smax;
    o[3] = t.fit ? 1.0f : 0.0f;
  }
}

// (any_fit, s*, gmax, gsecond) from the gathered statistics
struct WaveGlobals {
  bool any_fit;
  float s_star, gmax, gsecond;
};

__device__ __forceinline__ WaveGlobals wave_globals(const float* stats, int nsh) {
  WaveGlobals g{false, -INFINITY, -INFINITY, -INFINITY};
  for (int j = 0; j < nsh; ++j) {
    const float* s = stats + (size_t)j * STATS_W;
    top2_push(g.gmax, g.gsecond, s[0]);
    top2_push(g.gmax, g.gsecond, s[1]);
    g.s_star = fmaxf(g.s_star, s[2]);
    g.any_fit = g.any_fit || s[3] > 0.0f;
  }
  return g;
}

// ------------------------------------------------------- K7d bulk_run

__global__ void __launch_bounds__(NT, 1)
bulk_run_kernel(BulkArgs a, int e, const float* __restrict__ stats, int nsh,
                const float* __restrict__ cur_g, int* __restrict__ base_g,
                int spread, int fill_grid) {
  if (a.state[ST_DONE]) return;
  const Eval v = eval_of(a, e);
  const WaveGlobals g = wave_globals(stats, nsh);
  const bool use_strict = g.gmax > g.s_star;
  const int run_cap = min(fill_grid, v.count - a.state[ST_PLACED]);
  for (int i = threadIdx.x; i < a.n; i += NT) {
    const float cur = cur_g[a.off + i];
    const bool fits = cur > -INFINITY;
    const bool in_wave = g.any_fit &&
        (use_strict ? (cur > g.s_star) : (fits && cur == g.gmax));
    int run = 0;
    if (in_wave) {
      const float second = (cur == g.gmax) ? g.gsecond : g.gmax;
      BulkRow r;
      load_row(r, a, v, i);
      for (int m = 1; m <= run_cap; ++m) {
        bool f;
        float s;
        grid_cell(r, v.dem, (float)m, v.desired_div, spread, &f, &s);
        if (!(f && (s > second || m == 1))) break;
        run = m;
      }
    }
    base_g[a.off + i] = run;
  }
}

// ----------------------------------------------------- K7e bulk_order

constexpr int KMAX = 2048;        // keys one selection round sorts

// the order's word of a score: ascending = score descending, +0.0 and
// -0.0 one word
__device__ __forceinline__ unsigned score_word(float cur) {
  return orderable(-cur + 0.0f);
}

// a key: word << 32 | row << 8 | run (the row in 24 bits, N <= 2^24)
__device__ __forceinline__ unsigned long long key_of(unsigned w, int row) {
  return ((unsigned long long)w << 32) | ((unsigned long long)row << 8);
}

// The count pass's partial over rows in row order: the least word among
// the wave rows, the rows at it and the sum of their runs; the wave's
// rows and the sum of all their runs.
struct Tally {
  unsigned w;
  int c;
  long long s;
  int nw;
  long long tb;
};

__device__ __forceinline__ Tally tally_none() {
  return Tally{0xffffffffu, 0, 0, 0, 0};
}

// commutative and associative, so any order of merging gives one result
__device__ __forceinline__ Tally tally_merge(Tally x, const Tally& y) {
  if (y.w < x.w) {
    x.w = y.w;
    x.c = y.c;
    x.s = y.s;
  } else if (y.w == x.w) {
    x.c += y.c;
    x.s += y.s;
  }
  x.nw += y.nw;
  x.tb += y.tb;
  return x;
}

__device__ __forceinline__ Tally tally_shfl_up(const Tally& x, int o) {
  Tally y;
  y.w = __shfl_up_sync(0xffffffffu, x.w, o);
  y.c = __shfl_up_sync(0xffffffffu, x.c, o);
  y.s = __shfl_up_sync(0xffffffffu, x.s, o);
  y.nw = __shfl_up_sync(0xffffffffu, x.nw, o);
  y.tb = __shfl_up_sync(0xffffffffu, x.tb, o);
  return y;
}

__device__ __forceinline__ Tally tally_shfl(const Tally& x, int src) {
  Tally y;
  y.w = __shfl_sync(0xffffffffu, x.w, src);
  y.c = __shfl_sync(0xffffffffu, x.c, src);
  y.s = __shfl_sync(0xffffffffu, x.s, src);
  y.nw = __shfl_sync(0xffffffffu, x.nw, src);
  y.tb = __shfl_sync(0xffffffffu, x.tb, src);
  return y;
}

__device__ __forceinline__ Tally warp_incl_tally(Tally x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Tally y = tally_shfl_up(x, o);
    if (lane >= o) x = tally_merge(x, y);
  }
  return x;
}

struct OrderShared {
  unsigned long long keys[KMAX];
  Tally tw[NW];
  int iw[NW];
  int iw2[NW];
  unsigned hist[256];
  int pick_bin, pick_below, pick_cnt;
  int canon;
};

// Exclusive prefix of the threads before this one (in thread order) and
// the block's total.
__device__ void block_scan_tally(Tally v, OrderShared& sm, Tally* ex,
                                 Tally* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tally x = warp_incl_tally(v, lane);
  if (lane == 31) sm.tw[warp] = x;
  __syncthreads();
  const Tally wi = warp_incl_tally(sm.tw[lane], lane);
  Tally wp = tally_shfl(wi, (warp + 31) & 31);
  if (warp == 0) wp = tally_none();
  *tot = tally_shfl(wi, 31);
  Tally lp = tally_shfl_up(x, 1);
  if (lane == 0) lp = tally_none();
  *ex = tally_merge(wp, lp);
  __syncthreads();
}

// Exclusive prefix sums of two ints in thread order and their totals.
__device__ void block_scan2(int a, int b, OrderShared& sm, int* exa, int* exb,
                            int* ta, int* tb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = a, y = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int px = __shfl_up_sync(0xffffffffu, x, o);
    const int py = __shfl_up_sync(0xffffffffu, y, o);
    if (lane >= o) { x += px; y += py; }
  }
  if (lane == 31) { sm.iw[warp] = x; sm.iw2[warp] = y; }
  __syncthreads();
  int wx = sm.iw[lane], wy = sm.iw2[lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int px = __shfl_up_sync(0xffffffffu, wx, o);
    const int py = __shfl_up_sync(0xffffffffu, wy, o);
    if (lane >= o) { wx += px; wy += py; }
  }
  const int src = (warp + 31) & 31;
  int px = __shfl_sync(0xffffffffu, wx, src);
  int py = __shfl_sync(0xffffffffu, wy, src);
  if (warp == 0) px = py = 0;
  *ta = __shfl_sync(0xffffffffu, wx, 31);
  *tb = __shfl_sync(0xffffffffu, wy, 31);
  *exa = px + x - a;
  *exb = py + y - b;
  __syncthreads();
}

// Everything one K7e launch reads and writes about its rows.
struct Order {
  const float* cur;
  const int* base;
  int j0, j1;                // this thread's slice of the gathered rows
  int remaining;
};

constexpr int CH = 8;      // gathered rows a thread loads at once
static_assert(CH == 8, "load_chunk reads two int4 and two float4");
constexpr int TCH = 4;     // shard rows a thread updates at once
static_assert(CH == 2 * TCH, "a chunk is updated in two halves");

// Rows [j, j + CH) of the thread's slice, loaded together (past its
// end: run 0, outside the wave).  A slice starts at a multiple of CH
// rows, so a whole chunk is two 16-byte loads of each vector.
__device__ __forceinline__ void load_chunk(const Order& o, int j, int* b,
                                           float* c) {
  if (j + CH <= o.j1) {
    const int4* b4 = reinterpret_cast<const int4*>(o.base + j);
    const float4* c4 = reinterpret_cast<const float4*>(o.cur + j);
    const int4 b0 = b4[0], b1 = b4[1];
    const float4 c0 = c4[0], c1 = c4[1];
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
    c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < CH; ++u) {
    const bool in = j + u < o.j1;
    b[u] = in ? o.base[j + u] : 0;
    c[u] = in ? o.cur[j + u] : 0.0f;
  }
}

// Adds alloc[u] instances of the eval's demand to gathered rows j + u
// that are this shard's (u < TCH, `take[u]`): used + alloc * demand (the
// plain version's every-row add, written where it changes a bit), coll
// and assign where alloc > 0; *canon is set where a row that took
// nothing changed.  Each row's usage is loaded with the others'.
__device__ __forceinline__ void take_rows(const BulkArgs& a, const Eval& v,
                                          const Order& o, int j,
                                          const int* alloc, const bool* take,
                                          int* canon) {
  float4* used4 = reinterpret_cast<float4*>(a.used);
  float4 u[TCH];
#pragma unroll
  for (int q = 0; q < TCH; ++q) {
    const int l = j + q - a.off;
    if (take[q]) u[q] = used4[l];
  }
#pragma unroll
  for (int q = 0; q < TCH; ++q) {
    if (!take[q]) continue;
    const int l = j + q - a.off;
    const bool changed = store_changed(
        &used4[l], u[q], add_scaled(u[q], (float)alloc[q], v.dem));
    if (alloc[q] > 0) {
      a.coll[l] += alloc[q];
      v.assign[l] += alloc[q];
    } else if (changed) {
      *canon = 1;
    }
  }
}

// Radix select among the eligible rows: the word prefix (the top 32 -
// *shift bits) of the need-th smallest word, with multiplicity; on return
// *need holds how many rows at that prefix the selection takes.  Stops
// early where the rows at the prefix are exactly the ones still needed.
template <class E>
__device__ unsigned radix_select(const Order& o, OrderShared& sm,
                                 const E& eligible, int* need, int* shift) {
  const int tid = threadIdx.x;
  unsigned prefix = 0;
  for (int sh = 24; sh >= 0; sh -= 8) {
    if (tid < 256) sm.hist[tid] = 0u;
    __syncthreads();
    for (int j = o.j0; j < o.j1; j += CH) {
      int b[CH];
      float c[CH];
      load_chunk(o, j, b, c);
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        if (b[u] <= 0) continue;
        const unsigned w = score_word(c[u]);
        if (!eligible(w, j + u)) continue;
        if (sh == 24 || (w >> (sh + 8)) == prefix)
          atomicAdd(&sm.hist[(w >> sh) & 255u], 1u);
      }
    }
    __syncthreads();
    const int cnt = tid < 256 ? (int)sm.hist[tid] : 0;
    int total;
    const int ex = block_exclusive_scan(cnt, sm.iw, &total);
    if (cnt > 0 && ex < *need && *need <= ex + cnt) {
      sm.pick_bin = tid;
      sm.pick_below = ex;
      sm.pick_cnt = cnt;
    }
    __syncthreads();
    prefix = (prefix << 8) | (unsigned)sm.pick_bin;
    *need -= sm.pick_below;
    *shift = sh;
    const bool whole = sm.pick_cnt == *need;
    __syncthreads();      // the picks are read before the next round
    if (whole) break;
  }
  return prefix;
}

// One launch is one block.  A wave places at most `remaining` instances
// and every wave row takes at least one (its run is >= 1), so only the
// first k = min(remaining, |wave|) rows of the order (score desc, row
// asc) can take any: the kernel selects them instead of sorting.  One
// count pass over the gathered rows (each thread a contiguous slice,
// loaded CH rows at once) tallies the wave, its run sum and the rows at
// its top word; when k of them share that word they are the selection
// in row order (no sort); otherwise radix-select rounds of at most KMAX
// keys find the threshold, and only the selected keys are sorted, in
// shared memory.  Every row of this shard gets used + alloc * demand
// (alloc 0 off the selection), as the plain version adds on every row.
// When the stop test ends the eval, the tail: a row that took nothing
// and whose usage kept its bits keeps the wave-start score cur (the same
// inputs give the same score), so only rows that took instances (and
// feasible rows that did not fit) are scored again.
__global__ void __launch_bounds__(NT, 1)
bulk_order_kernel(BulkArgs a, int e, const float* __restrict__ stats,
                  int nsh, const float* __restrict__ cur_g,
                  const int* __restrict__ base_g, int spread,
                  int max_waves) {
  __shared__ OrderShared sm;
  const int tid = threadIdx.x;
  int* st = a.state;
  if (st[ST_DONE]) return;
  const Eval v = eval_of(a, e);
  const WaveGlobals g = wave_globals(stats, nsh);
  const int placed = st[ST_PLACED], waves = st[ST_WAVES];
  Order o;
  o.cur = cur_g;
  o.base = base_g;
  const int rpt = ((a.N + NT - 1) / NT + CH - 1) / CH * CH;
  o.j0 = min(tid * rpt, a.N);
  o.j1 = min(o.j0 + rpt, a.N);
  o.remaining = v.count - placed;
  if (tid == 0) sm.canon = 0;

  // the count pass
  Tally t = tally_none();
  for (int j = o.j0; j < o.j1; j += CH) {
    int b[CH];
    float c[CH];
    load_chunk(o, j, b, c);
#pragma unroll
    for (int u = 0; u < CH; ++u)
      if (b[u] > 0)
        t = tally_merge(t, Tally{score_word(c[u]), 1, b[u], 1, b[u]});
  }
  Tally ex, all;
  block_scan_tally(t, sm, &ex, &all);      // (its barriers order canon)
  const int k = min(o.remaining, all.nw);
  // this thread's slice holds rows of this shard
  const int s0 = max(o.j0, a.off), s1 = min(o.j1, a.off + a.n);
  int canon = 0;

  if (all.c >= k) {
    // the first k rows at the top word, in row order
    if (s0 < s1) {
      int rank = ex.w == all.w ? ex.c : 0;
      long long pre = ex.w == all.w ? ex.s : 0;
      for (int j = o.j0; j < s1; j += CH) {
        int b[CH], alloc[CH];
        float c[CH];
        bool take[CH];
        load_chunk(o, j, b, c);
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          alloc[u] = 0;
          if (b[u] > 0 && rank < k && score_word(c[u]) == all.w) {
            alloc[u] = (int)min(max((long long)o.remaining - pre, 0ll),
                                (long long)b[u]);
            ++rank;
            pre += b[u];
          }
          take[u] = j + u >= s0 && j + u < s1;
        }
        take_rows(a, v, o, j, alloc, take, &canon);
        take_rows(a, v, o, j + TCH, alloc + TCH, take + TCH, &canon);
      }
    }
  } else {
    // radix-select rounds of at most KMAX keys
    bool have_lo = false;
    unsigned long long lo_key = 0;
    auto eligible = [&](unsigned w, int j) -> bool {
      return !have_lo || key_of(w, j) > lo_key;
    };
    long long run_base = 0;
    for (int taken = 0; taken < k && run_base < o.remaining;) {
      const int q = min(KMAX, k - taken);
      int need = q, sh = 0;
      const unsigned thr = radix_select(o, sm, eligible, &need, &sh);
      // below the threshold: taken whole; at it: the first `need` in row
      // order; each key's position among the round's q keys
      int nb = 0, na = 0;
      for (int j = o.j0; j < o.j1; j += CH) {
        int b[CH];
        float c[CH];
        load_chunk(o, j, b, c);
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const unsigned w = score_word(c[u]);
          if (b[u] <= 0 || !eligible(w, j + u)) continue;
          nb += (w >> sh) < thr ? 1 : 0;
          na += (w >> sh) == thr ? 1 : 0;
        }
      }
      int exb, exa, tb, ta;
      block_scan2(nb, na, sm, &exb, &exa, &tb, &ta);
      if (nb > 0 || (na > 0 && exa < need)) {
        for (int j = o.j0; j < o.j1; j += CH) {
          int b[CH];
          float c[CH];
          load_chunk(o, j, b, c);
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            const unsigned w = score_word(c[u]);
            if (b[u] <= 0 || !eligible(w, j + u)) continue;
            const unsigned long long key =
                key_of(w, j + u) | (unsigned long long)b[u];
            if ((w >> sh) < thr) {
              sm.keys[exb++] = key;
            } else if ((w >> sh) == thr) {
              if (exa < need) sm.keys[tb + exa] = key;
              ++exa;
            }
          }
        }
      }
      __syncthreads();
      if (q > 1) {
        const int p = sort_len(q);
        for (int i = q + tid; i < p; i += NT) sm.keys[i] = NO_KEY;
        __syncthreads();
        block_bitonic_sort(sm.keys, p);
      }
      // the cumulative cap in key order; thread t takes keys [t*per, ...)
      const int per = (q + NT - 1) / NT;
      const int k0 = min(tid * per, q), k1 = min(k0 + per, q);
      int local = 0;
      for (int i = k0; i < k1; ++i) local += (int)(sm.keys[i] & 0xFFull);
      int round_total;
      long long prefix =
          run_base + block_exclusive_scan(local, sm.iw, &round_total);
      for (int i = k0; i < k1; ++i) {
        const unsigned long long key = sm.keys[i];
        const int b = (int)(key & 0xFFull);
        const int j = (int)((key >> 8) & 0xFFFFFFull);
        int alloc[TCH] = {0, 0, 0, 0};
        bool take[TCH] = {false, false, false, false};
        alloc[0] = (int)min(max((long long)o.remaining - prefix, 0ll),
                            (long long)b);
        take[0] = j >= a.off && j < a.off + a.n;
        prefix += b;
        take_rows(a, v, o, j, alloc, take, &canon);
      }
      run_base += round_total;
      have_lo = true;
      lo_key = sm.keys[q - 1] | 0xFFull;
      taken += q;
      __syncthreads();           // the keys are read before the next round
    }
    // this shard's rows off the selection
    if (s0 < s1) {
      for (int j = o.j0; j < s1; j += CH) {
        int b[CH], alloc[CH];
        float c[CH];
        bool take[CH];
        load_chunk(o, j, b, c);
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          alloc[u] = 0;
          take[u] = j + u >= s0 && j + u < s1 &&
                    !(have_lo && b[u] > 0 &&
                      key_of(score_word(c[u]), j + u) <= lo_key);
        }
        take_rows(a, v, o, j, alloc, take, &canon);
        take_rows(a, v, o, j + TCH, alloc + TCH, take + TCH, &canon);
      }
    }
  }
  if (canon) sm.canon = 1;

  // the lane state and the stop test, in every thread
  const int placed_now =
      placed + (int)max(min((long long)o.remaining, all.tb), 0ll);
  const int waves_now = waves + 1;
  const bool go = placed_now < v.count && g.any_fit && waves_now < max_waves;
  __syncthreads();                 // every thread read the state; canon
  if (tid == 0) {
    st[ST_PLACED] = placed_now;
    st[ST_WAVES] = waves_now;
    st[ST_STUCK] = g.any_fit ? 0 : 1;
    st[ST_DONE] = go ? 0 : 1;
  }
  if (go) return;

  // the eval's tail on this shard, TCH rows a thread at once
  const bool rescore_all = sm.canon != 0;
  const float4* delta4 = reinterpret_cast<const float4*>(a.delta);
  float4* used4 = reinterpret_cast<float4*>(a.used);
  float4* exact4 = reinterpret_cast<float4*>(a.exact);
  int ne = 0, nx = 0;
  for (int i0 = tid; i0 < a.n; i0 += NT * TCH) {
    int asg[TCH];
    bool feas[TCH];
    float s[TCH];
#pragma unroll
    for (int q = 0; q < TCH; ++q) {
      const int i = i0 + q * NT;
      const bool in = i < a.n;
      asg[q] = in ? v.assign[i] : 0;
      feas[q] = in && v.feas[i] != 0;
      s[q] = in ? cur_g[a.off + i] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < TCH; ++q) {
      const int i = i0 + q * NT;
      if (i >= a.n) continue;
      bool fits = feas[q];
      if (rescore_all || asg[q] > 0 || (feas[q] && !(s[q] > -INFINITY))) {
        BulkRow r;
        load_row(r, a, v, i);
        grid_cell(r, v.dem, 1.0f, v.desired_div, spread, &fits, &s[q]);
        s[q] = fits ? s[q] : -INFINITY;
      }
      v.scores[i] = s[q];
      ne += feas[q] ? 1 : 0;
      nx += (feas[q] && !fits) ? 1 : 0;
      const float4 x = exact4[i];
      store_changed(&exact4[i], x, add_scaled(x, (float)asg[q], v.dem));
      if (a.drows) {
        const float4 u = used4[i], dl = delta4[i];
        store_changed(&used4[i], u, minus(u, dl));
      }
    }
  }
  int ex_ne, ex_nx, all_ne, all_nx;
  block_scan2(ne, nx, sm, &ex_ne, &ex_nx, &all_ne, &all_nx);
  if (tid == 0) {
    int* p = a.partial + (size_t)e * COUNTS_W;
    p[0] = placed_now;
    p[1] = all_ne;
    p[2] = all_nx;
    p[3] = waves_now;
  }
}

__global__ void bulk_counts_kernel(const int* __restrict__ partials,
                                   int* __restrict__ out, int nsh, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int ne = 0, nx = 0;
  for (int j = 0; j < nsh; ++j) {
    const int* p = partials + ((size_t)j * E + e) * COUNTS_W;
    ne += p[1];
    nx += p[2];
  }
  const int* p0 = partials + (size_t)e * COUNTS_W;
  int* o = out + (size_t)e * COUNTS_W;
  o[0] = p0[0];
  o[1] = ne;
  o[2] = nx;
  o[3] = p0[3];
}

__global__ void basis_merge_kernel(const float* u0, const float* exacts,
                                   float* out, int W, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  const float u = u0[i];
  float acc = exacts[i] - u;
  for (int w = 1; w < W; ++w) acc = acc + (exacts[(size_t)w * len + i] - u);
  out[i] = u + acc;
}

// One K7c cluster (its size compiled into the kernel, so an ordinary
// launch).  A size past 8 is allowed before every launch, as
// cluster_launch does: the attribute holds for the current device only.
template <bool J>
cudaError_t stats_launch(int threads, cudaStream_t stream, BulkArgs a, int e,
                         int begin, float* stats, float* cur_g, int shard,
                         int spread, int max_waves) {
  if (STATS_CLUSTER > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        bulk_stats_kernel<J>, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (err != cudaSuccess) return err;
  }
  bulk_stats_kernel<J><<<STATS_CLUSTER, threads, 0, stream>>>(
      a, e, begin, stats, cur_g, shard, spread, max_waves);
  return cudaGetLastError();
}

BulkArgs bulk_args(const float* cap, float* used, float* exact, float* delta,
                   int* coll, const uint8_t* feas, const float* aff,
                   const uint8_t* pen, const int* coll0,
                   const uint8_t* has_aff, const int* desired,
                   const float* demand, const int* count, const int* drows,
                   const float* dvals, int* assign, float* scores,
                   int* partial, int* state, int n, int N, int off, int D,
                   int ostride) {
  return BulkArgs{cap, used, exact, delta, coll, feas, aff, pen, coll0,
                  has_aff, desired, demand, count, drows, dvals, assign,
                  scores, partial, state, n, N, off, D, ostride};
}

}  // namespace

#define BULK_PARAMS                                                        \
  const float *cap, float *used, float *exact, float *delta, int *coll,    \
      const uint8_t *feas, const float *aff, const uint8_t *pen,           \
      const int *coll0, const uint8_t *has_aff, const int *desired,        \
      const float *demand, const int *count, const int *drows,             \
      const float *dvals, int *assign, float *scores, int *partial,        \
      int *state, int n, int N, int off, int D, int ostride
#define BULK_ARGS                                                          \
  bulk_args(cap, used, exact, delta, coll, feas, aff, pen, coll0, has_aff, \
            desired, demand, count, drows, dvals, assign, scores, partial, \
            state, n, N, off, D, ostride)

extern "C" int scan_local_launch(
    const float* cap, float* used, const uint8_t* feas, const float* aff,
    const uint8_t* pen, const int* tg0, const int* cap0, const int* vidx,
    const uint8_t* has_aff, const int* desired, const float* sdes,
    const uint8_t* targeted, const float* wfrac, const float* counts0,
    const uint8_t* active, const float* demand, const int* slot_tg,
    const uint8_t* slot_active, int* tg_count, int* place_cap, float* counts,
    const float* used_in, const int* drows, const float* dvals, int* recs,
    int G, int n, int K, int V1, int D, int off, int s, int init, int shard,
    int spread_alg, void* stream) {
  if (K < 1 || K > MAXK || n < 1 || V1 < 1) return (int)cudaErrorInvalidValue;
  const ScanArgs a{cap, used, feas, aff, pen, tg0, cap0, vidx, has_aff,
                   desired, sdes, targeted, wfrac, counts0, active, demand,
                   slot_tg, slot_active, tg_count, place_cap, counts,
                   G, n, K, V1, off};
  scan_local_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      a, used_in, drows, dvals, D, s, init, recs, shard, spread_alg);
  return (int)cudaGetLastError();
}

extern "C" int scan_apply_launch(float* used, int* tg_count, int* place_cap,
                                 float* counts, const uint8_t* active,
                                 const float* demand, const int* slot_tg,
                                 const int* recs, float* out, int G, int n,
                                 int K, int V1, int off, int s, int nsh,
                                 void* stream) {
  if (K < 1 || K > MAXK || n < 1 || nsh < 1 || nsh * min(TOPK, n) < TOPK)
    return (int)cudaErrorInvalidValue;
  ScanArgs a{};
  a.used = used;
  a.tg_count = tg_count;
  a.place_cap = place_cap;
  a.counts = counts;
  a.active = active;
  a.demand = demand;
  a.slot_tg = slot_tg;
  a.G = G;
  a.n = n;
  a.K = K;
  a.V1 = V1;
  a.off = off;
  scan_apply_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(a, s, recs, nsh, out);
  return (int)cudaGetLastError();
}

// The delays' seed for the K7c launches that follow on `stream` (0: the
// kernel without the delay sites).  A check's setting: no other host
// thread may launch K7c meanwhile.
extern "C" int sharded_set_jitter(int seed, void* stream) {
  return (int)set_jitter(seed, (cudaStream_t)stream);
}

extern "C" int bulk_stats_cluster_size() { return STATS_CLUSTER; }

extern "C" int bulk_stats_launch(BULK_PARAMS, int e, int begin, float* stats,
                                 float* cur_g, int shard, int spread,
                                 int max_waves, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int rpb = (n + STATS_CLUSTER - 1) / STATS_CLUSTER;
  const int threads = min(NT, max(32, (rpb + 31) / 32 * 32));
  return (int)(jitter_on
      ? stats_launch<true>(threads, (cudaStream_t)stream, BULK_ARGS, e, begin,
                           stats, cur_g, shard, spread, max_waves)
      : stats_launch<false>(threads, (cudaStream_t)stream, BULK_ARGS, e,
                            begin, stats, cur_g, shard, spread, max_waves));
}

extern "C" int bulk_run_launch(BULK_PARAMS, int e, const float* stats,
                               int nsh, const float* cur_g, int* base_g,
                               int spread, int fill_grid, void* stream) {
  if (fill_grid < 1 || fill_grid > 255) return (int)cudaErrorInvalidValue;
  bulk_run_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      BULK_ARGS, e, stats, nsh, cur_g, base_g, spread, fill_grid);
  return (int)cudaGetLastError();
}

extern "C" int bulk_order_launch(BULK_PARAMS, int e, const float* stats,
                                 int nsh, const float* cur_g,
                                 const int* base_g, int spread, int max_waves,
                                 void* stream) {
  if (n < 1 || N < n || N > (1 << 24)) return (int)cudaErrorInvalidValue;
  bulk_order_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      BULK_ARGS, e, stats, nsh, cur_g, base_g, spread, max_waves);
  return (int)cudaGetLastError();
}

extern "C" int bulk_counts_launch(const int* partials, int* out, int nsh,
                                  int E, void* stream) {
  if (E <= 0) return 0;
  bulk_counts_kernel<<<(E + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partials, out, nsh, E);
  return (int)cudaGetLastError();
}

extern "C" int basis_merge_launch(const float* u0, const float* exacts,
                                  float* out, int W, int len, void* stream) {
  if (len <= 0) return 0;
  basis_merge_kernel<<<(len + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      u0, exacts, out, W, len);
  return (int)cudaGetLastError();
}
