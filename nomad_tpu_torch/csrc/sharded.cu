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
//                    the masked spread-index gather).  One cluster of
//                    SCAN_CLUSTER blocks; rows' partial scores cached.
//   K7b scan_apply   from the gathered records the global selection
//                    (max score, lowest global row among ties, the
//                    stable merge of the top-5 lists, equal to the
//                    single-chip top_k's order); carry updates on this
//                    shard's rows and its spread-count replica; shard 0
//                    writes the slot's packed row; the shard's pick word
//                    gets the local row it changed (-1: none), for K7a.
//                    One warp, every lane at work (its section below).
//   K7c bulk_stats   one bulk wave's statistics on the shard (top-2 of
//                    cur in lax.top_k's order, the shard's part of s*,
//                    any fit, max cur that is not NaN) and cur into the
//                    gathered [N] score vector; with `begin`, the eval's
//                    start (deltas into the carry, coll0, lane state),
//                    and the eval's tail where it ends at its start.
//                    One thread-block cluster a launch (below).
//   K7d bulk_run     the fill run of every local row in the wave set
//                    (strict if a row's score beats s*, else the
//                    ties), into the gathered [N] run vector.  A
//                    grid of blocks of RUN_ROWS rows; a row's cells
//                    over lanes (below).
//   K7e bulk_order   the greedy order over the gathered vectors (the
//                    same on every shard): only its first
//                    min(remaining, |wave|) rows can take instances, so
//                    they are selected (the rows at the top score in
//                    row order, or a radix select) and only they are
//                    sorted; this shard's share of it, the lane state
//                    and the stop test; the eval's tail when it ends.
//   K7f bulk_counts  psum of the shards' n_eval/n_exh partials: no
//                    launch of its own, node shard 0's K7g launch
//                    writes it.
//   K7g basis_merge  used_tot = u0 + psum_wave(exact - u0), a thread a
//                    row (16-byte loads).
// Every bulk launch for an eval whose lane state says `done` returns at
// once, so the host may read the flag after the wave instead of before
// each launch.
//
// What bounds it on this card: latency.  A scan slot reads ~44 bytes a
// local row (~0.7 MB over 16K rows, all shards) and a bulk wave about as
// much plus the gathered [N] vectors; at 3.35 TB/s that is well under a
// microsecond, while each slot or wave is two or three dependent
// launches per shard with a gather between them.  K7a and K7c spread
// their row pass over a thread-block cluster whose parts meet in block
// 0's shared memory over one cluster barrier (the exchange sites take
// the random delays of cluster.cuh under sharded_set_jitter); K7d is a
// grid of small blocks (no cross-row reduction); K7e one block of 1024
// threads.  K7a caches each row's partial score across launches (its
// section below).
//
// Operands: K7a and K7b take one shard's ScanArgs and K7c-K7e its
// BulkArgs by address, packed once a shard by the wrapper
// (ops/sharded.py), so a launch builds only its few per-call arguments
// on the host.
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
constexpr int STATS_W = 5;
constexpr int ST_PLACED = 0, ST_WAVES = 1, ST_STUCK = 2, ST_DONE = 3;
constexpr int COUNTS_W = 4;

// ------------------------------------------------------------- the scan
//
// K7a: one launch is one cluster of SCAN_CLUSTER blocks; block b owns a
// contiguous range of the shard's rows, its threads take them in turn.
//  - The cache.  Between two active slots of one group and demand only
//    the row K7b picked changes its usage, tg_count and place_cap (the
//    other shards' picks change only the spread counts), and the
//    reference adds the scoring terms in a fixed order (fit, + anti,
//    - penalty, + affinity, + spread, then / n).  So each row keeps its
//    partial total (fit + anti - penalty + affinity), its fit, and a flag
//    word (feasible, fits, the scorer count before the spread term) in
//    the shard's cache scratch (global memory, since a slot is one launch
//    and the cache must outlive it), with the group and demand they were
//    scored for.  Every row is rescored at the eval's first slot and
//    whenever the slot's group or demand differs from that key;
//    otherwise only the row in the shard's pick word, which K7b writes
//    (the shards may share one gathered record buffer, so a record read
//    back later may belong to another slot).  An inactive slot keeps the
//    key and rescores the pending pick under it.
//  - The spread term depends on a row only through its value index of
//    each active spread, so each slot every block builds the group's
//    boost tables (one entry a value, from the counts' replica and their
//    min and max over placed values) in shared memory (in the cache's
//    table region past TAB_SMEM floats), its threads sharing each
//    spread's values, and every row adds its entries in spread order,
//    then divides by its scorer count.  A spread over thousands of
//    values costs each thread V1 / blockDim entries a slot, and a
//    barrier a spread.
//  - The top-5: 64-bit keys (the orderable score, -0.0 read as +0.0, then
//    the row inverted, so the larger key is the higher score and then the
//    lower row: lax.top_k's order; the low bit keeps a -0.0 score's sign
//    for the record).  A warp merges its lanes' lists with redux.sync,
//    one warp the block's warp lists; each block stores its list, counts
//    and its first row's fit into block 0's shared memory after a
//    cluster wait (every block has started), then one cluster barrier,
//    and one warp of block 0 merges them and writes the record.
//  - The eval's start: each block copies the carries of its rows; a delta
//    row's entries are added in list order by the thread of its first
//    entry; the counts' replica is copied over the cluster (this launch's
//    tables read the eval's own counts).

typedef unsigned long long u64;
constexpr unsigned FULL = 0xffffffffu;

// blocks of K7a's cluster: on the H100, 16 is faster than 4 and 1 at
// n = 4,096 and 32,768 rows a shard, than 8 at 32,768 (PERF.md)
constexpr int SCAN_CLUSTER = 16;
static_assert(SCAN_CLUSTER <= 32, "one warp merges the blocks' lists");
static_assert(NW == 32, "one warp reads the block's warp lists");
static_assert(MAXK <= 64, "two ballots list the active spreads");
// table floats (K x V1) a block keeps in shared memory; past it each
// block's tables live in the cache's table region
constexpr int TAB_SMEM = 16384;
// the cache (ops/sharded.py scan_cache), i32 words: partial totals [n],
// fits [n], flag words [n], the key (group, -1 none; demand as f32
// bits), then, past TAB_SMEM, a table region of K x V1 floats a block
constexpr int CACHE_META = 8;
constexpr int KEY_G = 0, KEY_DEM = 1;
constexpr unsigned F_FEAS = 1u, F_FITS = 2u;

__host__ __device__ __forceinline__ bool tables_in_cache(int K, int V1) {
  return (long long)K * V1 > TAB_SMEM;
}

__host__ __device__ __forceinline__ size_t scan_cache_words(int n, int K,
                                                            int V1) {
  size_t w = 3 * (size_t)n + CACHE_META;
  if (tables_in_cache(K, V1)) w += (size_t)SCAN_CLUSTER * K * V1;
  return w;
}

// rows [lo, hi) of the shard's n that one of `blocks` blocks owns
__device__ __forceinline__ void block_rows(int n, int blocks, int rank,
                                           int* lo, int* hi) {
  const int rpb = (n + blocks - 1) / blocks;
  *lo = min(rank * rpb, n);
  *hi = min(*lo + rpb, n);
}

// score desc, then row asc; +0.0 and -0.0 rank as one score, the low bit
// keeps the sign of a -0.0 for the record.  0 is "no row".
__device__ __forceinline__ u64 make_key(float v, int row) {
  const u64 neg0 = __float_as_uint(v) == 0x80000000u ? 1ull : 0ull;
  return ((u64)orderable(v + 0.0f) << 32) |
         ((u64)(0x7fffffffu - (unsigned)row) << 1) | neg0;
}

__device__ __forceinline__ int key_row(u64 k) {
  return (int)(0x7fffffffu - (unsigned)((k >> 1) & 0x7fffffffu));
}

__device__ __forceinline__ float key_val(u64 k) {
  if (k & 1ull) return -0.0f;
  const unsigned o = (unsigned)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

struct Top {
  u64 k[TOPK];   // descending
};

__device__ __forceinline__ void top_clear(Top& t) {
#pragma unroll
  for (int j = 0; j < TOPK; ++j) t.k[j] = 0ull;
}

__device__ __forceinline__ void top_push(Top& t, u64 x) {
  if (x <= t.k[TOPK - 1]) return;
#pragma unroll
  for (int j = 0; j < TOPK; ++j) {
    const u64 a = t.k[j];
    t.k[j] = a > x ? a : x;
    x = a > x ? x : a;
  }
}

// The warp's top-5 of its lanes' lists (each sorted, keys distinct but
// 0), in every lane; *first = the lane whose head was the first.
__device__ __forceinline__ void warp_top(Top& t, Top& out, int* first) {
#pragma unroll
  for (int j = 0; j < TOPK; ++j) {
    const unsigned h = (unsigned)(t.k[0] >> 32);
    const unsigned hi = __reduce_max_sync(FULL, h);
    const unsigned lo = __reduce_max_sync(FULL, h == hi ? (unsigned)t.k[0] : 0u);
    const u64 w = ((u64)hi << 32) | lo;
    out.k[j] = w;
    const bool pop = t.k[0] == w;
    if (j == 0) *first = __ffs(__ballot_sync(FULL, pop)) - 1;
#pragma unroll
    for (int i = 0; i < TOPK - 1; ++i) t.k[i] = pop ? t.k[i + 1] : t.k[i];
    t.k[TOPK - 1] = pop ? 0ull : t.k[TOPK - 1];
  }
}

// one shard's scan operands (ops/sharded.py ScanArgs, packed once a shard)
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
  float* counts;              // f32[G, K, V1] carry (this shard's replica)
  int* cache;                 // i32[cache_words] K7a's row cache (above)
  int* pick;                  // i32[1] the local row K7b changed, -1 none
  int G, n, K, V1, off, cache_words;
};

struct ScanShared {
  u64 wk[NW][TOPK];              // the warps' lists
  int wc[NW][2];                 // the warps' (n_eval, n_exh)
  int act[MAXK];                 // the group's active spreads, in order
  unsigned mm[2][NW][3];         // a spread's warp (min, max, any placed)
  u64 bk[SCAN_CLUSTER][TOPK];    // block 0's: each block's list,
  float bfit[SCAN_CLUSTER];      // the fit of its first row,
  int bc[SCAN_CLUSTER][2];       // and its (n_eval, n_exh)
};

// Local row i's partial score for group g and demand dem, in the
// reference's order up to the spread term, into the cache; returns the
// flag word.
__device__ __forceinline__ unsigned score_row(const ScanArgs& a, int g,
                                              int i, const float* dem,
                                              int spread, float* part) {
  const size_t gi = (size_t)g * a.n + i;
  const bool feas = a.feas[gi] != 0 && a.place_cap[gi] != 0;
  float cap[R], u[R];
  bool fits = feas;
#pragma unroll
  for (int d = 0; d < R; ++d) {
    cap[d] = a.cap[i * R + d];
    u[d] = a.used[i * R + d] + dem[d];
    fits = fits && (u[d] <= cap[d]);
  }
  const float fit = score_fit(cap, u, spread) * (1.0f / 18.0f);
  float total = fit;
  unsigned ns = 1;
  const float coll = (float)a.tg_count[gi];
  const float anti = -(coll + 1.0f) / fmaxf((float)a.desired[g], 1.0f);
  const bool hc = coll > 0.0f;
  total = total + (hc ? anti : 0.0f);
  ns += hc ? 1u : 0u;
  const bool pen = a.pen[gi] != 0;
  total = total - (pen ? 1.0f : 0.0f);
  ns += pen ? 1u : 0u;
  const float aff = a.aff[gi];
  const bool aff_on = a.has_aff[g] != 0 && (aff != 0.0f);
  total = total + (aff_on ? aff : 0.0f);
  ns += aff_on ? 1u : 0u;
  const unsigned fl = (feas ? F_FEAS : 0u) | (fits ? F_FITS : 0u) | (ns << 2);
  float* fitc = reinterpret_cast<float*>(a.cache) + a.n;
  *part = total;
  reinterpret_cast<float*>(a.cache)[i] = total;
  fitc[i] = fit;
  a.cache[2 * a.n + i] = (int)fl;
  return fl;
}

// The block: spread gk's boost table (the reference's _spread_boost, one
// entry a value index, V1 - 1 = the missing attribute) from the counts
// `cnt` [G, K, V1]: the min / max over placed values (> 0, whose bits
// order as the floats) over the block's threads, met in `part` (this
// spread's half of a double buffer, so one barrier a spread), then the
// entries.
__device__ void build_table(const ScanArgs& a, const float* cnt, int gk,
                            float* tb, unsigned (*part)[3]) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int V1 = a.V1, V = V1 - 1;
  const float* cn = cnt + (size_t)gk * V1;
  const float* ds = a.sdes + (size_t)gk * V1;
  unsigned mnb = __float_as_uint(BIGF), mxb = 0u, anyp = 0u;
  for (int v = tid; v < V; v += nt) {
    const float x = cn[v];
    if (x > 0.0f) {
      mnb = min(mnb, __float_as_uint(x));
      mxb = max(mxb, __float_as_uint(x));
      anyp = 1u;
    }
  }
  mnb = __reduce_min_sync(FULL, mnb);
  mxb = __reduce_max_sync(FULL, mxb);
  anyp = __reduce_or_sync(FULL, anyp);
  if (lane == 0) {
    part[warp][0] = mnb;
    part[warp][1] = mxb;
    part[warp][2] = anyp;
  }
  __syncthreads();
  mnb = lane < nw ? part[lane][0] : __float_as_uint(BIGF);
  mxb = lane < nw ? part[lane][1] : 0u;
  anyp = lane < nw ? part[lane][2] : 0u;
  mnb = __reduce_min_sync(FULL, mnb);
  mxb = __reduce_max_sync(FULL, mxb);
  anyp = __reduce_or_sync(FULL, anyp);
  const float mn = __uint_as_float(mnb);
  const float mx = anyp ? __uint_as_float(mxb) : -BIGF;
  const float mn_ = fmaxf(mn, 1e-9f);
  const float wf = a.wfrac[gk];
  const bool tgt = a.targeted[gk] != 0;
  for (int v = tid; v < V1; v += nt) {
    const bool missing = v >= V;
    const float cur = cn[v];
    const float des = ds[v];
    // targeted spread: ((desired - (used+1)) / desired) * weight_frac
    float t = -1.0f;
    if (!missing && des >= 0.0f)
      t = ((des - (cur + 1.0f)) / fmaxf(des, 1e-9f)) * wf;
    // even spread: delta vs min/max of placed values
    float e;
    if (cur != mn) e = (mn - cur) / mn_;
    else e = (mn == mx) ? -1.0f : (mx - mn) / mn_;
    if (missing) e = -1.0f;
    if (!anyp) e = 0.0f;
    tb[v] = tgt ? t : e;
  }
}

// The eval's deltas on the block's rows [lo, hi): each distinct local row
// goes to the thread of its first entry, which adds that row's entries
// in list order (`_add_deltas_local`).  Rows outside this shard drop.
__device__ void scan_deltas(const ScanArgs& a, const int* rows,
                            const float* vals, int D, int lo, int hi) {
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const int g = rows[k];
    const int r = g - a.off;
    if (r < lo || r >= hi) continue;
    bool first = true;
    for (int j = 0; j < k && first; ++j) first = rows[j] != g;
    if (!first) continue;
    float u[R];
#pragma unroll
    for (int d = 0; d < R; ++d) u[d] = a.used[r * R + d];
    for (int j = k; j < D; ++j) {
      if (rows[j] != g) continue;
#pragma unroll
      for (int d = 0; d < R; ++d) u[d] = u[d] + vals[j * R + d];
    }
#pragma unroll
    for (int d = 0; d < R; ++d) a.used[r * R + d] = u[d];
  }
}

template <bool J>
__global__ void __launch_bounds__(NT, 1)
scan_local_kernel(ScanArgs a, const float* __restrict__ used_in,
                  const int* __restrict__ drows,
                  const float* __restrict__ dvals, int D, int s, int init,
                  int* __restrict__ recs, int shard, int spread) {
  extern __shared__ float smem_tab[];
  __shared__ ScanShared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int rank = (int)cl.block_rank();
  const int n = a.n, K = a.K, V1 = a.V1, V = V1 - 1;
  int lo, hi;
  block_rows(n, SCAN_CLUSTER, rank, &lo, &hi);
  const float* part = reinterpret_cast<const float*>(a.cache);
  const float* fitc = part + n;
  const int* flag = a.cache + 2 * n;
  int* key = a.cache + 3 * n;

  if (init) {
    // the eval's start on the block's rows
    if (used_in)
      for (int i = lo + tid; i < hi; i += nt)
#pragma unroll
        for (int d = 0; d < R; ++d) a.used[i * R + d] = used_in[i * R + d];
    if (drows) {
      __syncthreads();
      jitter<J>(1);
      scan_deltas(a, drows, dvals, D, lo, hi);
      __syncthreads();
      jitter<J>(2);
    }
    for (int i = lo + tid; i < hi; i += nt)
      for (int g = 0; g < a.G; ++g) {
        const size_t gi = (size_t)g * n + i;
        a.tg_count[gi] = a.tg0[gi];
        a.place_cap[gi] = a.cap0[gi];
      }
    const size_t gkv = (size_t)a.G * K * V1;
    for (size_t x = (size_t)rank * nt + tid; x < gkv;
         x += (size_t)SCAN_CLUSTER * nt)
      a.counts[x] = a.counts0[x];
  }
  // the cache's key and the pending pick (none at the eval's start)
  int kg = -1;
  float kd[R] = {0.0f, 0.0f, 0.0f, 0.0f};
  int pick = -1;
  if (!init) {
    kg = key[KEY_G];
#pragma unroll
    for (int d = 0; d < R; ++d) kd[d] = __int_as_float(key[KEY_DEM + d]);
    pick = a.pick[0];
  }
  const bool mine = pick >= lo && pick < hi && (pick - lo) % nt == tid;

  if (!a.slot_active[s]) {
    // every local row scores -inf: the lowest rows head the top list.
    // The cache keeps its key; the pending pick is rescored under it.
    if (kg >= 0 && mine) {
      float p;
      score_row(a, kg, pick, kd, spread, &p);
    }
    if (rank == 0 && warp == 0) {
      const int kloc = min(TOPK, n);
      int* rec = recs + (size_t)shard * SCAN_REC;
      for (int w = lane; w < SCAN_REC; w += 32) {
        int v = 0;
        if (w == REC_BEST) v = __float_as_int(-INFINITY);
        else if (w == REC_ROW) v = a.off;
        else if (w >= REC_TOPS && w < REC_TOPI) v = __float_as_int(-INFINITY);
        else if (w >= REC_TOPI && w < REC_V)
          v = (w - REC_TOPI < kloc) ? a.off + (w - REC_TOPI) : BIGI;
        rec[w] = v;
      }
      if (init && lane == 0) key[KEY_G] = -1;
    }
    return;
  }

  const int g = a.slot_tg[s];
  float dem[R];
#pragma unroll
  for (int d = 0; d < R; ++d) dem[d] = a.demand[s * R + d];
  bool all = g != kg;
#pragma unroll
  for (int d = 0; d < R; ++d)
    all = all || __float_as_uint(dem[d]) != __float_as_uint(kd[d]);
  cluster_arrive();

  // -- the boost tables: every warp lists the group's active spreads;
  // the block builds their tables one after another
  float* tab = tables_in_cache(K, V1)
      ? reinterpret_cast<float*>(a.cache + 3 * (size_t)n + CACHE_META) +
            (size_t)rank * K * V1
      : smem_tab;
  const float* cnt = init ? a.counts0 : a.counts;
  unsigned am[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = h * 32 + lane;
    am[h] = __ballot_sync(FULL, k < K && a.active[g * K + k] != 0);
  }
  const int nact = __popc(am[0]) + __popc(am[1]);
  jitter<J>(3);
  {
    int q = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned b = am[h];
      while (b) {
        const int k = h * 32 + __ffs(b) - 1;
        b &= b - 1u;
        if (tid == 0) sh.act[q] = k;
        build_table(a, cnt, g * K + k, tab + (size_t)q * V1, sh.mm[q & 1]);
        ++q;
      }
    }
  }
  __syncthreads();
  jitter<J>(4);

  // -- the row pass: each row's score from its cache and the tables
  Top top;
  top_clear(top);
  int ne = 0, nx = 0;
  for (int i = lo + tid; i < hi; i += nt) {
    float p;
    unsigned fl;
    if (all || i == pick) {
      fl = score_row(a, g, i, dem, spread, &p);
    } else {
      p = part[i];
      fl = (unsigned)flag[i];
    }
    float sb = 0.0f;
    for (int q = 0; q < nact; ++q) {
      const int v = a.vidx[((size_t)g * K + sh.act[q]) * n + i];
      sb = sb + tab[(size_t)q * V1 + min(v, V)];
    }
    const bool sb_on = sb != 0.0f;
    const float total = p + (sb_on ? sb : 0.0f);
    const float nsc = (float)((fl >> 2) + (sb_on ? 1u : 0u));
    const float masked = (fl & F_FITS) ? total / nsc : -INFINITY;
    top_push(top, make_key(masked, a.off + i));
    ne += (fl & F_FEAS) ? 1 : 0;
    nx += (fl & (F_FEAS | F_FITS)) == F_FEAS ? 1 : 0;
  }

  // -- the block's top-5 and counts into block 0's slot
  Top wt;
  int first;
  warp_top(top, wt, &first);
  ne = __reduce_add_sync(FULL, ne);
  nx = __reduce_add_sync(FULL, nx);
  jitter<J>(5);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < TOPK; ++k) sh.wk[warp][k] = wt.k[k];
    sh.wc[warp][0] = ne;
    sh.wc[warp][1] = nx;
  }
  __syncthreads();
  jitter<J>(6);
  cluster_wait();        // block 0 has started: its slots may be written
  if (warp == 0) {
    Top t, bt;
#pragma unroll
    for (int k = 0; k < TOPK; ++k) t.k[k] = lane < nw ? sh.wk[lane][k] : 0ull;
    const int bne = __reduce_add_sync(FULL, lane < nw ? sh.wc[lane][0] : 0);
    const int bnx = __reduce_add_sync(FULL, lane < nw ? sh.wc[lane][1] : 0);
    warp_top(t, bt, &first);
    jitter<J>(7);
    if (lane == 0) {
      ScanShared* s0 = cl.map_shared_rank(&sh, 0);
#pragma unroll
      for (int k = 0; k < TOPK; ++k) s0->bk[rank][k] = bt.k[k];
      s0->bfit[rank] = bt.k[0] ? fitc[key_row(bt.k[0]) - a.off] : 0.0f;
      s0->bc[rank][0] = bne;
      s0->bc[rank][1] = bnx;
    }
  }
  cl.sync();
  jitter<J>(8);
  if (rank != 0 || warp != 0) return;

  // -- block 0's first warp: the cluster's top-5 and counts, the record
  Top t, ct;
#pragma unroll
  for (int k = 0; k < TOPK; ++k)
    t.k[k] = lane < SCAN_CLUSTER ? sh.bk[lane][k] : 0ull;
  const float bf = lane < SCAN_CLUSTER ? sh.bfit[lane] : 0.0f;
  ne = __reduce_add_sync(FULL, lane < SCAN_CLUSTER ? sh.bc[lane][0] : 0);
  nx = __reduce_add_sync(FULL, lane < SCAN_CLUSTER ? sh.bc[lane][1] : 0);
  warp_top(t, ct, &first);
  const float hf = __shfl_sync(FULL, bf, first);
  const float best = key_val(ct.k[0]);
  const int row = key_row(ct.k[0]);
  const bool any = best > -INFINITY;
  const int kloc = min(TOPK, n);
  u64 kq = 0ull;
#pragma unroll
  for (int j = 0; j < TOPK; ++j) kq = lane == j ? ct.k[j] : kq;
  int* rec = recs + (size_t)shard * SCAN_REC;
  if (lane == 0) {
    rec[REC_BEST] = __float_as_int(best);
    rec[REC_ROW] = row;
    rec[REC_FIT] = any ? __float_as_int(hf) : 0;
    rec[REC_NEVAL] = ne;
    rec[REC_NEXH] = nx;
    if (all) {
      key[KEY_G] = g;
#pragma unroll
      for (int d = 0; d < R; ++d) key[KEY_DEM + d] = __float_as_int(dem[d]);
    }
  }
  if (lane < TOPK) {
    rec[REC_TOPS + lane] = __float_as_int(lane < kloc ? key_val(kq) : -INFINITY);
    rec[REC_TOPI + lane] = lane < kloc ? key_row(kq) : BIGI;
  }
  for (int k = lane; k < MAXK; k += 32)
    rec[REC_V + k] = (any && k < K)
        ? a.vidx[((size_t)g * K + k) * n + (row - a.off)] : 0;
}

// K7b: one warp, every lane at work.  The records are read once, each
// word by one lane, straight into registers (two rounds of loads: the
// shards' heads and top lists, then the winner's spread value indices
// and the carry cells it updates; the spread counts' cells a third):
//  - lane j holds shard j's best; the pmax is a redux.sync over the
//    orderable score of the bests that are not NaN (the reference's
//    all-reduce keeps a value only where it beats the running maximum,
//    so a NaN never wins), its bits, so the sign of a zero, those of
//    the first shard at the maximum (of equal values the first stays);
//    the pmin over the rows of the shards at the maximum is a
//    redux.sync, its first shard the winner.
//  - the carries: R lanes the usage cells, K lanes the spread counts (one
//    cell a spread), one lane tg_count, place_cap and the pick word.
//  - the stable merge of the top lists: a candidate is position p of the
//    lists concatenated in shard order (p = j * kloc + q), held by lane
//    p % 32; its key is (the orderable score with -0.0 read as +0.0, NaN
//    lowest; then p ascending), as argsort(-tops, stable=True) ranks;
//    five rounds of the warp's maximum below the previous winner.  The
//    record's own bits go out, so a -0.0 stays -0.0.
constexpr int APPLY_MAX_SHARDS = 32;                // one lane a shard
constexpr int APPLY_CAND = APPLY_MAX_SHARDS * TOPK / 32;  // a lane's

// the merge's key of a top entry: NaN below every score
__device__ __forceinline__ unsigned merge_ord(float v) {
  return v != v ? 0u : orderable(v + 0.0f);
}

__global__ void __launch_bounds__(32, 1)
scan_apply_kernel(ScanArgs a, int s, const int* __restrict__ recs, int nsh,
                  float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int n = a.n, K = a.K, V1 = a.V1;
  const int kloc = min(TOPK, n);
  const int ncand = nsh * kloc;
  // round 1: the shards' heads, the candidates, the slot's group
  const bool mine = lane < nsh;
  const int* rj = recs + (size_t)lane * SCAN_REC;
  const float best = mine ? __int_as_float(rj[REC_BEST]) : 0.0f;
  const int row = mine ? rj[REC_ROW] : BIGI;
  const int fitb = mine ? rj[REC_FIT] : 0;
  const int ne_j = mine ? rj[REC_NEVAL] : 0;
  const int nx_j = mine ? rj[REC_NEXH] : 0;
  const bool emit = out != nullptr;
  unsigned cv[APPLY_CAND];     // the candidates' score bits and rows
  int ci[APPLY_CAND];
#pragma unroll
  for (int c = 0; c < APPLY_CAND; ++c) {
    const int p = lane + 32 * c;
    const bool has = emit && p < ncand;
    const int* rp = recs + (size_t)(p / kloc) * SCAN_REC + p % kloc;
    cv[c] = has ? (unsigned)rp[REC_TOPS] : 0u;
    ci[c] = has ? rp[REC_TOPI] : 0;
  }
  const int g = a.slot_tg[s];
  // the pmax over the bests that are not NaN (0: no such lane; no float
  // orders as 0) and the pmin of the rows that hold it
  const bool real = mine && best == best;
  const unsigned ob = real ? orderable(best + 0.0f) : 0u;
  const unsigned mx = __reduce_max_sync(FULL, ob);
  const unsigned at = __ballot_sync(FULL, real && ob == mx);
  const float gb = __shfl_sync(FULL, best, at ? __ffs(at) - 1 : 0);
  const bool any = mx > orderable(-INFINITY);
  const int sel = any ? __reduce_min_sync(FULL, ((at >> lane) & 1u) ? row
                                                                    : BIGI)
                      : BIGI;
  const bool ok = sel < BIGI;
  const int win = __ffs(__ballot_sync(FULL, ((at >> lane) & 1u) &&
                                                row == sel)) - 1;
  const int fit_w = __shfl_sync(FULL, fitb, win < 0 ? 0 : win);
  // round 2: the carries
  const int lr = sel - a.off;
  const bool here = ok && lr >= 0 && lr < n;
  if (here && lane < R)
    a.used[lr * R + lane] = a.used[lr * R + lane] + a.demand[s * R + lane];
  if (ok) {
    const int* rw = recs + (size_t)win * SCAN_REC + REC_V;
    for (int k = lane; k < K; k += 32) {
      const int v = rw[k];
      if (a.active[g * K + k] && v < V1 - 1)
        a.counts[((size_t)g * K + k) * V1 + v] += 1.0f;
    }
  }
  if (lane == R) {
    if (here) {
      const size_t gs = (size_t)g * n + lr;
      a.tg_count[gs] += 1;
      const int pc = a.place_cap[gs];
      if (pc > 0) a.place_cap[gs] = pc - 1;
    }
    a.pick[0] = here ? lr : -1;
  }
  if (!emit) return;
  // the packed row: heads, then the merge
  const int ne = __reduce_add_sync(FULL, ne_j);
  const int nx = __reduce_add_sync(FULL, nx_j);
  float* o = out + (size_t)s * OUTW;
  if (lane == 0) {
    o[0] = ok ? (float)sel : -1.0f;
    o[1] = ok ? gb : 0.0f;
    o[2] = ok ? __int_as_float(fit_w) + 0.0f : 0.0f;
    o[3] = (float)ne;
    o[4] = (float)nx;
  }
  u64 prev = ~0ull;
#pragma unroll
  for (int k = 0; k < TOPK; ++k) {
    u64 m = 0ull;
#pragma unroll
    for (int c = 0; c < APPLY_CAND; ++c) {
      const unsigned p = lane + 32 * c;
      const u64 key = p < (unsigned)ncand
          ? ((u64)merge_ord(__uint_as_float(cv[c])) << 32) | (~p)
          : 0ull;
      m = (key < prev && key > m) ? key : m;
    }
    const unsigned hi = __reduce_max_sync(FULL, (unsigned)(m >> 32));
    const unsigned lo =
        __reduce_max_sync(FULL, (unsigned)(m >> 32) == hi ? (unsigned)m : 0u);
    prev = ((u64)hi << 32) | lo;
    const unsigned p = ~lo;        // the winner: lane p % 32, slot p / 32
    unsigned v = 0u;
    int r = 0;
#pragma unroll
    for (int c = 0; c < APPLY_CAND; ++c) {
      v = (int)(p >> 5) == c ? cv[c] : v;
      r = (int)(p >> 5) == c ? ci[c] : r;
    }
    v = __shfl_sync(FULL, v, p & 31u);
    r = __shfl_sync(FULL, r, p & 31u);
    if (lane == k) {
      o[5 + k] = (float)r;
      o[5 + TOPK + k] = __uint_as_float(v);
    }
  }
}

// ------------------------------------------------------------- the bulk

// one shard of one lane (ops/sharded.py BulkShard, BulkArgs: packed once
// a shard); per-eval operands are [E, ...] with eval e at e * (its row
// size), outputs at e * ostride
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
  uint8_t* fits;             // bool[n]: each row's wave-start fit (K7c)
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

// A thread's, warp's or block's share of a K7c launch: the top-2 of cur
// (orderable keys: lax.top_k's order, NaN by its sign), the best m = 2
// score that is not NaN and whether one is NaN, the best cur that is not
// NaN, any fit; the tail's n_eval and n_exh.
struct StatsPart {
  unsigned a, b;
  float smax, cmax;
  int snan, fit, ne, nx;
};

__device__ __forceinline__ StatsPart stats_none() {
  return StatsPart{0u, 0u, -INFINITY, -INFINITY, 0, 0, 0, 0};
}

// every lane returns the warp's merged part (all 32 lanes call it)
__device__ __forceinline__ void warp_part(StatsPart& p) {
  warp_key_top2(p.a, p.b);
  p.smax = warp_max(p.smax);
  p.cmax = warp_max(p.cmax);
  p.snan = __any_sync(0xffffffffu, p.snan != 0) ? 1 : 0;
  p.fit = __any_sync(0xffffffffu, p.fit != 0) ? 1 : 0;
  p.ne = warp_sum(p.ne);
  p.nx = warp_sum(p.nx);
}

struct StatsShared {
  StatsPart warp[NW];
  StatsPart slot[STATS_CLUSTER];   // block 0's: one per block
};

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
    a.fits[i] = f1 ? 1 : 0;          // a fitting row may score -inf
    key_top2_push(p.a, p.b, orderable(cur));
    p.cmax = fmaxf(p.cmax, cur);             // fmaxf passes over a NaN
    if (f2) {
      if (isnan(s2)) p.snan = 1;
      else p.smax = fmaxf(p.smax, s2);
    }
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
    // the shard's part of s*: the reference's jnp.max is NaN where an
    // m = 2 score is, and its pmax passes over a NaN (bulk_stats_plain);
    // both maxima fold -0.0 into +0.0
    float* o = stats + (size_t)shard * STATS_W;
    o[0] = from_orderable(t.a);
    o[1] = from_orderable(t.b);
    o[2] = t.snan ? -INFINITY : t.smax + 0.0f;
    o[3] = t.fit ? 1.0f : 0.0f;
    o[4] = t.cmax + 0.0f;
  }
}

// (any_fit, s*, use_strict, gmax, gsecond) from the gathered statistics:
// the strict set is used where some row beats s* (the best cur that is
// not NaN does), the top-2 in lax.top_k's order
struct WaveGlobals {
  bool any_fit, use_strict;
  float s_star, gmax, gsecond;
};

__device__ __forceinline__ WaveGlobals wave_globals(const float* stats, int nsh) {
  WaveGlobals g{false, false, -INFINITY, -INFINITY, -INFINITY};
  unsigned ka = 0u, kb = 0u;
  float cmax = -INFINITY;
  for (int j = 0; j < nsh; ++j) {
    const float* s = stats + (size_t)j * STATS_W;
    key_top2_push(ka, kb, orderable(s[0]));
    key_top2_push(ka, kb, orderable(s[1]));
    g.s_star = fmaxf(g.s_star, s[2]);
    cmax = fmaxf(cmax, s[4]);
    g.any_fit = g.any_fit || s[3] > 0.0f;
  }
  g.gmax = from_orderable(ka);
  g.gsecond = from_orderable(kb);
  g.use_strict = cmax > g.s_star;
  return g;
}

// ------------------------------------------------------- K7d bulk_run
//
// The rows are independent (no row reads another's run) and every cell m
// of a row depends only on the row and m, so a launch is a grid of
// blocks of RUN_ROWS rows.  A block compacts its wave rows (a ballot and
// a prefix count, so idle lanes score no cell).  A first pass scores
// each wave row's cells m = 1..W1 over W1 lanes (the least power of two
// >= run_cap, at most RUN_W1: 32 / W1 rows a warp; most runs end there);
// the rows that pass all W1 go on to a second pass, a warp a row, 32
// cells at a time until one fails.  The run is the first failing m - 1
// (`__ballot_sync`, `__ffs`), or run_cap where none fails:
// `bulk_run_lengths`' leading run, m = 1 forced for a fitting row,
// capped at the remaining count.

constexpr int RUN_NT = 256;       // threads of a K7d block
constexpr int RUN_ROWS = 64;      // rows a K7d block owns
constexpr int RUN_W1 = 4;         // most lanes a row takes in the first pass
static_assert(RUN_ROWS <= RUN_NT, "a thread a row tests the wave");

// Whether cell m of row r fails the run: the row does not fit m more, or
// (m > 1) its score does not beat `second`.
__device__ __forceinline__ bool cell_fails(const BulkRow& r, const Eval& v,
                                           int m, float second, int spread) {
  bool f;
  float sc;
  grid_cell(r, v.dem, (float)m, v.desired_div, spread, &f, &sc);
  return !(f && (sc > second || m == 1));
}

__global__ void __launch_bounds__(RUN_NT)
bulk_run_kernel(BulkArgs a, int e, const float* __restrict__ stats, int nsh,
                const float* __restrict__ cur_g, int* __restrict__ base_g,
                int spread, int fill_grid) {
  __shared__ int list[RUN_ROWS];
  __shared__ int longs[RUN_ROWS];
  __shared__ int wn[RUN_NT / 32];
  __shared__ int nlong;
  if (a.state[ST_DONE]) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Eval v = eval_of(a, e);
  const WaveGlobals g = wave_globals(stats, nsh);
  const int run_cap = min(fill_grid, v.count - a.state[ST_PLACED]);
  const int lo = blockIdx.x * RUN_ROWS;
  const int hi = min(lo + RUN_ROWS, a.n);

  // the block's wave rows, in row order; every other row's run is 0
  bool need = false;
  if (lo + tid < hi && tid < RUN_ROWS) {
    const float cur = cur_g[a.off + lo + tid];
    const bool fits = a.fits[lo + tid] != 0;
    need = g.any_fit && run_cap > 0 &&
        (g.use_strict ? (cur > g.s_star) : (fits && cur == g.gmax));
    if (!need) base_g[a.off + lo + tid] = 0;
  }
  const unsigned m = __ballot_sync(FULL, need);
  if (lane == 0) wn[warp] = __popc(m);
  if (tid == 0) nlong = 0;
  __syncthreads();
  int pre = 0, cnt = 0;
#pragma unroll
  for (int w = 0; w < RUN_NT / 32; ++w) {
    pre += w < warp ? wn[w] : 0;
    cnt += wn[w];
  }
  if (need) list[pre + __popc(m & ((1u << lane) - 1u))] = lo + tid;
  __syncthreads();

  // the first pass: cells 1..W1 of each row over W1 lanes
  int W = 1;
  while (W < run_cap && W < RUN_W1) W <<= 1;
  const int sub = lane / W, cell = lane % W;
  const unsigned gmask = ((1u << W) - 1u) << (sub * W);
  const int per = 32 / W;
  for (int b0 = warp * per; b0 < cnt; b0 += (RUN_NT / 32) * per) {
    const int idx = b0 + sub;
    const bool has = idx < cnt;
    const int i = has ? list[idx] : 0;
    BulkRow r;
    float second = 0.0f;
    if (has) {
      load_row(r, a, v, i);
      const float cur = cur_g[a.off + i];
      second = (cur == g.gmax) ? g.gsecond : g.gmax;
    }
    const int mm = cell + 1;
    const bool fail = has && mm <= run_cap && cell_fails(r, v, mm, second,
                                                         spread);
    const unsigned mine = __ballot_sync(FULL, fail) & gmask;
    if (has && cell == 0) {
      if (mine) base_g[a.off + i] = __ffs(mine) - sub * W - 1;
      else if (W >= run_cap) base_g[a.off + i] = run_cap;
      else longs[atomicAdd(&nlong, 1)] = i;
    }
  }
  __syncthreads();

  // the second pass: each remaining row a warp, 32 cells at a time
  for (int j = warp; j < nlong; j += RUN_NT / 32) {
    const int i = longs[j];
    BulkRow r;
    load_row(r, a, v, i);
    const float cur = cur_g[a.off + i];
    const float second = (cur == g.gmax) ? g.gsecond : g.gmax;
    int first = run_cap + 1;          // the first failing m
    for (int c0 = W; c0 < run_cap; c0 += 32) {
      const int mm = c0 + lane + 1;
      const bool fail = mm <= run_cap && cell_fails(r, v, mm, second, spread);
      const unsigned bal = __ballot_sync(FULL, fail);
      if (bal) {
        first = c0 + __ffs(bal);
        break;
      }
    }
    if (lane == 0) base_g[a.off + i] = first - 1;
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
// and whose usage kept its bits keeps the wave-start score cur and fit
// (K7c's `fits`: the same inputs give the same score), so only rows that
// took instances are scored again.
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
    bool feas[TCH], fit[TCH];
    float s[TCH];
#pragma unroll
    for (int q = 0; q < TCH; ++q) {
      const int i = i0 + q * NT;
      const bool in = i < a.n;
      asg[q] = in ? v.assign[i] : 0;
      feas[q] = in && v.feas[i] != 0;
      fit[q] = in && a.fits[i] != 0;
      s[q] = in ? cur_g[a.off + i] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < TCH; ++q) {
      const int i = i0 + q * NT;
      if (i >= a.n) continue;
      bool fits = fit[q];
      if (rescore_all || asg[q] > 0) {
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

// K7g: a thread a row; the row's R = 4 floats come as one 16-byte load
// from u0 and from each lane's exact carry, every lane's load issued
// before the adds, which keep the reference's order: acc = (e0 - u) +
// (e1 - u) + ..., then u + acc.  WL lanes compiled in (1, 2, 4: the
// meshes' wave axes), or WL = 0: any W, BASIS_LANES loads in flight at a
// time.  `out` may be u0 itself (each thread reads its row before it
// writes it).
//
// Node shard 0's launch also carries K7f (CNT; no launch of its own):
// with `partials` i32[W, nsh, E, 4] (each lane's shards' (placed,
// n_eval, n_exh, waves) per eval), thread j < W * E writes counts[j] of
// i32[W, E, 4] for lane j / E, eval j % E: placed and waves from shard
// 0, n_eval and n_exh summed over the shards in shard order (integers:
// exact in any order).  Its shards' 16-byte records are loaded with its
// row, COUNT_LANES at a time, before any arithmetic (a block of its own
// after the row blocks made the launch slower, PERF.md); the grid
// covers max(n, W * E) threads.  The wrapper refuses unaligned operands.
constexpr int BASIS_NT = 128;      // threads a block, by measurement (PERF.md)
constexpr int BASIS_LANES = 8;
constexpr int COUNT_LANES = 8;
static_assert(R == 4, "a row is one float4");

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int WL, bool CNT>
__global__ void __launch_bounds__(BASIS_NT)
basis_merge_kernel(const float4* u0, const float4* __restrict__ exacts,
                   float4* out, int W, int n,
                   const int4* __restrict__ partials,
                   int4* __restrict__ counts, int nsh, int E) {
  const int i = blockIdx.x * BASIS_NT + threadIdx.x;
  const bool cnt = CNT && i < W * E;
  int4 q[COUNT_LANES];
  const int4* p = partials;
  if constexpr (CNT) {
    if (cnt) {
      const int w = i / E, e = i - w * E;
      p = partials + (size_t)w * nsh * E + e;
#pragma unroll
      for (int k = 0; k < COUNT_LANES; ++k)
        if (k < nsh) q[k] = p[(size_t)k * E];
    }
  }
  if (i < n) {
    const float4 u = u0[i];
    constexpr int L = WL > 0 ? WL : BASIS_LANES;
    const int lanes = WL > 0 ? WL : W;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w0 = 0; w0 < lanes; w0 += L) {
      float4 ex[L];
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (w0 + k < lanes) ex[k] = exacts[(size_t)(w0 + k) * n + i];
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (w0 + k < lanes) acc = w0 + k == 0 ? sub4(ex[k], u)
                                              : add4(acc, sub4(ex[k], u));
    }
    out[i] = add4(u, acc);
  }
  if (CNT && cnt) {
    int ne = 0, nx = 0;
#pragma unroll
    for (int k = 0; k < COUNT_LANES; ++k)
      if (k < nsh) {
        ne += q[k].y;
        nx += q[k].z;
      }
    for (int s = COUNT_LANES; s < nsh; ++s) {
      const int4 r = p[(size_t)s * E];
      ne += r.y;
      nx += r.z;
    }
    counts[i] = make_int4(q[0].x, ne, nx, q[0].w);
  }
}

template <int WL>
void merge_launch(int blocks, cudaStream_t st, const float4* u,
                  const float4* e, float4* o, int W, int n, const int4* p,
                  int4* c, int nsh, int E) {
  if (p)
    basis_merge_kernel<WL, true><<<blocks, BASIS_NT, 0, st>>>(
        u, e, o, W, n, p, c, nsh, E);
  else
    basis_merge_kernel<WL, false><<<blocks, BASIS_NT, 0, st>>>(
        u, e, o, W, n, p, c, nsh, E);
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

// One K7a cluster of SCAN_CLUSTER blocks, a thread a row of a block's
// share (at most NT), its tables in dynamic shared memory unless they
// live in the cache.
template <bool J>
cudaError_t scan_launch(const ScanArgs& a, const float* used_in,
                        const int* drows, const float* dvals, int D, int s,
                        int init, int* recs, int shard, int spread,
                        cudaStream_t stream) {
  const int rpb = (a.n + SCAN_CLUSTER - 1) / SCAN_CLUSTER;
  const int threads = min(NT, max(32, (rpb + 31) / 32 * 32));
  const size_t smem = tables_in_cache(a.K, a.V1)
      ? 0 : (size_t)a.K * a.V1 * sizeof(float);
  return cluster_launch(scan_local_kernel<J>, SCAN_CLUSTER, threads,
                        TAB_SMEM * sizeof(float), smem, stream, a, used_in,
                        drows, dvals, D, s, init, recs, shard, spread);
}

}  // namespace

// K7a: one slot on one shard, its operands packed once (`a`); used_in,
// drows and dvals only at the eval's first slot (init).
extern "C" int scan_local_launch(const void* args, const float* used_in,
                                 const int* drows, const float* dvals, int D,
                                 int s, int init, int* recs, int shard,
                                 int spread_alg, void* stream) {
  const ScanArgs* a = static_cast<const ScanArgs*>(args);
  if (a->K < 1 || a->K > MAXK || a->n < 1 || a->V1 < 1 ||
      (size_t)a->cache_words < scan_cache_words(a->n, a->K, a->V1))
    return (int)cudaErrorInvalidValue;
  return (int)(jitter_on
      ? scan_launch<true>(*a, used_in, drows, dvals, D, s, init, recs, shard,
                          spread_alg, (cudaStream_t)stream)
      : scan_launch<false>(*a, used_in, drows, dvals, D, s, init, recs, shard,
                           spread_alg, (cudaStream_t)stream));
}

// i32 words of K7a's cache for n rows, K spreads over V1 - 1 values
extern "C" int scan_cache_words_of(int n, int K, int V1) {
  return (int)scan_cache_words(n, K, V1);
}

// K7b: one slot's selection and carry updates on one shard, its operands
// packed once (`a`, K7a's); `out` (shard 0's) may be null.
extern "C" int scan_apply_launch(const void* args, int s, const int* recs,
                                 int nsh, float* out, void* stream) {
  const ScanArgs* a = static_cast<const ScanArgs*>(args);
  if (a->K < 1 || a->K > MAXK || a->n < 1 || nsh < 1 ||
      nsh > APPLY_MAX_SHARDS || nsh * min(TOPK, a->n) < TOPK)
    return (int)cudaErrorInvalidValue;
  scan_apply_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(*a, s, recs, nsh,
                                                        out);
  return (int)cudaGetLastError();
}

// The delays' seed for the K7a and K7c launches that follow on `stream`
// (0: the kernels without the delay sites).  A check's setting: no other
// host thread may launch them meanwhile.
extern "C" int sharded_set_jitter(int seed, void* stream) {
  return (int)set_jitter(seed, (cudaStream_t)stream);
}

extern "C" int bulk_stats_cluster_size() { return STATS_CLUSTER; }

extern "C" int bulk_stats_launch(const void* args, int e, int begin,
                                 float* stats, float* cur_g, int shard,
                                 int spread, int max_waves, void* stream) {
  const BulkArgs* a = static_cast<const BulkArgs*>(args);
  if (a->n < 1) return (int)cudaErrorInvalidValue;
  const int rpb = (a->n + STATS_CLUSTER - 1) / STATS_CLUSTER;
  const int threads = min(NT, max(32, (rpb + 31) / 32 * 32));
  return (int)(jitter_on
      ? stats_launch<true>(threads, (cudaStream_t)stream, *a, e, begin,
                           stats, cur_g, shard, spread, max_waves)
      : stats_launch<false>(threads, (cudaStream_t)stream, *a, e, begin,
                            stats, cur_g, shard, spread, max_waves));
}

extern "C" int bulk_run_launch(const void* args, int e, const float* stats,
                               int nsh, const float* cur_g, int* base_g,
                               int spread, int fill_grid, void* stream) {
  const BulkArgs* a = static_cast<const BulkArgs*>(args);
  if (a->n < 1 || fill_grid < 1 || fill_grid > 255)
    return (int)cudaErrorInvalidValue;
  bulk_run_kernel<<<(a->n + RUN_ROWS - 1) / RUN_ROWS, RUN_NT, 0,
                    (cudaStream_t)stream>>>(*a, e, stats, nsh, cur_g, base_g,
                                            spread, fill_grid);
  return (int)cudaGetLastError();
}

extern "C" int bulk_order_launch(const void* args, int e, const float* stats,
                                 int nsh, const float* cur_g,
                                 const int* base_g, int spread, int max_waves,
                                 void* stream) {
  const BulkArgs* a = static_cast<const BulkArgs*>(args);
  if (a->n < 1 || a->N < a->n || a->N > (1 << 24))
    return (int)cudaErrorInvalidValue;
  bulk_order_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      *a, e, stats, nsh, cur_g, base_g, spread, max_waves);
  return (int)cudaGetLastError();
}

// K7g on one shard of n rows: u0, out f32[n, 4], exacts f32[W, n, 4];
// with partials i32[W, nsh, E, 4] (else null) also K7f's counts i32[W,
// E, 4]; each 16-byte aligned (the wrapper checks)
extern "C" int basis_merge_launch(const float* u0, const float* exacts,
                                  float* out, int W, int n,
                                  const int* partials, int* counts, int nsh,
                                  int E, void* stream) {
  if (W < 1 || n < 0 || (partials && (nsh < 1 || E < 0 || !counts)))
    return (int)cudaErrorInvalidValue;
  const int threads = partials ? max(n, W * E) : n;
  const int blocks = (threads + BASIS_NT - 1) / BASIS_NT;
  if (blocks == 0) return 0;
  const float4* u = reinterpret_cast<const float4*>(u0);
  const float4* e = reinterpret_cast<const float4*>(exacts);
  float4* o = reinterpret_cast<float4*>(out);
  const int4* p = reinterpret_cast<const int4*>(partials);
  int4* c = reinterpret_cast<int4*>(counts);
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 1: merge_launch<1>(blocks, st, u, e, o, W, n, p, c, nsh, E); break;
    case 2: merge_launch<2>(blocks, st, u, e, o, W, n, p, c, nsh, E); break;
    case 4: merge_launch<4>(blocks, st, u, e, o, W, n, p, c, nsh, E); break;
    default: merge_launch<0>(blocks, st, u, e, o, W, n, p, c, nsh, E);
  }
  return (int)cudaGetLastError();
}
