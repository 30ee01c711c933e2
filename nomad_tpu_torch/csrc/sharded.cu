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
//                    start (deltas into the carry, coll0, lane state).
//   K7d bulk_run     the fill run of every local row in the wave set
//                    (strict if the gathered top score beats s*, else
//                    the ties), into the gathered [N] run vector.
//   K7e bulk_order   the greedy order over the gathered vectors (the
//                    same on every shard: the stable (score desc, row
//                    asc) key sort of bulk_common.cuh, in shared memory
//                    up to 16,384 rows, in a global scratch past them),
//                    this shard's share of it, the lane state and the
//                    stop test; the eval's tail when it ends.
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
// of 1024 threads per launch (K7a, K7c-K7e), as K2/K4.
//
// Numerics: compiled without fast math and with -fmad=false; powf; the
// reference's operation order, so scores are the plain versions' bit
// for bit (fit/18 as a multiply by the f32 reciprocal, as XLA compiles
// the reference's division by that constant).

#include "bulk_common.cuh"

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

struct BulkShared {
  float f[NW];
  float f2[NW];
  int i[NW];
};

// The eval's tail on this shard: final scores, local n_eval/n_exh (into
// the partial counts with the lane's placed/waves), exact carry +=
// assign * demand, deltas backed out of the chain carry.
__device__ void bulk_tail(const BulkArgs& a, const Eval& v, int e,
                          int spread, BulkShared& sh) {
  const int tid = threadIdx.x;
  int n_eval = 0, n_exh = 0;
  for (int i = tid; i < a.n; i += NT) {
    BulkRow r;
    load_row(r, a, v, i);
    bool f;
    float s;
    grid_cell(r, v.dem, 1.0f, v.desired_div, spread, &f, &s);
    v.scores[i] = f ? s : -INFINITY;
    n_eval += r.feas ? 1 : 0;
    n_exh += (r.feas && !f) ? 1 : 0;
  }
  n_eval = block_sum(n_eval, sh.i);
  n_exh = block_sum(n_exh, sh.i);
  for (int i = tid; i < a.n * R; i += NT) {
    const float inc = (float)v.assign[i / R] * v.dem[i % R];
    a.exact[i] = a.exact[i] + inc;
    if (a.drows) a.used[i] = a.used[i] - a.delta[i];
  }
  if (tid == 0) {
    int* p = a.partial + (size_t)e * COUNTS_W;
    p[0] = a.state[ST_PLACED];
    p[1] = n_eval;
    p[2] = n_exh;
    p[3] = a.state[ST_WAVES];
  }
  __syncthreads();
}

// the stop test of `_bulk_loop`'s while_loop into the lane state
__device__ __forceinline__ void stop_test(const BulkArgs& a, const Eval& v,
                                          int max_waves) {
  int* st = a.state;
  const bool go = st[ST_PLACED] < v.count && !st[ST_STUCK] &&
                  st[ST_WAVES] < max_waves;
  st[ST_DONE] = go ? 0 : 1;
}

__global__ void __launch_bounds__(NT, 1)
bulk_stats_kernel(BulkArgs a, int e, int begin, float* __restrict__ stats,
                  float* __restrict__ cur_g, int shard, int spread,
                  int max_waves) {
  __shared__ BulkShared sh;
  const int tid = threadIdx.x;
  const Eval v = eval_of(a, e);
  int* st = a.state;
  if (begin) {
    if (a.drows) {
      // used += this eval's deltas (in order); delta = used - used_in
      for (int i = tid; i < a.n * R; i += NT) a.delta[i] = a.used[i];
      __syncthreads();
      if (tid == 0) {
        const int* rows = a.drows + (size_t)e * a.D;
        const float* vals = a.dvals + (size_t)e * a.D * R;
        for (int k = 0; k < a.D; ++k) {
          const int r = rows[k] - a.off;
          if (r < 0 || r >= a.n) continue;
          for (int d = 0; d < R; ++d)
            a.used[r * R + d] = a.used[r * R + d] + vals[k * R + d];
        }
      }
      __syncthreads();
      for (int i = tid; i < a.n * R; i += NT) a.delta[i] = a.used[i] - a.delta[i];
    }
    const int* c0 = a.coll0 + (size_t)e * a.n;
    for (int i = tid; i < a.n; i += NT) {
      a.coll[i] = c0[i];
      v.assign[i] = 0;
    }
    if (tid == 0) {
      st[ST_PLACED] = 0;
      st[ST_WAVES] = 0;
      st[ST_STUCK] = 0;
      stop_test(a, v, max_waves);
    }
    __syncthreads();
    if (st[ST_DONE]) {
      bulk_tail(a, v, e, spread, sh);
      return;
    }
  }
  if (st[ST_DONE]) return;

  float t1 = -INFINITY, t2 = -INFINITY, smax = -INFINITY;
  int anyfit = 0;
  for (int i = tid; i < a.n; i += NT) {
    BulkRow r;
    load_row(r, a, v, i);
    bool f1, f2;
    float s1, s2;
    grid_cell(r, v.dem, 1.0f, v.desired_div, spread, &f1, &s1);
    grid_cell(r, v.dem, 2.0f, v.desired_div, spread, &f2, &s2);
    const float cur = f1 ? s1 : -INFINITY;
    cur_g[a.off + i] = cur;
    top2_push(t1, t2, cur);
    if (f2) smax = fmaxf(smax, s2);
    anyfit |= f1 ? 1 : 0;
  }
  block_top2(t1, t2, sh.f, sh.f2);
  smax = block_max(smax, sh.f);
  anyfit = block_sum(anyfit, sh.i);
  if (tid == 0) {
    float* o = stats + (size_t)shard * STATS_W;
    o[0] = t1;
    o[1] = t2;
    o[2] = smax;
    o[3] = anyfit ? 1.0f : 0.0f;
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

// the sort key of gathered row j: (orderable(-cur) << 32 | row << 8 |
// run), ascending = score desc, row asc; NO_KEY outside the wave
__device__ __forceinline__ unsigned long long order_key(
    const float* cur_g, const int* base_g, int j) {
  const int b = base_g[j];
  if (b <= 0) return NO_KEY;
  return ((unsigned long long)orderable(-cur_g[j] + 0.0f) << 32) |
         ((unsigned long long)j << 8) | (unsigned long long)b;
}

__global__ void __launch_bounds__(NT, 1)
bulk_order_kernel(BulkArgs a, int e, const float* __restrict__ stats, int nsh,
                  const float* __restrict__ cur_g,
                  const int* __restrict__ base_g, unsigned long long* gkeys,
                  int spread, int max_waves) {
  extern __shared__ unsigned long long skeys[];  // sort_len(N), or none
  __shared__ BulkShared sh;
  if (a.state[ST_DONE]) return;
  const int tid = threadIdx.x;
  const Eval v = eval_of(a, e);
  const WaveGlobals g = wave_globals(stats, nsh);
  const int N = a.N;
  const int remaining = v.count - a.state[ST_PLACED];
  unsigned long long* keys = gkeys ? gkeys : skeys;

  int q;
  if (!gkeys) {
    q = sort_len(N);
    for (int j = tid; j < q; j += NT)
      keys[j] = (j < N) ? order_key(cur_g, base_g, j) : NO_KEY;
  } else {
    // past shared memory: the wave rows' keys packed to the front
    int base = 0;
    for (int c0 = 0; c0 < N; c0 += NT) {
      const int j = c0 + tid;
      const unsigned long long key =
          (j < N) ? order_key(cur_g, base_g, j) : NO_KEY;
      const int in = (key != NO_KEY) ? 1 : 0;
      int total;
      const int pos = base + block_exclusive_scan(in, sh.i, &total);
      if (in) keys[pos] = key;
      base += total;
    }
    q = sort_len(base);
    for (int k = base + tid; k < q; k += NT) keys[k] = NO_KEY;
  }
  __syncthreads();
  block_bitonic_sort(keys, q);

  // cumulative cap at the remaining count, in sorted order; this shard
  // adds the allocations of its own rows
  const int per = (q + NT - 1) / NT;
  const int lo = min(tid * per, q), hi = min(lo + per, q);
  int local = 0;
  for (int k = lo; k < hi; ++k) {
    const unsigned long long key = keys[k];
    if (key != NO_KEY) local += (int)(key & 0xFFull);
  }
  int total_base;
  int prefix = block_exclusive_scan(local, sh.i, &total_base);
  for (int k = lo; k < hi; ++k) {
    const unsigned long long key = keys[k];
    if (key == NO_KEY) continue;
    const int b = (int)(key & 0xFFull);
    const int row = (int)((key >> 8) & 0xFFFFFFull);
    const int alloc = min(max(remaining - prefix, 0), b);
    prefix += b;
    const int l = row - a.off;
    if (alloc > 0 && l >= 0 && l < a.n) {
      const float af = (float)alloc;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        const float inc = af * v.dem[d];
        a.used[l * R + d] = a.used[l * R + d] + inc;
      }
      a.coll[l] += alloc;
      v.assign[l] += alloc;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int* st = a.state;
    st[ST_PLACED] += min(remaining, total_base);
    st[ST_WAVES] += 1;
    st[ST_STUCK] = g.any_fit ? 0 : 1;
    stop_test(a, v, max_waves);
  }
  __syncthreads();
  if (a.state[ST_DONE]) bulk_tail(a, v, e, spread, sh);
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

extern "C" int bulk_stats_launch(BULK_PARAMS, int e, int begin, float* stats,
                                 float* cur_g, int shard, int spread,
                                 int max_waves, void* stream) {
  bulk_stats_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      BULK_ARGS, e, begin, stats, cur_g, shard, spread, max_waves);
  return (int)cudaGetLastError();
}

extern "C" int bulk_run_launch(BULK_PARAMS, int e, const float* stats,
                               int nsh, const float* cur_g, int* base_g,
                               int spread, int fill_grid, void* stream) {
  if (fill_grid < 1 || fill_grid > 255) return (int)cudaErrorInvalidValue;
  bulk_run_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      BULK_ARGS, e, stats, nsh, cur_g, base_g, spread, fill_grid);
  return (int)cudaGetLastError();
}

// gkeys: NULL for N <= SMEM_SORT_ROWS (the sort runs in shared memory),
// else a u64[sort_len(N)] global scratch (compacted wave sort)
extern "C" int bulk_order_launch(BULK_PARAMS, int e, const float* stats,
                                 int nsh, const float* cur_g,
                                 const int* base_g, unsigned long long* gkeys,
                                 int spread, int max_waves, void* stream) {
  if ((gkeys == nullptr) != (N <= SMEM_SORT_ROWS) || N > (1 << 24))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gkeys ? 0 : (size_t)sort_len(N) * sizeof(unsigned long long);
  cudaError_t err = allow_smem_sort(bulk_order_kernel);
  if (err != cudaSuccess) return (int)err;
  bulk_order_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      BULK_ARGS, e, stats, nsh, cur_g, base_g, gkeys, spread, max_waves);
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
