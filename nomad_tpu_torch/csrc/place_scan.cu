// place_scan.cu — sequential placement scan over the slots of one
// evaluation (K2), and the chained batch of such evals over the packed
// transport (K3), for Hopper (sm_90a).
//
// Replaces: nomad_tpu/ops/place.py `place_eval_packed_jit` (and, with the
// unpacked wrapper, `place_eval_jit`): the `lax.scan` of `_place_step`
// with `_spread_boost` and `_pack_outputs` (K2); and
// `place_batch_packed_jit` (K3), the `lax.scan` over E evals of that
// scan, each eval's fields unpacked from its heavy block
// (`_unpack_heavy`) and light block (`_unpack_light`).  The plain
// PyTorch versions are nomad_tpu_torch/ops/place.py `place_eval_plain`
// and `place_batch_packed_plain`; K3 agrees with its plain version bit
// for bit, K2 runs the same body.
//
// What bounds it on this card: latency, not bytes.  Each slot step must
// finish its argmax before the next can start, because the carry (used,
// tg_count, place_cap, spread counts) changes at the row it picks; S
// steps are S dependent cluster-wide reductions, and K3's E evals are
// E*S of them, since the usage carry passes from eval to eval.
//
// Design: ONE thread-block cluster of CLUSTER blocks x 1024 threads runs
// every slot and, for K3, every eval of the chain inside one launch.
// Block b owns a contiguous range of rows, thread t of it rows
// lo + t, lo + t + 1024, ...; every per-row state (used, tg_count,
// place_cap, the cached scores) is written by its owner block only.
//  - The cache.  Between two active slots of the same group and demand
//    only the picked row's used, tg_count and place_cap change, and the
//    reference adds the scoring terms in a fixed order (fit, + anti,
//    - penalty, + affinity, + spread, then / n).  So each row keeps its
//    partial total (fit + anti - penalty + affinity), its fit, its
//    scorer count and its feasible and fits flags, in shared memory (in
//    a global scratch past SMEM_ROWS rows a block).  Every row is
//    rescored at an eval's first active slot and whenever a slot's group
//    or demand differs from the last active slot's; otherwise only the
//    picked row is.
//  - The spread term depends on a row only through its value index of
//    each active spread, so each step one warp builds the group's boost
//    table (one entry per value) from the block's own copy of the eval's
//    spread state (counts and their min and max over placed values,
//    desired counts, weights), and every row adds its entries in spread
//    order, then divides by n.  Each block updates its copy of the counts
//    identically from the picked row's value indices.  The additions keep
//    the reference's order, so the scores are the plain version's bit
//    for bit.
//  - The top-5.  Each thread keeps a sorted list of 64-bit keys (the
//    orderable score, -0.0 read as +0.0, then the row inverted, so the
//    larger key is the higher score and then the lower row: lax.top_k's
//    order; the low bit keeps a -0.0 score's sign for the output).
//    Warps merge their lanes' lists with redux.sync, one warp the
//    block's warp lists into the block's exchange slot (with its first
//    row's fit and value indices, and the counts), and after one cluster
//    barrier a step one warp in every block merges the cluster's
//    CLUSTER block lists, read over distributed shared memory, so every
//    block knows the pick without a broadcast.  An exchange slot is
//    written again two steps later, after the next step's barrier, by
//    which time every block has read it.
//  - The carry.  While the barrier waits, that warp computes its block's
//    first row's state should the slot pick it (usage, tg_count,
//    place_cap and the new partial); the owner block writes it, every
//    block updates its counts, block 0 writes the slot's output row.
//    Only exact reductions cross the cluster, so every block takes the
//    same branch; the kernel ends in a cluster barrier, so no block
//    exits while another reads its shared memory.
//  - K3 adds each eval's deltas into the usage carry before its slots
//    and keeps them (the reference's chain carries them on): each delta
//    row's owner adds its deltas in list order, a row in [-N, 0) taken
//    as row + N (JAX's index), other rows outside [0, N) dropped.
//  - The reference adds the carry to every row at every slot (0 to all
//    but the picked row), which turns a -0.0 usage into +0.0; the scores
//    do not see the sign of a zero, so the kernel adds 0 to a row only
//    where that changes a bit: at the end of an eval, to every row but
//    the last slot's pick, and before a picked row's update, unless it
//    was the previous slot's pick.
// The field reads go through an accessor (K2: typed arrays; K3: the
// packed f32 blocks, integers value-encoded, booleans > 0.5), so both
// kernels run one body; a slot's fields are read a step ahead.  Each
// boost table costs its warp V1/32 entries a lane a step: cheap for
// racks, zones and datacenters, slower for a spread over thousands of
// values.  The barriers are checked with the delays of cluster.cuh
// (place_scan_set_jitter): a site before every write another thread
// reads (shared, distributed shared or global memory), after every
// barrier that orders such a read, and between the read and the write
// of the eval's last + 0.
//
// Numerics: compiled without fast math and with -fmad=false; powf (not
// __powf); the reference's operation order (fit/18 as a multiply by the
// f32 reciprocal, as XLA compiles it; -(coll+1)/max(desired,1);
// total/n_scorers).

#include <cooperative_groups.h>

#include "bulk_common.cuh"
#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = NRES;
constexpr int TOPK = 5;
constexpr int OUTW = 5 + 2 * TOPK;
constexpr int MAXK = 64;
// blocks of the cluster: 16, a size past the portable 8 (cluster_launch
// allows it), measured faster than 8 at 16,384 rows and at 131,072
constexpr int CLUSTER = 16;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int RCH = 4;            // rows of a thread the row pass loads at once
// rows a block caches in shared memory (9 bytes a row); past it the
// cache lives in the global scratch
constexpr int SMEM_ROWS = 16384;
// floats of spread state (spread_floats) kept in shared memory; past it
// in the scratch
constexpr int SMEM_SPREAD = 8192;
constexpr size_t ROW_BYTES = 9;
constexpr size_t SMEM_MAX =
    ((SMEM_ROWS * ROW_BYTES + 15) & ~(size_t)15) + SMEM_SPREAD * 4;
static_assert(NW == 32, "one warp reads the block's warp lists");
static_assert(CLUSTER <= 32, "one warp reads the cluster's lists");
static_assert(MAXK <= 2 * 32, "two ballots list the active spreads");

typedef unsigned long long u64;

// floats of a block's spread state: counts and desired counts [G, K, V1],
// one group's boost tables [K, V1], weight fractions and flags [G, K]
__host__ __device__ __forceinline__ size_t spread_floats(int G, int K,
                                                         int V1) {
  return (2 * (size_t)G + 1) * K * V1 + 2 * (size_t)G * K;
}

// the cache's flag byte: bit 0 feasible, bit 1 fits, bits 2.. the scorer
// count before the spread term (1..4)
constexpr unsigned F_FEAS = 1u, F_FITS = 2u;

// K2's fields, as the wrapper passes them (typed arrays)
struct K2Src {
  const uint8_t* feasible;
  const float* affinity;
  const uint8_t* has_affinity;
  const int* desired_count;
  const uint8_t* penalty;
  const int* tg_count0;
  const int* spread_vidx;
  const float* spread_desired;
  const uint8_t* spread_targeted;
  const float* spread_wfrac;
  const float* spread_counts0;
  const uint8_t* spread_active;
  const int* place_cap0;
  const float* demand;
  const int* slot_tg;
  const uint8_t* slot_active;
  __device__ bool feas(size_t gi) const { return feasible[gi] != 0; }
  __device__ float aff(size_t gi) const { return affinity[gi]; }
  __device__ bool has_aff(int g) const { return has_affinity[g] != 0; }
  __device__ int desired(int g) const { return desired_count[g]; }
  __device__ bool pen(size_t gi) const { return penalty[gi] != 0; }
  __device__ int tg0(size_t gi) const { return tg_count0[gi]; }
  __device__ int cap0(size_t gi) const { return place_cap0[gi]; }
  __device__ int vidx(size_t x) const { return spread_vidx[x]; }
  __device__ float sdes(size_t x) const { return spread_desired[x]; }
  __device__ float counts0(size_t x) const { return spread_counts0[x]; }
  __device__ bool targeted(int gk) const { return spread_targeted[gk] != 0; }
  __device__ float wfrac(int gk) const { return spread_wfrac[gk]; }
  __device__ bool active(int gk) const { return spread_active[gk] != 0; }
  __device__ float dem(int s, int d) const { return demand[s * R + d]; }
  __device__ int stg(int s) const { return slot_tg[s]; }
  __device__ bool sact(int s) const { return slot_active[s] != 0; }
};

// K3's fields: one eval's packed heavy block (ops/place.py pack_heavy:
// feasible, affinity, penalty, tg_count, place_cap [G, N]; spread_vidx
// [G, K, N]; spread_desired, spread_counts [G, K, V1]; has_affinity,
// desired_count [G]; spread_targeted, spread_wfrac, spread_active [G, K])
// and light block (pack_light: demand [S, R], slot_tg, slot_active [S],
// then the deltas).  Integers are value-encoded, booleans > 0.5.
struct K3Src {
  const float* h;
  const float* l;
  size_t GN, GKN, GKV;
  int G, GK, S;
  __device__ bool feas(size_t gi) const { return h[gi] > 0.5f; }
  __device__ float aff(size_t gi) const { return h[GN + gi]; }
  __device__ bool pen(size_t gi) const { return h[2 * GN + gi] > 0.5f; }
  __device__ int tg0(size_t gi) const { return (int)h[3 * GN + gi]; }
  __device__ int cap0(size_t gi) const { return (int)h[4 * GN + gi]; }
  __device__ int vidx(size_t x) const { return (int)h[5 * GN + x]; }
  __device__ float sdes(size_t x) const { return h[5 * GN + GKN + x]; }
  __device__ float counts0(size_t x) const { return h[5 * GN + GKN + GKV + x]; }
  __device__ size_t tail() const { return 5 * GN + GKN + 2 * GKV; }
  __device__ bool has_aff(int g) const { return h[tail() + g] > 0.5f; }
  __device__ int desired(int g) const { return (int)h[tail() + G + g]; }
  __device__ bool targeted(int gk) const { return h[tail() + 2 * G + gk] > 0.5f; }
  __device__ float wfrac(int gk) const { return h[tail() + 2 * G + GK + gk]; }
  __device__ bool active(int gk) const { return h[tail() + 2 * G + 2 * GK + gk] > 0.5f; }
  __device__ float dem(int s, int d) const { return l[s * R + d]; }
  __device__ int stg(int s) const { return (int)l[S * R + s]; }
  __device__ bool sact(int s) const { return l[S * R + S + s] > 0.5f; }
};

// ---------------------------------------------------------------- keys

// score desc, then row asc; +0.0 and -0.0 rank as one score, the low bit
// keeps the sign of a -0.0 for the output.  0 is "no row".
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

// ---------------------------------------------------------------- state

// value indices of the winning row a block hands on with its top-5 (the
// first XV active spreads'); the counts of any further ones read it from
// the field
constexpr int XV = 4;

// One block's slot of the cluster exchange (two, used in turn).
struct Xch {
  u64 key[TOPK];   // the block's top-5
  float fit;       // the fit of its first row
  int n_eval, n_exh;
  int hv[XV];      // its first row's value index of each active spread
};

struct Shared {
  Xch xch[2];
  u64 wk[NW][TOPK];    // the warps' lists
  int wc[NW][2];       // the warps' (n_eval, n_exh)
  int act[MAXK];       // the group's active spreads, in order
  int nact;
  int last_sel;        // the eval's last slot's pick, -1 if none
};

// What one block reads and writes.  The cache (part, fitc, flag) is
// indexed by row - lo; the spread state is the block's copy of the
// eval's counts and desired counts [G, K, V1], the group's boost tables
// [nact, V1], and each spread's weight fraction and flags [G, K].
template <class Src>
struct Scan {
  const float* capacity;
  float* used;
  int* tg_count;      // [G, N], the block's rows
  int* place_cap;     // [G, N], the block's rows
  float* cnt;
  float* des;
  float* tab;
  float* wf;
  int* kfl;           // bit 0 active, bit 1 targeted
  float* part;
  float* fitc;
  uint8_t* flag;
  Src f;
  int G, N, K, V1, spread, lo, hi;
  int nr;             // this thread's rows: lo + t + j * NT, j < nr
  __device__ int row(int j) const { return lo + j * NT + (int)threadIdx.x; }
};

// Row i's partial score for group g and demand dem, with usage `use`,
// co-placements `tg` and budget `cap`: the reference's scoring stack up
// to the spread term, in its order.  Returns the flag byte.
template <class Src>
__device__ __forceinline__ unsigned score_row(const Scan<Src>& c, int g, int i,
                                              const float* use, int tg,
                                              int cap, const float* dem,
                                              bool has_aff, float desired_div,
                                              float* part, float* fitv) {
  const size_t gi = (size_t)g * c.N + i;
  const bool feas = c.f.feas(gi) && cap != 0;
  float cp[R], u[R];
  bool fits = feas;
#pragma unroll
  for (int d = 0; d < R; ++d) {
    cp[d] = c.capacity[(size_t)i * R + d];
    u[d] = use[d] + dem[d];
    fits = fits && (u[d] <= cp[d]);
  }
  const float fit = score_fit(cp, u, c.spread) * (1.0f / 18.0f);
  float total = fit;
  unsigned n = 1;
  const float coll = (float)tg;
  const float anti = -(coll + 1.0f) / desired_div;
  const bool hc = coll > 0.0f;
  total = total + (hc ? anti : 0.0f);
  n += hc ? 1u : 0u;
  const bool pen = c.f.pen(gi);
  total = total - (pen ? 1.0f : 0.0f);
  n += pen ? 1u : 0u;
  const float aff = c.f.aff(gi);
  const bool aff_on = has_aff && (aff != 0.0f);
  total = total + (aff_on ? aff : 0.0f);
  n += aff_on ? 1u : 0u;
  *part = total;
  *fitv = fit;
  return (feas ? F_FEAS : 0u) | (fits ? F_FITS : 0u) | (n << 2);
}

// Warp 0: the active spreads of group g and their boost tables, from the
// block's spread state (the reference's _spread_boost, one entry a
// value).
template <class Src>
__device__ void build_tables(const Scan<Src>& c, Shared& sh, int g) {
  const int lane = threadIdx.x & 31;
  const int V = c.V1 - 1;   // value slot V = "missing attribute"
  int nact = 0;
  for (int k0 = 0; k0 < c.K; k0 += 32) {
    const int k = k0 + lane;
    const bool a = k < c.K && (c.kfl[g * c.K + k] & 1);
    const unsigned m = __ballot_sync(FULL, a);
    if (a) sh.act[nact + __popc(m & ((1u << lane) - 1u))] = k;
    nact += __popc(m);
  }
  if (lane == 0) sh.nact = nact;
  __syncwarp();
  for (int a = 0; a < nact; ++a) {
    const int gk = g * c.K + sh.act[a];
    const float* cn = c.cnt + (size_t)gk * c.V1;
    const float* ds = c.des + (size_t)gk * c.V1;
    // min / max over placed values (> 0): their bits order as the floats
    unsigned mnb = __float_as_uint(BIG), mxb = 0u;
    bool anyp = false;
    for (int v = lane; v < V; v += 32) {
      const float x = cn[v];
      if (x > 0.0f) {
        mnb = min(mnb, __float_as_uint(x));
        mxb = max(mxb, __float_as_uint(x));
        anyp = true;
      }
    }
    mnb = __reduce_min_sync(FULL, mnb);
    mxb = __reduce_max_sync(FULL, mxb);
    anyp = __any_sync(FULL, anyp);
    const float mn = __uint_as_float(mnb);
    const float mx = anyp ? __uint_as_float(mxb) : -BIG;
    const float mn_ = fmaxf(mn, 1e-9f);
    const float wf = c.wf[gk];
    const bool tgt = (c.kfl[gk] & 2) != 0;
    float* tb = c.tab + (size_t)a * c.V1;
    for (int v = lane; v < c.V1; v += 32) {
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
}

// One eval's slot scan.  `used` (f32[N, R]) is the usage carry, updated
// in place; out: f32[S, OUTW].  `p` is the next exchange slot.
template <class Src, bool J>
__device__ void scan_eval(Scan<Src>& c, Shared& sh, cg::cluster_group& cl,
                          int S, float* __restrict__ out, int& p) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cl.block_rank();
  const int V = c.V1 - 1;
  const int GK = c.G * c.K;

  // this eval's tg_count / place_cap on the block's rows, its spread state
  jitter<J>(1);
  for (int j = 0; j < c.nr; ++j) {
    const int i = c.row(j);
    for (int g = 0; g < c.G; ++g) {
      const size_t gi = (size_t)g * c.N + i;
      c.tg_count[gi] = c.f.tg0(gi);
      c.place_cap[gi] = c.f.cap0(gi);
    }
  }
  for (int x = tid; x < GK * c.V1; x += NT) {
    c.cnt[x] = c.f.counts0(x);
    c.des[x] = c.f.sdes(x);
  }
  for (int x = tid; x < GK; x += NT) {
    c.wf[x] = c.f.wfrac(x);
    c.kfl[x] = (c.f.active(x) ? 1 : 0) | (c.f.targeted(x) ? 2 : 0);
  }

  int last_g = -1;          // the cache's group, -1: none yet
  float last_dem[R] = {0.0f, 0.0f, 0.0f, 0.0f};
  int prev = -1;            // the previous slot's pick (warp 0), -1: none
  // each slot's fields are read a step ahead
  bool n_act = false, n_aff = false;
  int n_g = 0;
  float n_dem[R] = {0.0f, 0.0f, 0.0f, 0.0f}, n_div = 1.0f;
  auto ahead = [&](int s) {
    n_act = c.f.sact(s);
    if (n_act) {
      n_g = c.f.stg(s);
#pragma unroll
      for (int d = 0; d < R; ++d) n_dem[d] = c.f.dem(s, d);
      n_aff = c.f.has_aff(n_g);
      n_div = fmaxf((float)c.f.desired(n_g), 1.0f);
    }
  };
  if (S > 0) ahead(0);
  for (int s = 0; s < S; ++s) {
    float* o = out + (size_t)s * OUTW;
    const bool act = n_act, has_aff = n_aff;
    const int g = n_g;
    const float desired_div = n_div;
    float dem[R];
#pragma unroll
    for (int d = 0; d < R; ++d) dem[d] = n_dem[d];
    if (s + 1 < S) ahead(s + 1);
    if (!act) {
      // nothing fits an inactive slot: every row scores -inf
      if (rank == 0 && tid == 0) {
        o[0] = -1.0f; o[1] = 0.0f; o[2] = 0.0f; o[3] = 0.0f; o[4] = 0.0f;
        for (int k = 0; k < TOPK; ++k) {
          o[5 + k] = (float)k;
          o[5 + TOPK + k] = -INFINITY;
        }
      }
      prev = -1;
      continue;
    }
    bool changed = g != last_g;
#pragma unroll
    for (int d = 0; d < R; ++d)
      changed = changed || __float_as_uint(dem[d]) != __float_as_uint(last_dem[d]);
    if (changed) {
      // every row, after the last carry update and the eval's set-up
      __syncthreads();
      jitter<J>(2);
      for (int j = 0; j < c.nr; ++j) {
        const int i = c.row(j);
        const size_t gi = (size_t)g * c.N + i;
        float use[R];
#pragma unroll
        for (int d = 0; d < R; ++d) use[d] = c.used[(size_t)i * R + d];
        const int li = i - c.lo;
        c.flag[li] = (uint8_t)score_row(c, g, i, use, c.tg_count[gi],
                                        c.place_cap[gi], dem, has_aff,
                                        desired_div, &c.part[li],
                                        &c.fitc[li]);
      }
      last_g = g;
#pragma unroll
      for (int d = 0; d < R; ++d) last_dem[d] = dem[d];
    }
    if (warp == 0) {
      jitter<J>(3);
      build_tables(c, sh, g);
    }
    __syncthreads();
    jitter<J>(4);

    // -- the row pass: each row's score from its cache and the tables
    const int nact = sh.nact;
    Top top;
    top_clear(top);
    int ne = 0, nx = 0;
    // in chunks of RCH rows, the first spread's value indices loaded
    // together
    const size_t vx0 = nact > 0 ? (size_t)(g * c.K + sh.act[0]) * c.N : 0;
    for (int j0 = 0; j0 < c.nr; j0 += RCH) {
      int v0[RCH];
#pragma unroll
      for (int u = 0; u < RCH; ++u)
        v0[u] = (nact > 0 && j0 + u < c.nr) ? c.f.vidx(vx0 + c.row(j0 + u)) : 0;
#pragma unroll
      for (int u = 0; u < RCH; ++u) {
        if (j0 + u >= c.nr) break;
        const int i = c.row(j0 + u);
        const int li = i - c.lo;
        const unsigned fl = c.flag[li];
        float sb = 0.0f;
        if (nact > 0) sb = sb + c.tab[min(v0[u], V)];
        for (int a = 1; a < nact; ++a) {
          const int v = c.f.vidx((size_t)(g * c.K + sh.act[a]) * c.N + i);
          sb = sb + c.tab[(size_t)a * c.V1 + min(v, V)];
        }
        const bool sb_on = sb != 0.0f;
        const float total = c.part[li] + (sb_on ? sb : 0.0f);
        const float n = (float)((fl >> 2) + (sb_on ? 1u : 0u));
        const float masked = (fl & F_FITS) ? total / n : -INFINITY;
        top_push(top, make_key(masked, i));
        ne += (fl & F_FEAS) ? 1 : 0;
        nx += (fl & (F_FEAS | F_FITS)) == F_FEAS ? 1 : 0;
      }
    }
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

    // -- the block's top-5 into its exchange slot; then, while the other
    // blocks arrive, its first row's state should this slot pick it
    int head = -1;
    float sp_use[R], sp_part = 0.0f, sp_fit = 0.0f;
    int sp_tg = 0, sp_cap = 0;
    unsigned sp_flag = 0u;
    if (warp == 0) {
      jitter<J>(6);
      Top t, bt;
#pragma unroll
      for (int k = 0; k < TOPK; ++k) t.k[k] = sh.wk[lane][k];
      const int bne = __reduce_add_sync(FULL, sh.wc[lane][0]);
      const int bnx = __reduce_add_sync(FULL, sh.wc[lane][1]);
      warp_top(t, bt, &first);
      head = bt.k[0] ? key_row(bt.k[0]) : -1;
      jitter<J>(7);
      if (lane == 0) {
        Xch& x = sh.xch[p];
#pragma unroll
        for (int k = 0; k < TOPK; ++k) x.key[k] = bt.k[k];
        x.fit = head >= 0 ? c.fitc[head - c.lo] : 0.0f;
        x.n_eval = bne;
        x.n_exh = bnx;
#pragma unroll
        for (int a = 0; a < XV; ++a)
          x.hv[a] = (head >= 0 && a < nact)
              ? c.f.vidx((size_t)(g * c.K + sh.act[a]) * c.N + head) : 0;
      }
    }
    cluster_arrive();
    if (warp == 0 && lane == 0 && head >= 0) {
      // the reference's `used + onehot * d` at the row (the 0 it added
      // there last slot first, unless the row was that slot's pick)
      const bool canon = s > 0 && prev != head;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        float b = c.used[(size_t)head * R + d];
        if (canon) b = b + 0.0f;
        sp_use[d] = b + dem[d];
      }
      const size_t gh = (size_t)g * c.N + head;
      sp_tg = c.tg_count[gh] + 1;
      sp_cap = c.place_cap[gh];
      if (sp_cap > 0) sp_cap -= 1;
      sp_flag = score_row(c, g, head, sp_use, sp_tg, sp_cap, dem, has_aff,
                          desired_div, &sp_part, &sp_fit);
    }
    cluster_wait();

    // -- the cluster's top-5 and counts (every block), then the carry
    if (warp == 0) {
      jitter<J>(8);
      Top t, ct;
      float hf = 0.0f;
      int cne = 0, cnx = 0;
      int hv[XV] = {0, 0, 0, 0};
      top_clear(t);
      if (lane < CLUSTER) {
        const Xch* rx = cl.map_shared_rank(&sh.xch[p], lane);
#pragma unroll
        for (int k = 0; k < TOPK; ++k) t.k[k] = rx->key[k];
        hf = rx->fit;
        cne = rx->n_eval;
        cnx = rx->n_exh;
#pragma unroll
        for (int a = 0; a < XV; ++a) hv[a] = rx->hv[a];
      }
      cne = __reduce_add_sync(FULL, cne);
      cnx = __reduce_add_sync(FULL, cnx);
      warp_top(t, ct, &first);
      const float fit_sel = __shfl_sync(FULL, hf, first);
      const int sel = key_row(ct.k[0]);
      const float best = key_val(ct.k[0]);
      const bool ok = best > -INFINITY;
      if (rank == 0 && lane == 0) {
        o[0] = ok ? (float)sel : -1.0f;
        o[1] = ok ? best : 0.0f;
        o[2] = ok ? fit_sel : 0.0f;
        o[3] = (float)cne;
        o[4] = (float)cnx;
#pragma unroll
        for (int k = 0; k < TOPK; ++k) {
          o[5 + k] = (float)key_row(ct.k[k]);
          o[5 + TOPK + k] = key_val(ct.k[k]);
        }
      }
      if (ok) {
        jitter<J>(9);
        // every block's counts: the picked row's value of each active
        // spread (from its block's slot, past XV from the field)
#pragma unroll
        for (int a = 0; a < XV; ++a) {
          const int v = __shfl_sync(FULL, hv[a], first);
          if (lane == 0 && a < nact && v < V)
            c.cnt[(size_t)(g * c.K + sh.act[a]) * c.V1 + v] += 1.0f;
        }
        for (int a = XV + lane; a < nact; a += 32) {
          const int gk = g * c.K + sh.act[a];
          const int v = c.f.vidx((size_t)gk * c.N + sel);
          if (v < V) c.cnt[(size_t)gk * c.V1 + v] += 1.0f;
        }
        if (lane == 0 && sel == head) {
          // the owner: the row's new state, as computed above
          const int li = sel - c.lo;
#pragma unroll
          for (int d = 0; d < R; ++d) c.used[(size_t)sel * R + d] = sp_use[d];
          const size_t gs = (size_t)g * c.N + sel;
          c.tg_count[gs] = sp_tg;
          c.place_cap[gs] = sp_cap;
          c.part[li] = sp_part;
          c.fitc[li] = sp_fit;
          c.flag[li] = (uint8_t)sp_flag;
        }
        __syncwarp();
      }
      prev = ok ? sel : -1;
    }
    p ^= 1;
  }
  // the reference's last `+ 0` on every row but the last slot's pick
  if (tid == 0) sh.last_sel = prev;
  __syncthreads();
  jitter<J>(10);
  const int keep = S > 0 ? sh.last_sel : -2;
  if (keep != -2) {
    for (int j = 0; j < c.nr; ++j) {
      const int i = c.row(j);
      if (i == keep) continue;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        const float v = c.used[(size_t)i * R + d];
        const float w = v + 0.0f;
        if (__float_as_uint(w) != __float_as_uint(v)) {
          jitter<J>(11);    // between the read and the write
          c.used[(size_t)i * R + d] = w;
        }
      }
    }
  }
  __syncthreads();
}

// The block's rows, its cache and spread state (shared memory, or the
// global scratch past the limits).
template <class Src>
__device__ void setup(Scan<Src>& c, int rank, int rows_smem, int spread_smem,
                      float* spread_g, float* rows_g, unsigned char* dsm) {
  const int rb = (c.N + CLUSTER - 1) / CLUSTER;
  const int tid = threadIdx.x;
  c.lo = min(c.N, rank * rb);
  c.hi = min(c.N, c.lo + rb);
  const int len = c.hi - c.lo;
  c.nr = len > tid ? (len - tid + NT - 1) / NT : 0;
  size_t off = 0;
  if (rows_smem) {
    c.part = (float*)dsm;
    c.fitc = c.part + rb;
    c.flag = (uint8_t*)(c.fitc + rb);
    off = ((size_t)rb * ROW_BYTES + 15) & ~(size_t)15;
  } else {
    c.part = rows_g + c.lo;
    c.fitc = rows_g + c.N + c.lo;
    c.flag = (uint8_t*)(rows_g + 2 * (size_t)c.N) + c.lo;
  }
  const size_t gkv = (size_t)c.G * c.K * c.V1;
  c.cnt = spread_smem ? (float*)(dsm + off)
                      : spread_g + rank * spread_floats(c.G, c.K, c.V1);
  c.des = c.cnt + gkv;
  c.tab = c.des + gkv;
  c.wf = c.tab + (size_t)c.K * c.V1;
  c.kfl = (int*)(c.wf + (size_t)c.G * c.K);
}

template <bool J>
__global__ void __launch_bounds__(NT, 1)
place_scan_kernel(const float* __restrict__ capacity,
                  const float* __restrict__ used0, K2Src src, int G, int N,
                  int K, int V1, int S, int spread_alg, int rows_smem,
                  int spread_smem, float* __restrict__ out, float* used,
                  int* tg_count, int* place_cap, float* spread_g,
                  float* rows_g) {
  extern __shared__ float4 dsm4[];
  __shared__ Shared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  Scan<K2Src> c;
  c.capacity = capacity;
  c.used = used;
  c.tg_count = tg_count;
  c.place_cap = place_cap;
  c.f = src;
  c.G = G; c.N = N; c.K = K; c.V1 = V1; c.spread = spread_alg;
  setup(c, rank, rows_smem, spread_smem, spread_g, rows_g,
        (unsigned char*)dsm4);
  jitter<J>(12);
  for (int j = 0; j < c.nr; ++j) {
    const int i = c.row(j);
#pragma unroll
    for (int d = 0; d < R; ++d) used[(size_t)i * R + d] = used0[(size_t)i * R + d];
  }
  int p = 0;
  scan_eval<K2Src, J>(c, sh, cl, S, out, p);
  jitter<J>(13);
  cl.sync();    // no block exits while another reads its shared memory
}

// K3: E chained evals.  heavy f32[E, Lh], dyn f32[E * Ll]; `used` is the
// usage carry (starts as used0, ends as the chain's final usage).
template <bool J>
__global__ void __launch_bounds__(NT, 1)
place_batch_kernel(const float* __restrict__ capacity,
                   const float* __restrict__ used0,
                   const float* __restrict__ heavy,
                   const float* __restrict__ dyn, int E, int G, int N, int K,
                   int V1, int S, int D, int spread_alg, int rows_smem,
                   int spread_smem, float* __restrict__ out, float* used,
                   int* tg_count, int* place_cap, float* spread_g,
                   float* rows_g) {
  extern __shared__ float4 dsm4[];
  __shared__ Shared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const size_t GN = (size_t)G * N, GKN = (size_t)G * K * N,
               GKV = (size_t)G * K * V1;
  const size_t Lh = 5 * GN + GKN + 2 * GKV + 2 * (size_t)G + 3 * (size_t)G * K;
  const size_t Ll = (size_t)S * (R + 2) + (size_t)D * (R + 1);
  Scan<K3Src> c;
  c.capacity = capacity;
  c.used = used;
  c.tg_count = tg_count;
  c.place_cap = place_cap;
  c.G = G; c.N = N; c.K = K; c.V1 = V1; c.spread = spread_alg;
  setup(c, rank, rows_smem, spread_smem, spread_g, rows_g,
        (unsigned char*)dsm4);
  jitter<J>(14);
  for (int j = 0; j < c.nr; ++j) {
    const int i = c.row(j);
#pragma unroll
    for (int d = 0; d < R; ++d) used[(size_t)i * R + d] = used0[(size_t)i * R + d];
  }
  __syncthreads();
  int p = 0;
  for (int e = 0; e < E; ++e) {
    const float* l = dyn + e * Ll;
    // this eval's deltas go into the carry, and stay there: a row's
    // deltas in list order, added by the thread of its first (the block
    // barrier before the eval's first rescore, or before its last + 0,
    // orders them before any other thread reads the row)
    const float* rows = l + (size_t)S * (R + 2);
    const float* vals = rows + D;
    jitter<J>(15);
    for (int k = tid; k < D; k += NT) {
      const int r = wrap_delta_row(rows[k], c.N);
      if (r < c.lo || r >= c.hi) continue;
      bool first = true;
      for (int j = 0; j < k && first; ++j)
        first = wrap_delta_row(rows[j], c.N) != r;
      if (!first) continue;
      for (int j = k; j < D; ++j) {
        if (wrap_delta_row(rows[j], c.N) != r) continue;
#pragma unroll
        for (int d = 0; d < R; ++d)
          used[(size_t)r * R + d] = used[(size_t)r * R + d] + vals[j * R + d];
      }
    }
    c.f = K3Src{heavy + e * Lh, l, GN, GKN, GKV, G, G * K, S};
    scan_eval<K3Src, J>(c, sh, cl, S, out + (size_t)e * S * OUTW, p);
  }
  jitter<J>(16);
  cl.sync();    // no block exits while another reads its shared memory
}

// dynamic shared memory of a launch: the row cache where a block's rows
// fit SMEM_ROWS, then the spread state where it fits SMEM_SPREAD floats
void smem_plan(int G, int N, int K, int V1, int* rows_smem, int* spread_smem,
               size_t* bytes) {
  const int rb = (N + CLUSTER - 1) / CLUSTER;
  const size_t ns = spread_floats(G, K, V1);
  *rows_smem = rb <= SMEM_ROWS;
  *spread_smem = ns <= (size_t)SMEM_SPREAD;
  *bytes = (*rows_smem ? (((size_t)rb * ROW_BYTES + 15) & ~(size_t)15) : 0) +
           (*spread_smem ? ns * 4 : 0);
}

}  // namespace

extern "C" int place_scan_cluster_size() { return CLUSTER; }

// The delays' seed for the K2/K3 launches that follow on `stream`
// (cluster.cuh set_jitter; 0: the kernels without the delay sites).
extern "C" int place_scan_set_jitter(int seed, void* stream) {
  return (int)set_jitter(seed, (cudaStream_t)stream);
}

// spread_g: f32[CLUSTER, (2G + 1) * K * V1 + 2 * G * K], rows_g:
// f32[3, N] (the scratch where shared memory does not hold them)
extern "C" int place_scan_launch(
    const float* capacity, const float* used0, const uint8_t* feasible,
    const float* affinity, const uint8_t* has_affinity,
    const int* desired_count, const uint8_t* penalty, const int* tg_count0,
    const int* spread_vidx, const float* spread_desired,
    const uint8_t* spread_targeted, const float* spread_wfrac,
    const float* spread_counts0, const uint8_t* spread_active,
    const int* place_cap0, const float* demand, const int* slot_tg,
    const uint8_t* slot_active, int G, int N, int K, int V1, int S,
    int spread_alg, float* out, float* used, int* tg_count, int* place_cap,
    float* spread_g, float* rows_g, void* stream) {
  if (K < 1 || K > MAXK || N < TOPK || V1 < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  const K2Src src{feasible, affinity, has_affinity, desired_count, penalty,
                  tg_count0, spread_vidx, spread_desired, spread_targeted,
                  spread_wfrac, spread_counts0, spread_active, place_cap0,
                  demand, slot_tg, slot_active};
  int rs, ss;
  size_t smem;
  smem_plan(G, N, K, V1, &rs, &ss, &smem);
  return (int)cluster_launch(
      jitter_on ? &place_scan_kernel<true> : &place_scan_kernel<false>,
      CLUSTER, NT, SMEM_MAX, smem, (cudaStream_t)stream, capacity, used0,
      src, G, N, K, V1, S, spread_alg, rs, ss, out, used, tg_count,
      place_cap, spread_g, rows_g);
}

extern "C" int place_batch_launch(const float* capacity, const float* used0,
                                  const float* heavy, const float* dyn, int E,
                                  int G, int N, int K, int V1, int S, int D,
                                  int spread_alg, float* out, float* used,
                                  int* tg_count, int* place_cap,
                                  float* spread_g, float* rows_g,
                                  void* stream) {
  if (K < 1 || K > MAXK || N < TOPK || V1 < 1 || E < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  int rs, ss;
  size_t smem;
  smem_plan(G, N, K, V1, &rs, &ss, &smem);
  return (int)cluster_launch(
      jitter_on ? &place_batch_kernel<true> : &place_batch_kernel<false>,
      CLUSTER, NT, SMEM_MAX, smem, (cudaStream_t)stream, capacity, used0,
      heavy, dyn, E, G, N, K, V1, S, D, spread_alg, rs, ss, out, used,
      tg_count, place_cap, spread_g, rows_g);
}
