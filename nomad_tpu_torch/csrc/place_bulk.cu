// place_bulk.cu — bulk wavefront placement of `count` identical slots of
// one task group (K1), and the chained batch of such evals (K4), for
// Hopper (sm_90a).
//
// Replaces: nomad_tpu/ops/place.py `place_bulk_jit` (K1, with
// `_bulk_loop`, `bulk_wave_grid`, `bulk_run_lengths`, `_bulk_scores`,
// `_bulk_tail` and ops/fit.py `score_fit`/`free_fractions`) and
// `_place_bulk_batch` (K4; jitted as `place_bulk_batch_jit` and, with the
// usage basis donated, `place_bulk_batch_donate_jit`).  The plain PyTorch
// versions are nomad_tpu_torch/ops/place.py `place_bulk_plain` and
// `place_bulk_batch_plain`; both agree with them bit for bit on every
// output.
//
// What bounds it on this card: not bytes (one wave reads ~44 bytes a
// row, ~0.7 MB at 16K rows, a fraction of a microsecond at 3.35 TB/s)
// but latency.  The loop over waves is sequential with a data-dependent
// trip count, every wave is a few dependent steps (the wave's top-2
// score and s*, the selection of the rows that take instances, the
// cumulative cap), and K4 chains E evals, each of which must see the
// placements of the one before it.
//
// Design: ONE thread-block cluster of CLUSTER blocks x 1024 threads runs
// every wave and, for K4, every eval of the chain inside one launch (no
// per-wave launch, no host round trip).  Block b owns a contiguous range
// of rows and thread t of it a contiguous slice of that range; every
// per-row pass (the m = 1 / m = 2 scores, the tail, the outputs) runs on
// the owners, and every per-row state (used, instances taken) is written
// by its owner block only; a row's co-placements are its field's value
// plus the instances it took.  Block results meet in distributed shared
// memory: each block writes its partial into its own exchange slot,
// `barrier.cluster` (cg::cluster_group::sync), then every warp reads the
// CLUSTER slots and reduces them the same way, so each block holds the
// same cluster-wide results.  All of them are exact (top-2, max and the
// rows at it, integer sums and prefix counts), so the outputs do not
// depend on the split.  CLUSTER is 8, the portable size: measured
// against 16 (which needs cudaFuncAttributeNonPortableClusterSizeAllowed)
// on the H100, 8 is faster at 16,384 rows (fewer blocks meet at each
// barrier) and 16 at 131,072 (fewer rows a thread).
//
// A wave places at most `remaining` instances and every wave row takes
// at least one (m = 1 always passes for a fitting row), so only the
// first k = min(remaining, |wave|) rows of the greedy order (score desc,
// row asc) can take instances.  The kernel selects them instead of
// sorting the wave.  The row pass's one reduction carries the rows at
// the top score with their row-order offsets, so:
//  - when k rows share the top score (a tie wave always), the selection
//    is the first k of them in row order;
//  - otherwise a radix select over the 32-bit orderable score, with
//    256-bin histograms summed across the cluster, finds the threshold
//    score below which fewer than k rows lie; the rows above it and the
//    first rows at it in row order are taken, and only those keys are
//    sorted (in shared memory).
// Rounds of at most KMAX keys bound the shared memory for any count and
// any N.  Only the selected rows compute their run (up to
// min(fill_grid, remaining) grid cells); their keys (orderable(-cur) <<
// 32 | row << 8 | run) go to the leader block's shared memory, every
// block reads them back, takes the cumulative cap in order and applies
// the instances of its own rows.  After the waves, a row that took
// nothing keeps the score the last row pass gave it, so the tail scores
// only the rows that took instances.  The key holds a row in 24 bits, so
// N <= 2^24.
//
// K4 per eval: read the light block (has_aff, desired, count, demand,
// D delta rows and values) and the heavy row f32[4N] (feasible > 0.5,
// affinity, penalty > 0.5, coll0 value-encoded); the owner of each
// delta row (a row in [-n, 0) taken as row + n, as JAX indexes; other
// rows outside [0, n) dropped) adds that row's deltas (summed in their
// order from 0.0, as the reference builds its delta matrix) to the
// chain carry and backs them out after the eval's tail, so deltas stay
// scoped to their eval.
// Rows without a delta see `used + 0.0` in the reference (a -0.0 usage
// becomes +0.0): the passes that read every row anyway (the wave's row
// pass, or the tail of an eval without a wave) write that back where it
// changes a bit, so restricting the delta add and back-out to the
// touched rows stays bit-equal.  With exact_out the tail adds
// f32(assign) * demand into the exact carry (the donated usage basis,
// updated in place) on the rows that took instances; the reference adds
// it on every row, where 0 * demand turns a -0.0 (or a NaN) into
// something else, so a block whose exact carry held one at the launch
// adds it on every row.
// Outputs: dense [2N+4], or sparse [3*SPARSE_CAP+4] with the first
// SPARSE_CAP assigned rows in row order from a cluster prefix count.
//
// Checking the barriers: place_bulk_set_jitter(seed) turns on the random
// delays of cluster.cuh at each `jitter` site (chip_smoke.py and the
// `cuda` tests rerun the selection cases under several seeds).
//
// Numerics: compiled without fast math and with -fmad=false; powf (not
// __powf); operations in the reference's order (fit/18,
// -(coll+1)/max(desired,1), total/n_scorers), so each row's scores are
// the plain version's bit for bit.  fit/18 is a multiply by the f32
// reciprocal 1.0f/18.0f, which is what XLA compiles the reference's
// division by that constant into.  The wave's top-2 ranks in lax.top_k's
// total order (orderable keys: a NaN by its sign, the card's +NaN above
// +inf, so a fitting row that scores NaN leaves the tie set empty), and
// s* is NaN where a fitting m = 2 score is, as jnp.max propagates it.

#include <cooperative_groups.h>

#include "bulk_common.cuh"
#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = 4;              // resource dims (cpu, mem, disk, net)
constexpr int W = R + 3;          // K1's packed output width
constexpr int SPARSE_CAP = 128;   // ops/place.py SPARSE_CAP
constexpr int CLUSTER = 8;        // blocks of the cluster (8: portable)
constexpr int KMAX = 2048;        // keys one selection round takes
constexpr int CUR_SLOTS = 16;     // rows a thread keeps in shared memory
constexpr unsigned FULL = 0xffffffffu;
static_assert(R == NRES, "one row's resource dims");
static_assert(NW == 32, "one warp reads the block's warp records");
static_assert(CLUSTER <= 32, "one warp reads the cluster's slots");

using Row = BulkRow;

// A row's score slot holds its wave-start score where it fits, else
// NOFIT: a fitting row may score -inf (an affinity of -inf), and the tie
// set at a top score of -inf holds the fitting rows only.  NOFIT is a NaN
// that the card's arithmetic never gives (its NaN results are
// 0x7fffffff), so every comparison with it is false and no wave takes
// the row; the tail reads it as -inf and as a row that did not fit.
constexpr unsigned NOFIT_BITS = 0xffc00001u;
__device__ __forceinline__ float nofit() {
  return __uint_as_float(NOFIT_BITS);
}
__device__ __forceinline__ bool is_nofit(float v) {
  return __float_as_uint(v) == NOFIT_BITS;
}

// K1's node fields, as the wrapper passes them
struct K1Fields {
  const uint8_t* feas;
  const uint8_t* pen;
  const float* aff;
  const int* coll0;
  __device__ bool feasible(int i) const { return feas[i] != 0; }
  __device__ bool penalty(int i) const { return pen[i] != 0; }
  __device__ float affinity(int i) const { return aff[i]; }
  __device__ int coll(int i) const { return coll0[i]; }
};

// K4's node fields: one eval's packed heavy row f32[4N]
// (ops/place.py pack_bulk_heavy), booleans as > 0.5, coll0 value-encoded
struct K4Fields {
  const float* h;
  int n;
  __device__ bool feasible(int i) const { return h[i] > 0.5f; }
  __device__ float affinity(int i) const { return h[n + i]; }
  __device__ bool penalty(int i) const { return h[2 * n + i] > 0.5f; }
  __device__ int coll(int i) const { return (int)h[3 * n + i]; }
};

// One block's slot of a cluster exchange (two, used in turn: a slot is
// written again only after the next exchange's barrier, by which time
// every block has read it).
struct Xch {
  float a, smax;      // the block's best cur and m = 2 score (not NaN)
  unsigned ka, kb;    // the block's top-2 keys of cur (lax.top_k's order)
  int v[4];           // counts of one exchange
  unsigned hist[256];
};

// (a, c) = (max, count of it) merged with (ya, yc)
__device__ __forceinline__ void maxcount(float& a, int& c, float ya, int yc) {
  if (ya > a) { a = ya; c = yc; } else if (ya == a) { c += yc; }
}

// A warp's partial of the row pass: (max, rows at it) scanned, the
// top-2 keys, the best m = 2 score and whether one is NaN, fitting rows.
struct WarpRec {
  float a, smax;
  unsigned ka, kb;
  int c, fit, snan;
};

struct Shared {
  Xch xch[2];
  WarpRec rec[2][NW];
  int4 scan[2][NW];
  int pick_bin, pick_below;
};

// Dynamic shared memory: the leader's key buffer, a block's working keys
// (aliased by its selection list before the gather), the list's
// positions, and where a thread's slice fits CUR_SLOTS rows, the
// block's wave-start scores and instances taken.
constexpr size_t SMEM_KEYS = (size_t)KMAX * (8 + 8 + 4);
constexpr size_t SMEM_MAX = SMEM_KEYS + (size_t)CUR_SLOTS * NT * 8;

__device__ __forceinline__ int warp_incl_sum(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sums of four ints over the block's threads (in thread
// order) and their totals; one barrier.  `buf` is used in turn with the
// other one, which the callers rotate with `sp`.
template <bool J>
__device__ void block_scan4(int4 v, int4* buf, int4* ex, int4* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4 x = make_int4(warp_incl_sum(v.x, lane), warp_incl_sum(v.y, lane),
                     warp_incl_sum(v.z, lane), warp_incl_sum(v.w, lane));
  jitter<J>(1);
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  jitter<J>(2);
  const int4 w = buf[lane];
  const int4 wi = make_int4(warp_incl_sum(w.x, lane), warp_incl_sum(w.y, lane),
                            warp_incl_sum(w.z, lane), warp_incl_sum(w.w, lane));
  const int src = (warp + 31) & 31;
  int4 wp = make_int4(__shfl_sync(FULL, wi.x, src), __shfl_sync(FULL, wi.y, src),
                      __shfl_sync(FULL, wi.z, src), __shfl_sync(FULL, wi.w, src));
  if (warp == 0) wp = make_int4(0, 0, 0, 0);
  *tot = make_int4(__shfl_sync(FULL, wi.x, 31), __shfl_sync(FULL, wi.y, 31),
                   __shfl_sync(FULL, wi.z, 31), __shfl_sync(FULL, wi.w, 31));
  *ex = make_int4(wp.x + x.x - v.x, wp.y + x.y - v.y, wp.z + x.z - v.z,
                  wp.w + x.w - v.w);
}

// The cluster's sums of four ints a block published in slot `x`, and the
// sums over the blocks ranked before this one.
template <bool J>
__device__ void cluster_sums(cg::cluster_group& cl, Xch* x, int4* tot,
                             int4* before) {
  const int lane = threadIdx.x & 31;
  const int rank = (int)cl.block_rank();
  int4 v = make_int4(0, 0, 0, 0);
  jitter<J>(3);
  if (lane < CLUSTER) {
    const Xch* rx = cl.map_shared_rank(x, lane);
    v = make_int4(rx->v[0], rx->v[1], rx->v[2], rx->v[3]);
  }
  const bool early = lane < rank;
  *tot = make_int4(warp_sum(v.x), warp_sum(v.y), warp_sum(v.z), warp_sum(v.w));
  *before = make_int4(warp_sum(early ? v.x : 0), warp_sum(early ? v.y : 0),
                      warp_sum(early ? v.z : 0), warp_sum(early ? v.w : 0));
}

// the score a key's high word encodes (+0.0 and -0.0 both read as -0.0,
// which compares equal to either)
__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned o = (unsigned)(key >> 32);
  const unsigned u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return -__uint_as_float(u);
}

__device__ __forceinline__ unsigned score_word(float cur) {
  return orderable(-cur + 0.0f);
}

__device__ __forceinline__ unsigned long long key_of(unsigned word, int row) {
  return ((unsigned long long)word << 32) | ((unsigned long long)row << 8);
}

// Everything one eval's wavefront reads and writes.  Rows [lo, hi) are
// this block's; thread t's slice is [lo + t*rpt, lo + (t+1)*rpt), and
// its i-th row's wave-start score (or NOFIT) and instances taken sit at
// slot i*cs_i + t*cs_t of cur / asg.  A row's co-placements are its
// field's value plus the instances it took.
template <class F, bool J>
struct Ctx {
  const float* capacity;
  float* used;          // row stride us
  int us;
  F fl;
  float* cur;
  int* asg;
  int cs_i, cs_t;
  bool has_aff;
  float desired_div;
  float dem[R];
  float canon[R];       // added to every usage value the row pass reads
  int spread, lo, hi, rpt;
  unsigned long long* gat;   // this block's key buffer (the leader's is read)
  unsigned long long* wk;    // working keys / selection list
  int* sel_pos;
  Shared* sm;
  int sp, xp;                // rotating scan buffer / exchange slot
  int n_feas, n_nofit;       // this thread's, at the last row pass
  __device__ int slot(int i) const { return i * cs_i + threadIdx.x * cs_t; }
  __device__ int slot_of_row(int row) const {
    const int li = row - lo, t = li / rpt;
    return (li - t * rpt) * cs_i + t * cs_t;
  }
  __device__ int slice_lo() const { return min(hi, lo + (int)threadIdx.x * rpt); }
  __device__ int slice_hi() const { return min(hi, slice_lo() + rpt); }
};

template <class F, bool J>
__device__ __forceinline__ void load_row(const Ctx<F, J>& c, Row& r, int i,
                                         int taken) {
#pragma unroll
  for (int d = 0; d < R; ++d) {
    r.cap[d] = c.capacity[i * R + d];
    r.used[d] = c.used[(size_t)i * c.us + d];
  }
  r.coll = (float)(c.fl.coll(i) + taken);
  r.feas = c.fl.feasible(i);
  r.pen = c.fl.penalty(i);
  r.aff = c.fl.affinity(i);
  r.aff_on = c.has_aff && (r.aff != 0.0f);
}

// Adds z[d] to row i's usage where that changes a bit (the reference's
// `used + 0.0` or `used + 0 * demand` on rows that take nothing: -0.0
// becomes +0.0, every other value stays).
template <class F, bool J>
__device__ __forceinline__ void canonicalize(Ctx<F, J>& c, Row& r, int i,
                                             const float* z) {
#pragma unroll
  for (int d = 0; d < R; ++d) {
    const float v = r.used[d] + z[d];
    if (__float_as_uint(v) != __float_as_uint(r.used[d])) {
      r.used[d] = v;
      c.used[(size_t)i * c.us + d] = v;
    }
  }
}

// The wave's top-2 scores (lax.top_k's total order, where a NaN ranks by
// its sign; duplicates count), s* (NaN where a fitting m = 2 score is
// NaN, as jnp.max gives it), the largest cur that is not NaN (cmax: some
// row beats s* where it does), fitting rows, and the rows at top1: in
// the cluster (n_top), in the blocks ranked before this one (top_off), in
// this block's slices before this thread's (top_pre), in this thread's
// slice (top_mine) and in this block (top_blk).  A NaN top1 has no row
// at it: the tie set is empty.
struct WaveStats {
  float top1, top2, s_star, cmax;
  int any_fit;
  int n_top, top_off, top_pre, top_mine, top_blk;
};

// The wave's row pass: every row's m = 1 score (cur, -inf where it no
// longer fits; its slot NOFIT) and m = 2 score, then the cluster's top-2,
// s*, fitting rows and the fitting rows at the top score with their
// row-order offsets.
template <class F, bool J>
__device__ void row_pass(Ctx<F, J>& c, cg::cluster_group& cl,
                         WaveStats& ws) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned ka = 0u, kb = 0u;
  float smax = -INFINITY;
  float ma = -INFINITY;
  int mc = 0, fit = 0, snan = 0, nf = 0, nx = 0;
  const int r0 = c.slice_lo(), r1 = c.slice_hi();
  jitter<J>(4);
  for (int row = r0, i = 0; row < r1; ++row, ++i) {
    Row r;
    load_row(c, r, row, c.asg[c.slot(i)]);
    canonicalize(c, r, row, c.canon);
    bool f1, f2;
    float s1, s2;
    grid_cell(r, c.dem, 1.0f, c.desired_div, c.spread, &f1, &s1);
    grid_cell(r, c.dem, 2.0f, c.desired_div, c.spread, &f2, &s2);
    const float cur = f1 ? s1 : -INFINITY;
    c.cur[c.slot(i)] = f1 ? s1 : nofit();
    key_top2_push(ka, kb, orderable(cur));
    maxcount(ma, mc, cur, f1 ? 1 : 0);  // passes over a NaN
    if (f2) {
      if (isnan(s2)) snan = 1;
      else smax = fmaxf(smax, s2);
    }
    fit |= f1 ? 1 : 0;
    nf += r.feas ? 1 : 0;
    nx += (r.feas && !f1) ? 1 : 0;
  }
  c.n_feas = nf;
  c.n_nofit = nx;
  // block: (max, count) scanned in thread order; top-2, s*, fits reduced
  const float ta = ma;
  const int tc = mc;
  float sa = ma;
  int sc = mc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ya = __shfl_up_sync(FULL, sa, o);
    const int yc = __shfl_up_sync(FULL, sc, o);
    if (lane >= o) maxcount(sa, sc, ya, yc);
  }
  warp_key_top2(ka, kb);
  smax = warp_max(smax);
  fit = warp_sum(fit);
  snan = __any_sync(FULL, snan != 0) ? 1 : 0;
  WarpRec* rec = c.sm->rec[c.sp];
  c.sp ^= 1;
  jitter<J>(5);
  if (lane == 31) rec[warp] = WarpRec{sa, smax, ka, kb, sc, fit, snan};
  __syncthreads();
  jitter<J>(6);
  const WarpRec w = rec[lane];
  unsigned wka = w.ka, wkb = w.kb;
  warp_key_top2(wka, wkb);
  const float blk_smax = warp_max(w.smax);
  const int blk_fit = warp_sum(w.fit);
  const int blk_snan = __any_sync(FULL, w.snan != 0) ? 1 : 0;
  float ia = w.a;
  int ic = w.c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ya = __shfl_up_sync(FULL, ia, o);
    const int yc = __shfl_up_sync(FULL, ic, o);
    if (lane >= o) maxcount(ia, ic, ya, yc);
  }
  const float blk_a = __shfl_sync(FULL, ia, 31);
  const int blk_c = __shfl_sync(FULL, ic, 31);
  // this thread's exclusive prefix: the warps before, then the lanes before
  float pa = __shfl_sync(FULL, ia, (warp + 31) & 31);
  int pc = __shfl_sync(FULL, ic, (warp + 31) & 31);
  if (warp == 0) { pa = -INFINITY; pc = 0; }
  float la = __shfl_up_sync(FULL, sa, 1);
  int lc = __shfl_up_sync(FULL, sc, 1);
  if (lane == 0) { la = -INFINITY; lc = 0; }
  maxcount(pa, pc, la, lc);

  Xch* x = &c.sm->xch[c.xp];
  c.xp ^= 1;
  jitter<J>(7);
  if (tid == 0) {
    x->a = blk_a;
    x->smax = blk_smax;
    x->ka = wka;
    x->kb = wkb;
    x->v[0] = blk_fit;
    x->v[1] = blk_c;
    x->v[2] = blk_snan;
  }
  cl.sync();
  const int rank = (int)cl.block_rank();
  float ra = -INFINITY, rs = -INFINITY;
  unsigned rka = 0u, rkb = 0u;
  int rf = 0, rn = 0, rsn = 0;
  jitter<J>(8);
  if (lane < CLUSTER) {
    const Xch* rx = cl.map_shared_rank(x, lane);
    ra = rx->a;
    rs = rx->smax;
    rka = rx->ka;
    rkb = rx->kb;
    rf = rx->v[0];
    rn = rx->v[1];
    rsn = rx->v[2];
  }
  warp_key_top2(rka, rkb);
  const float t1 = from_orderable(rka);
  ws.top1 = t1;
  ws.top2 = from_orderable(rkb);
  ws.s_star = __any_sync(FULL, rsn != 0) ? __int_as_float(0x7fffffff)
                                         : warp_max(rs);
  ws.cmax = warp_max(ra);
  ws.any_fit = warp_sum(rf);
  const int at_top = (lane < CLUSTER && ra == t1) ? rn : 0;
  ws.n_top = warp_sum(at_top);
  ws.top_off = warp_sum(lane < rank ? at_top : 0);
  ws.top_blk = (blk_a == t1) ? blk_c : 0;
  ws.top_pre = (pa == blk_a && blk_a == t1) ? pc : 0;
  ws.top_mine = (ta == t1) ? tc : 0;
}

// One row's run (`bulk_run_lengths`): leading m's where it still fits and
// its score strictly beats `second`, m = 1 forced, capped at run_cap.
template <class F, bool J>
__device__ __forceinline__ int run_of(const Ctx<F, J>& c, int row,
                                      float second, int run_cap) {
  Row r;
  load_row(c, r, row, c.asg[c.slot_of_row(row)]);
  int run = 0;
  for (int m = 1; m <= run_cap; ++m) {
    bool f;
    float s;
    grid_cell(r, c.dem, (float)m, c.desired_div, c.spread, &f, &s);
    if (!(f && (s > second || m == 1))) break;
    run = m;
  }
  return run;
}

// One selection round.  Among the rows `cls` marks (1 "below": taken
// whole, 2 "at": taken from the at_lo-th to the (at_lo+need-1)-th in row
// order), given their counts (this thread's slice: mine_*; the threads
// before it in this block: pre_*; this block: blk_*; the blocks before:
// off_*), each block lists its taken rows and their positions among the
// round's q = n_below + need keys (below rows first), computes their runs
// and writes their keys into the leader's buffer; then every block reads
// the q keys back, sorts them when `sort` (below rows of several scores
// arrive in no order), takes the cumulative cap at `remaining` and
// applies its own rows' instances.  Returns the sum of the q runs; *last
// gets the round's last key.
struct RoundCounts {
  int mine_b, mine_a, pre_b, pre_a, blk_b, blk_a, off_b, off_a;
  int n_below, at_lo, need;
};

template <class F, bool J, class K>
__device__ int take_round(Ctx<F, J>& c, cg::cluster_group& cl,
                          const WaveStats& ws, const K& cls,
                          const RoundCounts& rc, bool sort, int run_cap,
                          int remaining, int run_base,
                          unsigned long long* last) {
  const int tid = threadIdx.x;
  const int q = rc.n_below + rc.need;
  // this block's at rows inside [at_lo, at_lo + need), by block-local rank
  const int a0 = min(max(rc.at_lo - rc.off_a, 0), rc.blk_a);
  const int a1 = min(max(rc.at_lo + rc.need - rc.off_a, 0), rc.blk_a);
  const int m_b = rc.blk_b + (a1 - a0);
  jitter<J>(9);
  if (rc.mine_b > 0 || (rc.mine_a > 0 && rc.pre_a < a1 &&
                        rc.pre_a + rc.mine_a > a0)) {
    int ib = rc.pre_b, ia = rc.pre_a;
    const int r0 = c.slice_lo(), r1 = c.slice_hi();
    for (int row = r0, i = 0; row < r1; ++row, ++i) {
      const float cur = c.cur[c.slot(i)];
      const int k = cls(cur, row);
      if (k == 1) {
        c.wk[ib] = key_of(score_word(cur), row);
        c.sel_pos[ib] = rc.off_b + ib;
        ++ib;
      } else if (k == 2) {
        if (ia >= a0 && ia < a1) {
          const int li = rc.blk_b + ia - a0;
          c.wk[li] = key_of(score_word(cur), row);
          c.sel_pos[li] = rc.n_below + rc.off_a + ia - rc.at_lo;
        }
        ++ia;
      }
    }
  }
  __syncthreads();                                  // the list is written
  unsigned long long* g0 = cl.map_shared_rank(c.gat, 0);
  jitter<J>(10);
  for (int i = tid; i < m_b; i += NT) {
    const unsigned long long key = c.wk[i];
    const float cur = key_score(key);
    const int row = (int)((key >> 8) & 0xFFFFFFull);
    const float second = (cur == ws.top1) ? ws.top2 : ws.top1;
    g0[c.sel_pos[i]] = key | (unsigned long long)run_of(c, row, second,
                                                         run_cap);
  }
  cl.sync();
  const int p = sort ? sort_len(q) : q;
  jitter<J>(11);
  for (int i = tid; i < p; i += NT) c.wk[i] = (i < q) ? g0[i] : NO_KEY;
  __syncthreads();
  if (sort) block_bitonic_sort(c.wk, p);
  jitter<J>(12);
  // cumulative cap in key order; thread t takes keys [t*per, (t+1)*per)
  const int per = (q + NT - 1) / NT;
  const int k0 = min(tid * per, q), k1 = min(k0 + per, q);
  int local = 0;
  for (int k = k0; k < k1; ++k) local += (int)(c.wk[k] & 0xFFull);
  int4 ex, tot;
  block_scan4<J>(make_int4(local, 0, 0, 0), c.sm->scan[c.sp], &ex, &tot);
  c.sp ^= 1;
  int prefix = run_base + ex.x;
  for (int k = k0; k < k1; ++k) {
    const unsigned long long key = c.wk[k];
    const int run = (int)(key & 0xFFull);
    const int row = (int)((key >> 8) & 0xFFFFFFull);
    const int alloc = min(max(remaining - prefix, 0), run);
    prefix += run;
    if (alloc > 0 && row >= c.lo && row < c.hi) {
      const float af = (float)alloc;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        const float inc = af * c.dem[d];
        c.used[(size_t)row * c.us + d] = c.used[(size_t)row * c.us + d] + inc;
      }
      c.asg[c.slot_of_row(row)] += alloc;
    }
  }
  *last = c.wk[q - 1];
  return tot.x;
}

// Radix select among the eligible rows: the need-th smallest score word
// (with multiplicity).  On return *need holds how many rows at it the
// selection takes.
template <class F, bool J, class E>
__device__ unsigned radix_select(Ctx<F, J>& c, cg::cluster_group& cl,
                                 const E& eligible, int* need) {
  const int tid = threadIdx.x;
  const int r0 = c.slice_lo(), r1 = c.slice_hi();
  unsigned prefix = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    Xch* x = &c.sm->xch[c.xp];
    c.xp ^= 1;
    jitter<J>(13);
    for (int i = tid; i < 256; i += NT) x->hist[i] = 0u;
    __syncthreads();
    jitter<J>(14);
    for (int row = r0, i = 0; row < r1; ++row, ++i) {
      const float cur = c.cur[c.slot(i)];
      if (!eligible(cur, row)) continue;
      const unsigned u = score_word(cur);
      if (shift == 24 || (u >> (shift + 8)) == prefix)
        atomicAdd(&x->hist[(u >> shift) & 255u], 1u);
    }
    cl.sync();
    int cnt = 0;
    jitter<J>(15);
    if (tid < 256) {
      for (int b = 0; b < CLUSTER; ++b)
        cnt += (int)cl.map_shared_rank(x, b)->hist[tid];
    }
    int4 ex, tot;
    block_scan4<J>(make_int4(cnt, 0, 0, 0), c.sm->scan[c.sp], &ex, &tot);
    c.sp ^= 1;
    jitter<J>(16);
    if (cnt > 0 && ex.x < *need && *need <= ex.x + cnt) {
      c.sm->pick_bin = tid;
      c.sm->pick_below = ex.x;
    }
    __syncthreads();
    jitter<J>(17);
    prefix = (prefix << 8) | (unsigned)c.sm->pick_bin;
    *need -= c.sm->pick_below;
  }
  return prefix;
}

// The wavefront loop (`_bulk_loop`) of one eval; every thread returns
// the placed and wave counts.
template <class F, bool J>
__device__ void bulk_wavefront(Ctx<F, J>& c, cg::cluster_group& cl,
                               int count, int max_waves, int fill_grid,
                               int* placed_out, int* waves_out) {
  const int tid = threadIdx.x;
  const int r0 = c.slice_lo(), r1 = c.slice_hi();
  int placed = 0, waves = 0;
  bool stuck = false;
  while (placed < count && !stuck && waves < max_waves) {
    WaveStats ws;
    row_pass(c, cl, ws);
    waves += 1;
    if (!ws.any_fit) {       // the reference's last, empty wave
      stuck = true;
      continue;
    }
    const int remaining = count - placed;
    const int run_cap = min(fill_grid, remaining);
    const float top1 = ws.top1, s_star = ws.s_star;
    // the wave: strict rows (cur > s*) if any (the largest cur that is
    // not NaN beats s*), else the rows at top1; k, the rows that can take
    // instances, is min(remaining, |wave|)
    int k;
    if (!(ws.cmax > s_star)) {
      k = min(remaining, ws.n_top);
    } else if (ws.n_top >= remaining) {
      k = remaining;
    } else {
      int nw = 0;
      for (int i = 0; i < r1 - r0; ++i) nw += (c.cur[c.slot(i)] > s_star) ? 1 : 0;
      int4 ex, tot;
      block_scan4<J>(make_int4(nw, 0, 0, 0), c.sm->scan[c.sp], &ex, &tot);
      c.sp ^= 1;
      Xch* x = &c.sm->xch[c.xp];
      c.xp ^= 1;
      jitter<J>(18);
      if (tid == 0) x->v[0] = tot.x;
      cl.sync();
      int4 all, before;
      cluster_sums<J>(cl, x, &all, &before);
      k = min(remaining, all.x);
    }

    int run_base = 0;
    unsigned long long last;
    if (ws.n_top >= k) {
      // the first k rows at top1, in row order: no sort
      auto at_top = [&](float cur, int) -> int { return cur == top1 ? 2 : 0; };
      for (int base = 0; base < k && run_base < remaining; base += KMAX) {
        if (base > 0) cl.sync();     // every block read the last round
        const RoundCounts rc{0, ws.top_mine, 0, ws.top_pre, 0, ws.top_blk,
                             0, ws.top_off, 0, base, min(KMAX, k - base)};
        run_base += take_round(c, cl, ws, at_top, rc, false, run_cap,
                               remaining, run_base, &last);
      }
    } else {
      // radix-select rounds of at most KMAX keys
      bool have_lo = false;
      unsigned long long lo_key = 0;
      auto eligible = [&](float cur, int row) -> bool {
        if (!(cur > s_star)) return false;
        return !have_lo || key_of(score_word(cur), row) > (lo_key & ~0xFFull);
      };
      for (int taken = 0; taken < k && run_base < remaining;) {
        const int q = min(KMAX, k - taken);
        int need = q;
        const unsigned thr = radix_select(c, cl, eligible, &need);
        auto cls = [&](float cur, int row) -> int {
          if (!eligible(cur, row)) return 0;
          const unsigned u = score_word(cur);
          return u < thr ? 1 : (u == thr ? 2 : 0);
        };
        int nb = 0, na = 0;
        for (int row = r0, i = 0; row < r1; ++row, ++i) {
          const int kk = cls(c.cur[c.slot(i)], row);
          nb += kk == 1;
          na += kk == 2;
        }
        int4 ex, tot;
        block_scan4<J>(make_int4(nb, na, 0, 0), c.sm->scan[c.sp], &ex, &tot);
        c.sp ^= 1;
        Xch* x = &c.sm->xch[c.xp];
        c.xp ^= 1;
        jitter<J>(19);
        if (tid == 0) {
          x->v[0] = tot.x;
          x->v[1] = tot.y;
        }
        cl.sync();
        int4 all, before;
        cluster_sums<J>(cl, x, &all, &before);
        const RoundCounts rc{nb, na, ex.x, ex.y, tot.x, tot.y, before.x,
                             before.y, all.x, 0, need};
        run_base += take_round(c, cl, ws, cls, rc, all.x > 1, run_cap,
                               remaining, run_base, &last);
        have_lo = true;
        lo_key = last;
        taken += q;
      }
    }
    placed += min(remaining, run_base);
    __syncthreads();                // the applied rows are read next wave
  }
  *placed_out = placed;
  *waves_out = waves;
}

// The eval's tail (`_bulk_tail`): every row's final m = 1 score, the
// feasible and exhausted counts and the rows that took instances.  After
// a wave, a row that took nothing still has the score the last row pass
// gave it, so only the rows that took instances are scored again (and,
// with `exact`, get f32(assign) * demand in the exact carry; `all_rows`
// gives every row that add, which also turns -0.0 into +0.0).  Without a
// wave (count 0) every row is scored, its usage canonicalized with
// `canon` (K4's `used + 0.0`).  `out(row, i, assign, score)` stores a
// row's outputs.  Returns the cluster's (n_eval, n_exh, assigned rows) in
// *all, the assigned rows of the blocks before this one in before->z and
// of this block's threads before this one in *pre_asg.
template <class F, bool J, class S>
__device__ void bulk_tail(Ctx<F, J>& c, cg::cluster_group& cl, bool waved,
                          bool canon, float* exact, bool all_rows,
                          const S& out, int4* all, int4* before,
                          int* pre_asg) {
  const int tid = threadIdx.x;
  const float zero[R] = {0.0f, 0.0f, 0.0f, 0.0f};
  int ne = waved ? c.n_feas : 0, nx = waved ? c.n_nofit : 0, na = 0;
  const int r0 = c.slice_lo(), r1 = c.slice_hi();
  jitter<J>(20);
  for (int row = r0, i = 0; row < r1; ++row, ++i) {
    const int asg = c.asg[c.slot(i)];
    const float cv = c.cur[c.slot(i)];
    const bool fit = !is_nofit(cv);      // at the last row pass
    float score = fit ? cv : -INFINITY;
    if (!waved || asg > 0) {
      Row r;
      load_row(c, r, row, asg);
      if (!waved && canon) canonicalize(c, r, row, zero);
      bool f;
      float s;
      grid_cell(r, c.dem, 1.0f, c.desired_div, c.spread, &f, &s);
      if (waved) {
        nx -= (r.feas && !fit) ? 1 : 0;    // the row pass counted it
      } else {
        ne += r.feas ? 1 : 0;
      }
      nx += (r.feas && !f) ? 1 : 0;
      score = f ? s : -INFINITY;
    }
    out(row, i, asg, score);
    na += asg > 0 ? 1 : 0;
    if (exact && (asg > 0 || all_rows)) {
      const float af = (float)asg;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        const float e = exact[row * R + d];
        const float inc = af * c.dem[d];
        const float v = e + inc;
        if (__float_as_uint(v) != __float_as_uint(e)) exact[row * R + d] = v;
      }
    }
  }
  int4 ex, tot;
  block_scan4<J>(make_int4(ne, nx, na, 0), c.sm->scan[c.sp], &ex, &tot);
  c.sp ^= 1;
  *pre_asg = ex.z;
  Xch* x = &c.sm->xch[c.xp];
  c.xp ^= 1;
  jitter<J>(21);
  if (tid == 0) {
    x->v[0] = tot.x;
    x->v[1] = tot.y;
    x->v[2] = tot.z;
    x->v[3] = 0;
  }
  cl.sync();
  cluster_sums<J>(cl, x, all, before);
}

// The block's rows, its threads' slices and its shared memory.
// scratch: i32[2n], the instances taken and the wave-start scores where
// a slice has more than CUR_SLOTS rows.
template <class F, bool J>
__device__ void setup(Ctx<F, J>& c, Shared& sm, unsigned long long* dyn,
                      int* scratch, int n, int rank) {
  const int rpb = (n + CLUSTER - 1) / CLUSTER;
  c.lo = min(rank * rpb, n);
  c.hi = min(c.lo + rpb, n);
  c.rpt = (rpb + NT - 1) / NT;
  c.gat = dyn;
  c.wk = dyn + KMAX;
  c.sel_pos = reinterpret_cast<int*>(dyn + 2 * KMAX);
  if (c.rpt <= CUR_SLOTS) {
    c.cur = reinterpret_cast<float*>(c.sel_pos + KMAX);
    c.asg = reinterpret_cast<int*>(c.cur + c.rpt * NT);
    c.cs_i = NT;
    c.cs_t = 1;
  } else {
    c.asg = scratch + c.lo;
    c.cur = reinterpret_cast<float*>(scratch + n) + c.lo;
    c.cs_i = 1;
    c.cs_t = c.rpt;
  }
  c.sm = &sm;
  c.sp = 0;
  c.xp = 0;
}

template <bool J>
__global__ void __launch_bounds__(NT, 1)
place_bulk_kernel(const float* __restrict__ capacity,
                  const float* __restrict__ used0,
                  const uint8_t* __restrict__ feasible,
                  const float* __restrict__ affinity, int has_affinity,
                  int desired, const uint8_t* __restrict__ penalty,
                  const int* __restrict__ coll0,
                  const float* __restrict__ demand, int count, int spread,
                  int max_waves, int fill_grid, int n,
                  float* __restrict__ out, int* __restrict__ scratch) {
  extern __shared__ unsigned long long dyn[];
  __shared__ Shared sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  Ctx<K1Fields, J> c;
  c.capacity = capacity;
  c.used = out;                    // cols [0, R) of out
  c.us = W;
  c.fl = K1Fields{feasible, penalty, affinity, coll0};
  c.has_aff = has_affinity != 0;
  c.desired_div = fmaxf((float)desired, 1.0f);
  c.spread = spread;
#pragma unroll
  for (int d = 0; d < R; ++d) {
    c.dem[d] = demand[d];
    c.canon[d] = 0.0f * c.dem[d];  // a wave's `used + 0 * demand`
  }
  setup(c, sm, dyn, scratch, n, rank);

  const int r0 = c.slice_lo(), r1 = c.slice_hi();
  for (int row = r0, i = 0; row < r1; ++row, ++i) {
#pragma unroll
    for (int d = 0; d < R; ++d) out[row * W + d] = used0[row * R + d];
    c.asg[c.slot(i)] = 0;
  }
  int placed, waves;
  bulk_wavefront(c, cl, count, max_waves, fill_grid, &placed, &waves);
  int4 all, before;
  int pre;
  bulk_tail(c, cl, waves > 0, false, nullptr, false,
            [&](int row, int, int asg, float s) {
              out[row * W + R] = (float)asg;
              out[row * W + R + 1] = s;
              out[row * W + R + 2] = 0.0f;
            },
            &all, &before, &pre);
  jitter<J>(22);
  if (threadIdx.x == 0) {
    const float s[4] = {(float)placed, (float)all.x, (float)all.y,
                        (float)waves};
    for (int j = 0; j < 4; ++j)
      if (j >= c.lo && j < c.hi) out[j * W + R + 2] = s[j];
  }
  cl.sync();    // no block exits while another reads its shared memory
}

// K4: E chained bulk evals.  `used` f32[n, R] is the chain carry (starts
// as used0); with exact_out, used0 itself is the exact carry, updated in
// place (the donated basis).
template <bool J>
__global__ void __launch_bounds__(NT, 1)
place_bulk_batch_kernel(const float* __restrict__ capacity, float* used0,
                        const float* __restrict__ heavy,
                        const float* __restrict__ dyn_in, int E, int n, int D,
                        int sparse, int spread, int max_waves, int fill_grid,
                        int exact_out, float* used, float* __restrict__ out,
                        int* __restrict__ scratch) {
  extern __shared__ unsigned long long dyn[];
  __shared__ Shared sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  Ctx<K4Fields, J> c;
  c.capacity = capacity;
  c.used = used;
  c.us = R;
  c.spread = spread;
#pragma unroll
  for (int d = 0; d < R; ++d) c.canon[d] = 0.0f;   // `used + delta_mat`
  setup(c, sm, dyn, scratch, n, rank);
  const int Ll = 3 + R + D * (R + 1);
  const int out_w = sparse ? 3 * SPARSE_CAP + 4 : 2 * n + 4;
  const int r0 = c.slice_lo(), r1 = c.slice_hi();

  // the carry; and whether this block's exact carry holds a -0.0 (or a
  // NaN), which the reference's every-row add would change
  int odd = 0;
  for (int i = r0; i < r1; ++i) {
#pragma unroll
    for (int d = 0; d < R; ++d) {
      const float v = used0[i * R + d];
      used[i * R + d] = v;
      odd |= (__float_as_uint(v) == 0x80000000u || isnan(v)) ? 1 : 0;
    }
  }
  const bool exact_all = __syncthreads_or(odd) != 0;

  for (int e = 0; e < E; ++e) {
    const float* l = dyn_in + (size_t)e * Ll;
    c.fl = K4Fields{heavy + (size_t)e * 4 * n, n};
    c.has_aff = l[0] > 0.5f;
    const int desired = (int)l[1];
    const int count = (int)l[2];
    c.desired_div = fmaxf((float)desired, 1.0f);
#pragma unroll
    for (int d = 0; d < R; ++d) c.dem[d] = l[3 + d];
    float* o = out + (size_t)e * out_w;

    jitter<J>(23);
    for (int i = 0; i < r1 - r0; ++i) c.asg[c.slot(i)] = 0;
    // this eval's deltas on this block's rows: each row's deltas summed
    // in their order from 0.0 (the reference's delta matrix), then added
    auto delta_row = [&](int k, float* dm) -> int {
      const int r = wrap_delta_row(l[3 + R + k], n);
      if (r < c.lo || r >= c.hi) return -1;
      for (int j = 0; j < k; ++j)
        if (wrap_delta_row(l[3 + R + j], n) == r) return -1;   // at its first
#pragma unroll
      for (int d = 0; d < R; ++d) dm[d] = 0.0f;
      for (int j = k; j < D; ++j) {
        if (wrap_delta_row(l[3 + R + j], n) != r) continue;
#pragma unroll
        for (int d = 0; d < R; ++d) dm[d] = dm[d] + l[3 + R + D + j * R + d];
      }
      return r;
    };
    jitter<J>(24);
    for (int k = tid; k < D; k += NT) {
      float dm[R];
      const int r = delta_row(k, dm);
      if (r < 0) continue;
#pragma unroll
      for (int d = 0; d < R; ++d) used[r * R + d] = used[r * R + d] + dm[d];
    }
    __syncthreads();

    int placed, waves;
    bulk_wavefront(c, cl, count, max_waves, fill_grid, &placed, &waves);
    int4 all, before;
    int pre;
    bulk_tail(c, cl, waves > 0, true, exact_out ? used0 : nullptr, exact_all,
              [&](int row, int i, int asg, float s) {
                if (sparse) {
                  c.cur[c.slot(i)] = s;
                } else {
                  o[row] = (float)asg;
                  o[n + row] = s;
                }
              },
              &all, &before, &pre);
    jitter<J>(25);
    if (sparse) {
      // the first SPARSE_CAP rows with assign > 0, in row order
      int pos = before.z + pre;
      for (int row = r0, i = 0; row < r1 && pos < SPARSE_CAP; ++row, ++i) {
        const int a = c.asg[c.slot(i)];
        if (a <= 0) continue;
        o[pos] = (float)row;
        o[SPARSE_CAP + pos] = (float)a;
        o[2 * SPARSE_CAP + pos] = c.cur[c.slot(i)];
        ++pos;
      }
      if (rank == 0) {
        for (int k = min(all.z, SPARSE_CAP) + tid; k < SPARSE_CAP; k += NT) {
          o[k] = (float)n;
          o[SPARSE_CAP + k] = 0.0f;
          o[2 * SPARSE_CAP + k] = 0.0f;
        }
      }
    }
    if (rank == 0 && tid == 0) {
      o[out_w - 4] = (float)placed;
      o[out_w - 3] = (float)all.x;
      o[out_w - 2] = (float)all.y;
      o[out_w - 1] = (float)waves;
    }
    // back the deltas out of the carry (after the tail read it)
    jitter<J>(26);
    for (int k = tid; k < D; k += NT) {
      float dm[R];
      const int r = delta_row(k, dm);
      if (r < 0) continue;
#pragma unroll
      for (int d = 0; d < R; ++d) used[r * R + d] = used[r * R + d] - dm[d];
    }
    __syncthreads();
  }
  cl.sync();    // no block exits while another reads its shared memory
}

// dynamic shared memory of a launch over n rows: the key buffers, and
// the wave-start scores and instances taken where a thread's slice fits
// CUR_SLOTS rows
size_t smem_for(int n) {
  const int rpb = (n + CLUSTER - 1) / CLUSTER;
  const int rpt = (rpb + NT - 1) / NT;
  return SMEM_KEYS + (rpt <= CUR_SLOTS ? (size_t)rpt * NT * 8 : 0);
}

}  // namespace

extern "C" int place_bulk_cluster_size() { return CLUSTER; }

// The delays' seed for the launches that follow on `stream` (0: the
// kernels without the delay sites).  A check's setting: no other host
// thread may launch K1/K4 meanwhile.
extern "C" int place_bulk_set_jitter(int seed, void* stream) {
  return (int)set_jitter(seed, (cudaStream_t)stream);
}

extern "C" int place_bulk_launch(const float* capacity, const float* used0,
                                 const uint8_t* feasible,
                                 const float* affinity, int has_affinity,
                                 int desired, const uint8_t* penalty,
                                 const int* coll0, const float* demand,
                                 int count, int spread, int max_waves,
                                 int fill_grid, int n, float* out,
                                 int* scratch, void* stream) {
  if (n < 1 || n > (1 << 24) || fill_grid < 1 || fill_grid > 255)
    return (int)cudaErrorInvalidValue;
  return (int)cluster_launch(
      jitter_on ? &place_bulk_kernel<true> : &place_bulk_kernel<false>,
      CLUSTER, NT, SMEM_MAX, smem_for(n), (cudaStream_t)stream, capacity,
      used0, feasible, affinity, has_affinity, desired, penalty, coll0, demand,
      count, spread, max_waves, fill_grid, n, out, scratch);
}

extern "C" int place_bulk_batch_launch(const float* capacity, float* used0,
                                       const float* heavy, const float* dyn,
                                       int E, int n, int D, int sparse,
                                       int spread, int max_waves,
                                       int fill_grid, int exact_out,
                                       float* used, float* out, int* scratch,
                                       void* stream) {
  if (n < 1 || n > (1 << 24) || fill_grid < 1 || fill_grid > 255)
    return (int)cudaErrorInvalidValue;
  return (int)cluster_launch(
      jitter_on ? &place_bulk_batch_kernel<true>
                : &place_bulk_batch_kernel<false>,
      CLUSTER, NT, SMEM_MAX, smem_for(n), (cudaStream_t)stream, capacity,
      used0, heavy, dyn, E, n, D, sparse, spread, max_waves, fill_grid,
      exact_out, used, out, scratch);
}
