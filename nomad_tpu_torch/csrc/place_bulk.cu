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
// `place_bulk_batch_plain`; they must agree exactly on every integer
// output.
//
// What bounds it on this card: not bytes (one wave reads ~44 bytes a
// row, ~0.7 MB at 16K rows, a fraction of a microsecond at 3.35 TB/s)
// but latency.  The loop over waves is sequential with a data-dependent
// trip count, and every wave has three dependent block-wide steps
// (reductions for s*/top-2, a sort of the wave set, a prefix scan over
// it), each separated by barriers.  K4 chains E evals, each of which
// must see the placements of the one before it, so the evals are
// sequential too.
//
// Design: ONE persistent block of 1024 threads runs every wave inside
// the kernel (no per-wave launch, no host round trip); K4's block also
// loops over the E evals, so a whole chain is one launch.  Thread t owns
// rows t, t+1024, ...; it evaluates that row's [M]-column fill grid on
// the fly (nothing [N, M] is materialized) and stops a row's run at its
// first failing column or at the remaining count (a run is only ever
// used up to the remaining count, so capping it changes no output).
// Block reductions give any_fit, s* and the top-2 values.  The greedy
// order (score desc, row asc) is a bitonic sort of 64-bit keys
// (orderable(-cur) << 32 | row << 8 | run) in dynamic shared memory —
// 8 bytes a row, 128 KB at N = 16384, under the 227 KB a block may
// hold.  A block scan of run lengths in sorted order gives the
// cumulative cap.  Per-row state (used, co-placement count, assign,
// wave-start score) lives in global memory, which one block reads back
// through L1/L2.
//
// K4 per eval: read the light block (has_aff, desired, count, demand,
// D delta rows and values) and the heavy row f32[4N] (feasible > 0.5,
// affinity, penalty > 0.5, coll0 value-encoded); build the eval's delta
// matrix (zeros, then each delta added in order, rows outside [0, N)
// dropped) and add it into the chain carry; run the wavefront and the
// final score pass; write packed row e (dense [2N+4], or sparse
// [3*SPARSE_CAP+4] with the first SPARSE_CAP assigned rows in row order
// from a block prefix count); subtract the delta matrix again — the
// reference's op order, so deltas stay scoped to their eval.  With
// exact_out the block also adds f32(assign) * demand into the exact
// carry, which is the donated usage basis itself, updated in place.
//
// Numerics: compiled without fast math and with -fmad=false; powf (not
// __powf); operations in the reference's order (fit/18,
// -(coll+1)/max(desired,1), total/n_scorers), so each row's scores are
// the plain version's bit for bit.  fit/18 is a multiply by the f32
// reciprocal 1.0f/18.0f, which is what XLA compiles the reference's
// division by that constant into.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;          // threads in the block
constexpr int NW = NT / 32;       // warps in the block
constexpr int R = 4;              // resource dims (cpu, mem, disk, net)
constexpr int RES_CPU = 0;
constexpr int RES_MEM = 1;
constexpr int W = R + 3;          // packed output width
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int SPARSE_CAP = 128;   // ops/place.py SPARSE_CAP

__device__ __forceinline__ float free_frac(float cap, float use) {
  float frac = 1.0f - use / cap;
  if (cap <= 0.0f) frac = (use > 0.0f) ? -INFINITY : 1.0f;
  return frac;
}

// ops/fit.py score_fit: BestFit v3 (binpack) or worst fit (spread), in [0, 18]
__device__ __forceinline__ float score_fit(const float* cap, const float* u,
                                           int spread) {
  float total = powf(10.0f, free_frac(cap[RES_CPU], u[RES_CPU])) +
                powf(10.0f, free_frac(cap[RES_MEM], u[RES_MEM]));
  float raw = spread ? (total - 2.0f) : (20.0f - total);
  return fminf(fmaxf(raw, 0.0f), 18.0f);
}

struct Row {
  float cap[R];
  float used[R];
  float coll;    // co-placed instances so far (value-exact float)
  bool feas;
  bool pen;
  bool aff_on;
  float aff;
};

// One cell of bulk_wave_grid: the row's fit and score with m more
// instances placed on it.
__device__ __forceinline__ void grid_cell(const Row& r, const float* dem,
                                          float m, float desired_div,
                                          int spread, bool* fits,
                                          float* score) {
  float u[R];
  bool f = r.feas;
#pragma unroll
  for (int d = 0; d < R; ++d) {
    float md = m * dem[d];
    u[d] = r.used[d] + md;
    f = f && (u[d] <= r.cap[d]);
  }
  float fit = score_fit(r.cap, u, spread) * (1.0f / 18.0f);
  float coll_m = (r.coll + m) - 1.0f;
  float total = fit;
  float n = 1.0f;
  float anti = -(coll_m + 1.0f) / desired_div;
  bool hc = coll_m > 0.0f;
  total = total + (hc ? anti : 0.0f);
  n = n + (hc ? 1.0f : 0.0f);
  total = total - (r.pen ? 1.0f : 0.0f);
  n = n + (r.pen ? 1.0f : 0.0f);
  total = total + (r.aff_on ? r.aff : 0.0f);
  n = n + (r.aff_on ? 1.0f : 0.0f);
  *fits = f;
  *score = total / n;
}

__device__ __forceinline__ unsigned int orderable(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (a, b) = the two largest values of a multiset, a >= b
__device__ __forceinline__ void top2_merge(float& a, float& b, float oa, float ob) {
  float na = fmaxf(a, oa);
  float nb = fmaxf(fminf(a, oa), fmaxf(b, ob));
  a = na;
  b = nb;
}

__device__ __forceinline__ void warp_top2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float oa = __shfl_xor_sync(0xffffffffu, a, o);
    float ob = __shfl_xor_sync(0xffffffffu, b, o);
    top2_merge(a, b, oa, ob);
  }
}

// Block-wide reductions; every thread returns the result.  The trailing
// barrier lets the scratch be reused by the next call.
__device__ float block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float r = warp_max(sh[lane]);
  __syncthreads();
  return r;
}

__device__ int block_sum(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int r = warp_sum(sh[lane]);
  __syncthreads();
  return r;
}

__device__ void block_top2(float& a, float& b, float* sha, float* shb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_top2(a, b);
  if (lane == 0) { sha[warp] = a; shb[warp] = b; }
  __syncthreads();
  a = sha[lane];
  b = shb[lane];
  warp_top2(a, b);
  __syncthreads();
}

// Exclusive prefix sum over the block's threads; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  int w = sh[lane];
  int wi = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, wi, o);
    if (lane >= o) wi += y;
  }
  int warp_prefix = __shfl_sync(0xffffffffu, wi - w, warp);
  *total = __shfl_sync(0xffffffffu, wi, 31);
  __syncthreads();
  return warp_prefix + x - v;
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

struct BulkShared {
  float f[NW];
  float f2[NW];
  int i[NW];
};

template <class F>
__device__ __forceinline__ void load_row(Row& r, int i, const float* cap,
                                         const float* used, int us,
                                         const int* coll, const F& fl,
                                         bool has_aff) {
#pragma unroll
  for (int d = 0; d < R; ++d) {
    r.cap[d] = cap[i * R + d];
    r.used[d] = used[(size_t)i * us + d];
  }
  r.coll = (float)coll[i];
  r.feas = fl.feasible(i);
  r.pen = fl.penalty(i);
  r.aff = fl.affinity(i);
  r.aff_on = has_aff && (r.aff != 0.0f);
}

// The wavefront loop (`_bulk_loop`) of one eval.  `used` (row stride
// `us`) is updated in place; coll/assign/cur_buf are i32/i32/f32[n]
// scratch, keys p entries of shared memory.  Every thread returns the
// placed and wave counts.
template <class F>
__device__ void bulk_wavefront(const float* __restrict__ capacity,
                               float* __restrict__ used, int us, const F& fl,
                               int* __restrict__ coll, int* __restrict__ assign,
                               float* __restrict__ cur_buf,
                               unsigned long long* keys, BulkShared& sh,
                               bool has_aff, float desired_div,
                               const float* dem, int count, int spread,
                               int max_waves, int fill_grid, int n, int p,
                               int* placed_out, int* waves_out) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += NT) {
    coll[i] = fl.coll(i);
    assign[i] = 0;
  }
  __syncthreads();

  int placed = 0, waves = 0;
  bool stuck = false;
  while (placed < count && !stuck && waves < max_waves) {
    // -- wave-start scores (m = 1), post-placement scores (m = 2)
    float a = -INFINITY, b = -INFINITY, smax = -INFINITY;
    int anyfit = 0;
    for (int i = tid; i < n; i += NT) {
      Row r;
      load_row(r, i, capacity, used, us, coll, fl, has_aff);
      bool f1, f2;
      float s1, s2;
      grid_cell(r, dem, 1.0f, desired_div, spread, &f1, &s1);
      grid_cell(r, dem, 2.0f, desired_div, spread, &f2, &s2);
      float cur = f1 ? s1 : -INFINITY;
      cur_buf[i] = cur;
      if (cur >= a) { b = a; a = cur; } else if (cur > b) { b = cur; }
      if (f2) smax = fmaxf(smax, s2);
      anyfit |= f1 ? 1 : 0;
    }
    block_top2(a, b, sh.f, sh.f2);
    const float top1 = a, top2 = b;
    const float s_star = block_max(smax, sh.f);
    const int any_fit = block_sum(anyfit, sh.i);
    waves += 1;
    if (!any_fit) {          // the reference's last, empty wave
      stuck = true;
      continue;
    }

    // -- wave set: strict (cur > s*) if any, else the tie set (cur == max)
    int nstrict = 0;
    for (int i = tid; i < n; i += NT) nstrict += (cur_buf[i] > s_star) ? 1 : 0;
    const bool any_strict = block_sum(nstrict, sh.i) > 0;

    // -- run lengths of the wave rows, as sort keys
    const int remaining = count - placed;
    const int run_cap = min(fill_grid, remaining);
    for (int j = tid; j < p; j += NT) {
      unsigned long long key = NO_KEY;
      if (j < n) {
        const float cur = cur_buf[j];
        const bool fits = cur > -INFINITY;
        const bool in_wave = any_strict ? (cur > s_star) : (fits && cur == top1);
        if (in_wave) {
          const float second = (cur == top1) ? top2 : top1;
          Row r;
          load_row(r, j, capacity, used, us, coll, fl, has_aff);
          int run = 0;
          for (int m = 1; m <= run_cap; ++m) {
            bool f;
            float s;
            grid_cell(r, dem, (float)m, desired_div, spread, &f, &s);
            if (!(f && (s > second || m == 1))) break;
            run = m;
          }
          key = ((unsigned long long)orderable(-cur + 0.0f) << 32) |
                ((unsigned long long)j << 8) | (unsigned long long)run;
        }
      }
      keys[j] = key;
    }
    __syncthreads();

    // -- greedy order: bitonic sort of the keys, ascending
    for (int k = 2; k <= p; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        for (int t = tid; t < (p >> 1); t += NT) {
          const int i = ((t & ~(jj - 1)) << 1) | (t & (jj - 1));
          const int l = i | jj;
          const unsigned long long x = keys[i], y = keys[l];
          const bool asc = (i & k) == 0;
          if ((x > y) == asc) { keys[i] = y; keys[l] = x; }
        }
        __syncthreads();
      }
    }

    // -- cumulative cap at the remaining count, in sorted order
    const int per = (p + NT - 1) / NT;
    const int lo = min(tid * per, p), hi = min(lo + per, p);
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
      const int base = (int)(key & 0xFFull);
      const int row = (int)((key >> 8) & 0xFFFFFFull);
      const int alloc = min(max(remaining - prefix, 0), base);
      prefix += base;
      if (alloc > 0) {
        const float af = (float)alloc;
#pragma unroll
        for (int d = 0; d < R; ++d) {
          float inc = af * dem[d];
          used[(size_t)row * us + d] = used[(size_t)row * us + d] + inc;
        }
        coll[row] += alloc;
        assign[row] += alloc;
      }
    }
    placed += min(remaining, total_base);
    __syncthreads();
  }
  *placed_out = placed;
  *waves_out = waves;
}

// Final scores + eval/exhaustion counts (`_bulk_tail`): scores[i * ss]
// gets row i's m = 1 score (-inf where it no longer fits); every thread
// returns the two block-wide counts.
template <class F>
__device__ void bulk_tail(const float* __restrict__ capacity,
                          const float* __restrict__ used, int us, const F& fl,
                          const int* __restrict__ coll, BulkShared& sh,
                          bool has_aff, float desired_div, const float* dem,
                          int spread, int n, float* scores, int ss,
                          int* n_eval_out, int* n_exh_out) {
  int n_eval = 0, n_exh = 0;
  for (int i = threadIdx.x; i < n; i += NT) {
    Row r;
    load_row(r, i, capacity, used, us, coll, fl, has_aff);
    bool f;
    float s;
    grid_cell(r, dem, 1.0f, desired_div, spread, &f, &s);
    scores[(size_t)i * ss] = f ? s : -INFINITY;
    n_eval += r.feas ? 1 : 0;
    n_exh += (r.feas && !f) ? 1 : 0;
  }
  *n_eval_out = block_sum(n_eval, sh.i);
  *n_exh_out = block_sum(n_exh, sh.i);
}

__global__ void __launch_bounds__(NT, 1)
place_bulk_kernel(const float* __restrict__ capacity,
                  const float* __restrict__ used0,
                  const uint8_t* __restrict__ feasible,
                  const float* __restrict__ affinity, int has_affinity,
                  int desired, const uint8_t* __restrict__ penalty,
                  const int* __restrict__ coll0,
                  const float* __restrict__ demand, int count, int spread,
                  int max_waves, int fill_grid, int n, int p,
                  float* __restrict__ out, int* __restrict__ scratch) {
  extern __shared__ unsigned long long keys[];   // p entries
  __shared__ BulkShared sh;

  const int tid = threadIdx.x;
  int* coll = scratch;                                   // i32[n]
  int* assign = scratch + n;                             // i32[n]
  float* cur_buf = reinterpret_cast<float*>(scratch + 2 * n);  // f32[n]
  float* used = out;                                     // cols [0, R) of out
  const bool has_aff = has_affinity != 0;
  const float desired_div = fmaxf((float)desired, 1.0f);
  const K1Fields fl{feasible, penalty, affinity, coll0};
  float dem[R];
#pragma unroll
  for (int d = 0; d < R; ++d) dem[d] = demand[d];

  for (int i = tid; i < n; i += NT) {
#pragma unroll
    for (int d = 0; d < R; ++d) used[i * W + d] = used0[i * R + d];
  }
  __syncthreads();

  int placed, waves, n_eval, n_exh;
  bulk_wavefront(capacity, used, W, fl, coll, assign, cur_buf, keys, sh,
                 has_aff, desired_div, dem, count, spread, max_waves,
                 fill_grid, n, p, &placed, &waves);
  bulk_tail(capacity, used, W, fl, coll, sh, has_aff, desired_div, dem,
            spread, n, out + R + 1, W, &n_eval, &n_exh);
  for (int i = tid; i < n; i += NT) {
    out[i * W + R] = (float)assign[i];
    out[i * W + R + 2] = 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    out[0 * W + R + 2] = (float)placed;
    out[1 * W + R + 2] = (float)n_eval;
    out[2 * W + R + 2] = (float)n_exh;
    out[3 * W + R + 2] = (float)waves;
  }
}

// K4: E chained bulk evals.  `used` f32[n, R] is the chain carry (starts
// as used0); with exact_out, used0 itself is the exact carry, updated in
// place (the donated basis).  scratch: i32[3n]; delta: f32[n, R].
__global__ void __launch_bounds__(NT, 1)
place_bulk_batch_kernel(const float* __restrict__ capacity,
                        float* used0, const float* __restrict__ heavy,
                        const float* __restrict__ dyn, int E, int n, int D,
                        int sparse, int spread, int max_waves, int fill_grid,
                        int exact_out, int p, float* used,
                        float* __restrict__ out, int* __restrict__ scratch,
                        float* __restrict__ delta) {
  extern __shared__ unsigned long long keys[];   // p entries
  __shared__ BulkShared sh;

  const int tid = threadIdx.x;
  int* coll = scratch;
  int* assign = scratch + n;
  float* cur_buf = reinterpret_cast<float*>(scratch + 2 * n);
  const int Ll = 3 + R + D * (R + 1);
  const int out_w = sparse ? 3 * SPARSE_CAP + 4 : 2 * n + 4;

  for (int i = tid; i < n * R; i += NT) used[i] = used0[i];
  __syncthreads();

  for (int e = 0; e < E; ++e) {
    const float* l = dyn + (size_t)e * Ll;
    const K4Fields fl{heavy + (size_t)e * 4 * n, n};
    const bool has_aff = l[0] > 0.5f;
    const int desired = (int)l[1];
    const int count = (int)l[2];
    const float desired_div = fmaxf((float)desired, 1.0f);
    float dem[R];
#pragma unroll
    for (int d = 0; d < R; ++d) dem[d] = l[3 + d];
    float* o = out + (size_t)e * out_w;

    // -- this eval's deltas, scoped to it: used + delta_mat
    if (D > 0) {
      for (int i = tid; i < n * R; i += NT) delta[i] = 0.0f;
      __syncthreads();
      if (tid == 0) {
        for (int k = 0; k < D; ++k) {
          const int r = (int)l[3 + R + k];
          if (r < 0 || r >= n) continue;
          for (int d = 0; d < R; ++d)
            delta[r * R + d] = delta[r * R + d] + l[3 + R + D + k * R + d];
        }
      }
      __syncthreads();
      for (int i = tid; i < n * R; i += NT) used[i] = used[i] + delta[i];
      __syncthreads();
    }

    int placed, waves, n_eval, n_exh;
    bulk_wavefront(capacity, used, R, fl, coll, assign, cur_buf, keys, sh,
                   has_aff, desired_div, dem, count, spread, max_waves,
                   fill_grid, n, p, &placed, &waves);
    // sparse rows read the scores back from cur_buf
    bulk_tail(capacity, used, R, fl, coll, sh, has_aff, desired_div, dem,
              spread, n, sparse ? cur_buf : o + n, 1, &n_eval, &n_exh);
    __syncthreads();

    if (sparse) {
      // first SPARSE_CAP rows with assign > 0, in row order
      int base = 0;
      for (int c0 = 0; c0 < n; c0 += NT) {
        const int i = c0 + tid;
        const int m = (i < n && assign[i] > 0) ? 1 : 0;
        int total;
        const int pos = base + block_exclusive_scan(m, sh.i, &total);
        if (m && pos < SPARSE_CAP) {
          o[pos] = (float)i;
          o[SPARSE_CAP + pos] = (float)assign[i];
          o[2 * SPARSE_CAP + pos] = cur_buf[i];
        }
        base += total;
      }
      for (int k = min(base, SPARSE_CAP) + tid; k < SPARSE_CAP; k += NT) {
        o[k] = (float)n;
        o[SPARSE_CAP + k] = 0.0f;
        o[2 * SPARSE_CAP + k] = 0.0f;
      }
    } else {
      for (int i = tid; i < n; i += NT) o[i] = (float)assign[i];
    }
    if (tid == 0) {
      o[out_w - 4] = (float)placed;
      o[out_w - 3] = (float)n_eval;
      o[out_w - 2] = (float)n_exh;
      o[out_w - 1] = (float)waves;
    }

    // -- back the deltas out of the carry; exact carry += assign * demand
    for (int i = tid; i < n * R; i += NT) {
      if (D > 0) used[i] = used[i] - delta[i];
      if (exact_out) {
        const float inc = (float)assign[i / R] * dem[i % R];
        used0[i] = used0[i] + inc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int place_bulk_launch(const float* capacity, const float* used0,
                                 const uint8_t* feasible,
                                 const float* affinity, int has_affinity,
                                 int desired, const uint8_t* penalty,
                                 const int* coll0, const float* demand,
                                 int count, int spread, int max_waves,
                                 int fill_grid, int n, float* out,
                                 int* scratch, void* stream) {
  int p = 2;
  while (p < n) p <<= 1;
  const size_t smem = (size_t)p * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      place_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  place_bulk_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      capacity, used0, feasible, affinity, has_affinity, desired, penalty,
      coll0, demand, count, spread, max_waves, fill_grid, n, p, out, scratch);
  return (int)cudaGetLastError();
}

extern "C" int place_bulk_batch_launch(const float* capacity, float* used0,
                                       const float* heavy, const float* dyn,
                                       int E, int n, int D, int sparse,
                                       int spread, int max_waves,
                                       int fill_grid, int exact_out,
                                       float* used, float* out, int* scratch,
                                       float* delta, void* stream) {
  int p = 2;
  while (p < n) p <<= 1;
  const size_t smem = (size_t)p * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      place_bulk_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  place_bulk_batch_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      capacity, used0, heavy, dyn, E, n, D, sparse, spread, max_waves,
      fill_grid, exact_out, p, used, out, scratch, delta);
  return (int)cudaGetLastError();
}
