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
// hold.  Past 16,384 rows (a cluster of more than 16,384 nodes) the
// keys go to a global scratch the wrapper allocates (1 MB at 131,072
// rows, resident in the 50 MB L2): the wave rows' keys are packed to
// the front by a block scan and only those are sorted, which gives the
// same sorted prefix.  The key holds a row in 24 bits, so N <= 2^24.  A
// block scan of run lengths in sorted order gives the cumulative cap.
// Per-row state (used, co-placement count, assign, wave-start score)
// lives in global memory, which one block reads back through L1/L2.
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

#include "bulk_common.cuh"

namespace {

constexpr int R = 4;              // resource dims (cpu, mem, disk, net)
constexpr int W = R + 3;          // packed output width
constexpr int SPARSE_CAP = 128;   // ops/place.py SPARSE_CAP

using Row = BulkRow;

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

// The sort key of row j in this wave, NO_KEY unless the row is in the
// wave set: (orderable(-cur) << 32 | row << 8 | run), ascending = score
// desc, row asc.  The run stops at the row's first failing column or at
// run_cap.
template <class F>
__device__ __forceinline__ unsigned long long wave_key(
    int j, const float* __restrict__ capacity, const float* __restrict__ used,
    int us, const F& fl, const int* __restrict__ coll,
    const float* __restrict__ cur_buf, bool has_aff, float desired_div,
    const float* dem, int spread, bool any_strict, float s_star, float top1,
    float top2, int run_cap) {
  const float cur = cur_buf[j];
  const bool fits = cur > -INFINITY;
  const bool in_wave = any_strict ? (cur > s_star) : (fits && cur == top1);
  if (!in_wave) return NO_KEY;
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
  return ((unsigned long long)orderable(-cur + 0.0f) << 32) |
         ((unsigned long long)j << 8) | (unsigned long long)run;
}

// The wavefront loop (`_bulk_loop`) of one eval.  `used` (row stride
// `us`) is updated in place; coll/assign/cur_buf are i32/i32/f32[n]
// scratch.  `keys` holds p = sort_len(n) entries: in shared memory, every
// row keyed at its own index and all p sorted; or (compact, for n past
// SMEM_SORT_ROWS) in a global scratch, the wave rows' keys packed to the
// front in row order and only sort_len(wave size) of them sorted — the
// same sorted prefix, since every key outside the wave is NO_KEY.  Every
// thread returns the placed and wave counts.
template <class F>
__device__ void bulk_wavefront(const float* __restrict__ capacity,
                               float* __restrict__ used, int us, const F& fl,
                               int* __restrict__ coll, int* __restrict__ assign,
                               float* __restrict__ cur_buf,
                               unsigned long long* keys, bool compact,
                               BulkShared& sh,
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
      top2_push(a, b, cur);
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
    int q = p;               // keys to sort
    if (!compact) {
      for (int j = tid; j < p; j += NT) {
        keys[j] = (j < n) ? wave_key(j, capacity, used, us, fl, coll, cur_buf,
                                     has_aff, desired_div, dem, spread,
                                     any_strict, s_star, top1, top2, run_cap)
                          : NO_KEY;
      }
    } else {
      int base = 0;
      for (int c0 = 0; c0 < n; c0 += NT) {
        const int j = c0 + tid;
        const unsigned long long key =
            (j < n) ? wave_key(j, capacity, used, us, fl, coll, cur_buf,
                               has_aff, desired_div, dem, spread, any_strict,
                               s_star, top1, top2, run_cap)
                    : NO_KEY;
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

    // -- greedy order: bitonic sort of the keys, ascending
    block_bitonic_sort(keys, q);

    // -- cumulative cap at the remaining count, in sorted order
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
                  float* __restrict__ out, int* __restrict__ scratch,
                  unsigned long long* gkeys) {
  extern __shared__ unsigned long long skeys[];  // p entries, or none
  __shared__ BulkShared sh;
  unsigned long long* keys = gkeys ? gkeys : skeys;

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
  bulk_wavefront(capacity, used, W, fl, coll, assign, cur_buf, keys,
                 gkeys != nullptr, sh, has_aff, desired_div, dem, count,
                 spread, max_waves, fill_grid, n, p, &placed, &waves);
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
                        float* __restrict__ delta, unsigned long long* gkeys) {
  extern __shared__ unsigned long long skeys[];  // p entries, or none
  __shared__ BulkShared sh;
  unsigned long long* keys = gkeys ? gkeys : skeys;

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
    bulk_wavefront(capacity, used, R, fl, coll, assign, cur_buf, keys,
                   gkeys != nullptr, sh, has_aff, desired_div, dem, count,
                   spread, max_waves, fill_grid, n, p, &placed, &waves);
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

// gkeys: NULL for n <= SMEM_SORT_ROWS (the sort runs in shared memory),
// else a u64[sort_len(n)] global scratch (compacted wave sort)
extern "C" int place_bulk_launch(const float* capacity, const float* used0,
                                 const uint8_t* feasible,
                                 const float* affinity, int has_affinity,
                                 int desired, const uint8_t* penalty,
                                 const int* coll0, const float* demand,
                                 int count, int spread, int max_waves,
                                 int fill_grid, int n, float* out,
                                 int* scratch, unsigned long long* gkeys,
                                 void* stream) {
  const int p = sort_len(n);
  if ((gkeys == nullptr) != (n <= SMEM_SORT_ROWS)) return (int)cudaErrorInvalidValue;
  const size_t smem = gkeys ? 0 : (size_t)p * sizeof(unsigned long long);
  cudaError_t err = allow_smem_sort(place_bulk_kernel);
  if (err != cudaSuccess) return (int)err;
  place_bulk_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      capacity, used0, feasible, affinity, has_affinity, desired, penalty,
      coll0, demand, count, spread, max_waves, fill_grid, n, p, out, scratch,
      gkeys);
  return (int)cudaGetLastError();
}

extern "C" int place_bulk_batch_launch(const float* capacity, float* used0,
                                       const float* heavy, const float* dyn,
                                       int E, int n, int D, int sparse,
                                       int spread, int max_waves,
                                       int fill_grid, int exact_out,
                                       float* used, float* out, int* scratch,
                                       float* delta, unsigned long long* gkeys,
                                       void* stream) {
  const int p = sort_len(n);
  if ((gkeys == nullptr) != (n <= SMEM_SORT_ROWS)) return (int)cudaErrorInvalidValue;
  const size_t smem = gkeys ? 0 : (size_t)p * sizeof(unsigned long long);
  cudaError_t err = allow_smem_sort(place_bulk_batch_kernel);
  if (err != cudaSuccess) return (int)err;
  place_bulk_batch_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      capacity, used0, heavy, dyn, E, n, D, sparse, spread, max_waves,
      fill_grid, exact_out, p, used, out, scratch, delta, gkeys);
  return (int)cudaGetLastError();
}
