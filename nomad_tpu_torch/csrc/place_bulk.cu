// place_bulk.cu — bulk wavefront placement of `count` identical slots of
// one task group, for Hopper (sm_90a).
//
// Replaces: nomad_tpu/ops/place.py `place_bulk_jit` (with `_bulk_loop`,
// `bulk_wave_grid`, `bulk_run_lengths`, `_bulk_scores`, `_bulk_tail` and
// ops/fit.py `score_fit`/`free_fractions`).  The plain PyTorch version is
// nomad_tpu_torch/ops/place.py `place_bulk_plain`; the two must agree
// exactly on every integer output.
//
// What bounds it on this card: not bytes (one wave reads ~44 bytes a
// row, ~0.7 MB at 16K rows, a fraction of a microsecond at 3.35 TB/s)
// but latency.  The loop over waves is sequential with a data-dependent
// trip count, and every wave has three dependent block-wide steps
// (reductions for s*/top-2, a sort of the wave set, a prefix scan over
// it), each separated by barriers.
//
// Design: ONE persistent block of 1024 threads runs every wave inside
// the kernel (no per-wave launch, no host round trip).  Thread t owns
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

__device__ __forceinline__ void load_row(Row& r, int i, const float* cap,
                                         const float* used, const int* coll,
                                         const uint8_t* feas,
                                         const uint8_t* pen, const float* aff,
                                         bool has_aff) {
#pragma unroll
  for (int d = 0; d < R; ++d) {
    r.cap[d] = cap[i * R + d];
    r.used[d] = used[i * W + d];
  }
  r.coll = (float)coll[i];
  r.feas = feas[i] != 0;
  r.pen = pen[i] != 0;
  r.aff = aff[i];
  r.aff_on = has_aff && (r.aff != 0.0f);
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
  __shared__ float sh_f[NW];
  __shared__ float sh_f2[NW];
  __shared__ int sh_i[NW];

  const int tid = threadIdx.x;
  int* coll = scratch;                                   // i32[n]
  int* assign = scratch + n;                             // i32[n]
  float* cur_buf = reinterpret_cast<float*>(scratch + 2 * n);  // f32[n]
  float* used = out;                                     // cols [0, R) of out
  const bool has_aff = has_affinity != 0;
  const float desired_div = fmaxf((float)desired, 1.0f);
  float dem[R];
#pragma unroll
  for (int d = 0; d < R; ++d) dem[d] = demand[d];

  for (int i = tid; i < n; i += NT) {
#pragma unroll
    for (int d = 0; d < R; ++d) used[i * W + d] = used0[i * R + d];
    coll[i] = coll0[i];
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
      load_row(r, i, capacity, used, coll, feasible, penalty, affinity, has_aff);
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
    block_top2(a, b, sh_f, sh_f2);
    const float top1 = a, top2 = b;
    const float s_star = block_max(smax, sh_f);
    const int any_fit = block_sum(anyfit, sh_i);
    waves += 1;
    if (!any_fit) {          // the reference's last, empty wave
      stuck = true;
      continue;
    }

    // -- wave set: strict (cur > s*) if any, else the tie set (cur == max)
    int nstrict = 0;
    for (int i = tid; i < n; i += NT) nstrict += (cur_buf[i] > s_star) ? 1 : 0;
    const bool any_strict = block_sum(nstrict, sh_i) > 0;

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
          load_row(r, j, capacity, used, coll, feasible, penalty, affinity, has_aff);
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
    int prefix = block_exclusive_scan(local, sh_i, &total_base);
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
          used[row * W + d] = used[row * W + d] + inc;
        }
        coll[row] += alloc;
        assign[row] += alloc;
      }
    }
    placed += min(remaining, total_base);
    __syncthreads();
  }

  // -- final scores + eval/exhaustion counts (_bulk_tail)
  int n_eval = 0, n_exh = 0;
  for (int i = tid; i < n; i += NT) {
    Row r;
    load_row(r, i, capacity, used, coll, feasible, penalty, affinity, has_aff);
    bool f;
    float s;
    grid_cell(r, dem, 1.0f, desired_div, spread, &f, &s);
    out[i * W + R] = (float)assign[i];
    out[i * W + R + 1] = f ? s : -INFINITY;
    out[i * W + R + 2] = 0.0f;
    n_eval += r.feas ? 1 : 0;
    n_exh += (r.feas && !f) ? 1 : 0;
  }
  n_eval = block_sum(n_eval, sh_i);
  n_exh = block_sum(n_exh, sh_i);
  if (tid == 0) {
    out[0 * W + R + 2] = (float)placed;
    out[1 * W + R + 2] = (float)n_eval;
    out[2 * W + R + 2] = (float)n_exh;
    out[3 * W + R + 2] = (float)waves;
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
