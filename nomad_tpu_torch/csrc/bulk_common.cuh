// bulk_common.cuh — what the kernels share: the fit score of ops/fit.py,
// the bulk wave's grid cell, orderable float keys and top-2s, and
// block-wide reductions, scan and the bitonic key sort over NT = 1024
// threads.  Included by place_bulk.cu (K1, K4), place_scan.cu (K2, K3),
// sharded.cu (K7) and stage_probe.cu (K8); each source builds into its
// own library, so everything here has internal linkage.
//
// Numerics: compiled without fast math and with -fmad=false; powf (not
// __powf), so each score is the plain PyTorch versions' bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;          // threads in the block
constexpr int NW = NT / 32;       // warps in the block
constexpr int RES_CPU = 0;
constexpr int RES_MEM = 1;
constexpr unsigned long long NO_KEY = ~0ull;

__device__ __forceinline__ float free_frac(float cap, float use) {
  float frac = 1.0f - use / cap;
  if (cap <= 0.0f) frac = (use > 0.0f) ? -INFINITY : 1.0f;
  return frac;
}

// ops/fit.py score_fit: BestFit v3 (binpack) or worst fit (spread), in [0, 18]
// (a NaN stays NaN, as torch.clamp and jnp.clip keep it: fmaxf would
// make it 0)
__device__ __forceinline__ float score_fit(const float* cap, const float* u,
                                           int spread) {
  float total = powf(10.0f, free_frac(cap[RES_CPU], u[RES_CPU])) +
                powf(10.0f, free_frac(cap[RES_MEM], u[RES_MEM]));
  float raw = spread ? (total - 2.0f) : (20.0f - total);
  raw = raw < 0.0f ? 0.0f : raw;
  return raw > 18.0f ? 18.0f : raw;
}

constexpr int NRES = 4;           // resource dims (cpu, mem, disk, net)

// One row of a bulk wave: what bulk_wave_grid reads of it.
struct BulkRow {
  float cap[NRES];
  float used[NRES];
  float coll;    // co-placed instances so far (value-exact float)
  bool feas;
  bool pen;
  bool aff_on;
  float aff;
};

// One cell of ops/place.py bulk_wave_grid: the row's fit and score with m
// more instances placed on it.
__device__ __forceinline__ void grid_cell(const BulkRow& r, const float* dem,
                                          float m, float desired_div,
                                          int spread, bool* fits,
                                          float* score) {
  float u[NRES];
  bool f = r.feas;
#pragma unroll
  for (int d = 0; d < NRES; ++d) {
    float md = m * dem[d];
    u[d] = r.used[d] + md;
    f = f && (u[d] <= r.cap[d]);
  }
  float fit = score_fit(r.cap, u, spread) * (1.0f / 18.0f);
  // the reference's -(coll_m + 1) / div as XLA compiles it: (x - 1) + 1
  // folded to x, which differs once coll + m passes 2^24
  float coll_1 = r.coll + m;
  float coll_m = coll_1 - 1.0f;
  float total = fit;
  float n = 1.0f;
  float anti = -coll_1 / desired_div;
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

// float -> unsigned int whose unsigned order is the float order (XLA's
// total order: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN)
__device__ __forceinline__ unsigned int orderable(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the float of an orderable key, bits and all
__device__ __forceinline__ float from_orderable(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The row a packed (value-encoded) delta row lands on, as the
// reference's `used.at[rows].add(vals, mode="drop")` indexes it: JAX
// counts a row in [-n, 0) from the end; any other row outside [0, n)
// stays outside, for the caller to drop.  n is the usage matrix's rows.
__device__ __forceinline__ int wrap_delta_row(float packed, int n) {
  const int r = (int)packed;
  return (r < 0 && r >= -n) ? r + n : r;
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

// A thread's running top-2 (lax.top_k(x, 2) values: duplicates count)
// over orderable keys: lax.top_k's total order, where a NaN ranks by its
// sign (ops/place.py _lax_top_k).  Start from (0, 0), below
// every key but the lowest -NaN's, which equals it.
__device__ __forceinline__ void key_top2_push(unsigned& a, unsigned& b,
                                              unsigned k) {
  if (k >= a) { b = a; a = k; } else if (k > b) { b = k; }
}

__device__ __forceinline__ void warp_key_top2(unsigned& a, unsigned& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned oa = __shfl_xor_sync(0xffffffffu, a, o);
    const unsigned ob = __shfl_xor_sync(0xffffffffu, b, o);
    const unsigned na = max(a, oa);
    b = max(min(a, oa), max(b, ob));
    a = na;
  }
}

// Exclusive prefix sum over the block's threads; *total gets the sum;
// every thread returns its prefix.  The trailing barrier lets the
// scratch be reused by the next call.
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

// Ascending bitonic sort of p (a power of two) keys, in shared or global
// memory; the block's barriers order every pass.
__device__ void block_bitonic_sort(unsigned long long* keys, int p) {
  const int tid = threadIdx.x;
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
}

// smallest power of two >= n (and >= 2): the sort's length
__host__ __device__ __forceinline__ int sort_len(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace
