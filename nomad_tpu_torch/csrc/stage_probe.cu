// stage_probe.cu — the stage probe's units (K8a-K8f) for Hopper (sm_90a).
//
// Replaces: nomad_tpu/parallel/stage_probe.py `_stage_fns` (:56: the
// jitted `feasibility` :65, `fit` :73, `score` :77, `argmax` :95 and
// `scatter` :109) and `probe_fused`'s `fused_wave` (:196, the wave grid
// of ops/place.py `bulk_wave_grid` + `bulk_run_lengths` + order +
// scatter in one program).  The plain PyTorch versions are
// nomad_tpu_torch/ops/stage_probe.py `*_plain`.
//
// These reproduce the probe, not production's wave: the probe has no
// strict set, and its scatter does not mask the run lengths by the wave
// set (`run[order]`), so rows outside the wave take instances after the
// wave rows, in row order (ROADMAP queue C).
//
// What bounds them on this card, at the bench's shape (N = 10,000, M =
// 16, R = 4): K8a-K8c are one thread per (row, m) cell, elementwise with
// an R-wide reduction, and bound by bytes (K8a writes the f32[N, M, R]
// grid, 2.6 MB; K8b reads it back).  K8d-K8f are one persistent block of
// 1024 threads, like K1 (csrc/place_bulk.cu): a top-2 reduction, a
// bitonic sort of N 64-bit keys in shared memory (global scratch past
// 16,384 rows) and a block scan are dependent block-wide steps, so they
// are bound by latency, not by the card's rates.
//
// Numerics: -fmad=false, powf, fit/18 as a multiply by the f32
// reciprocal 1.0f/18.0f (what XLA compiles the reference's division by
// that constant into), and every other division a true division, in the
// reference's order of operations.  The order is a stable argsort of
// where(wave, -cur, +inf): keys (orderable(key) << 32 | row), -0 folded
// into +0 as JAX's sort does.

#include "bulk_common.cuh"

namespace {

constexpr int R = 4;              // resource dims (cpu, mem, disk, net)

struct ProbeShared {
  float f[NW];
  float f2[NW];
  int i[NW];
};

// The score stack of one cell from its fit (the reference's `score`).
__device__ __forceinline__ float cell_score(float fit, int coll, float m,
                                            float desired_div, float pen,
                                            bool aff_on, float aff) {
  const float coll_m = ((float)coll + m) - 1.0f;
  float total = fit;
  float n_sc = 1.0f;
  const float anti = -(coll_m + 1.0f) / desired_div;
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

__device__ __forceinline__ unsigned long long order_key(bool wave, float cur,
                                                        int row) {
  const float k = wave ? (-cur + 0.0f) : INFINITY;
  return ((unsigned long long)orderable(k) << 32) | (unsigned int)row;
}

// K8a: util_m f32[N, M, R], fits_m bool[N, M]
__global__ void feasibility_kernel(const float* __restrict__ cap,
                                   const float* __restrict__ used,
                                   const float* __restrict__ demand,
                                   const uint8_t* __restrict__ feasible,
                                   const float* __restrict__ ms, int n, int M,
                                   float* __restrict__ util_m,
                                   uint8_t* __restrict__ fits_m) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)n * M) return;
  const int i = (int)(c / M), m = (int)(c % M);
  float dem[R], u[R];
#pragma unroll
  for (int d = 0; d < R; ++d) dem[d] = demand[d];
  const bool f = cell_util(cap + (size_t)i * R, used + (size_t)i * R, dem,
                           ms[m], u);
#pragma unroll
  for (int d = 0; d < R; ++d) util_m[c * R + d] = u[d];
  fits_m[c] = (f && feasible[i] != 0) ? 1 : 0;
}

// K8b: fit_m f32[N, M] = score_fit(cap, util_m, binpack) / 18
__global__ void fit_kernel(const float* __restrict__ cap,
                           const float* __restrict__ util_m, int n, int M,
                           float* __restrict__ fit_m) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)n * M) return;
  const int i = (int)(c / M);
  float u[R], cp[R];
#pragma unroll
  for (int d = 0; d < R; ++d) {
    u[d] = util_m[c * R + d];
    cp[d] = cap[(size_t)i * R + d];
  }
  fit_m[c] = score_fit(cp, u, 0) * (1.0f / 18.0f);
}

// K8c: score_m f32[N, M]
__global__ void score_kernel(const float* __restrict__ fit_m,
                             const int* __restrict__ coll,
                             const float* __restrict__ ms, float desired_f,
                             const float* __restrict__ penalty,
                             const float* __restrict__ affinity,
                             int has_affinity, int n, int M,
                             float* __restrict__ score_m) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)n * M) return;
  const int i = (int)(c / M), m = (int)(c % M);
  const float aff = affinity[i];
  const bool aff_on = has_affinity != 0 && aff != 0.0f;
  score_m[c] = cell_score(fit_m[c], coll[i], ms[m], fmaxf(desired_f, 1.0f),
                          penalty[i], aff_on, aff);
}

// K8d: run i32[N] (leading m's that fit and beat `second`, m = 1
// forced) and order i32[N] (stable argsort of where(wave, -cur, inf)).
// gkeys: past SMEM_SORT_ROWS the keys sort in that global scratch, all p
// of them.  Unlike K1/K4 the probe cannot sort only the wave rows: its
// order covers every row and its scatter gives instances to the rows
// outside the wave too.  The probe runs at the bench's unpadded n_nodes,
// so that path serves device_stages on a cluster of more than 16,384
// nodes; the bench's scenarios probe 10,000, and only the cuda test at
// 20,000 rows reaches it.  K8f sorts the same way.
__global__ void __launch_bounds__(NT, 1)
argmax_kernel(const uint8_t* __restrict__ fits_m,
              const float* __restrict__ score_m,
              const float* __restrict__ ms, int n, int M, int p,
              int* __restrict__ run, int* __restrict__ order,
              unsigned long long* gkeys) {
  extern __shared__ unsigned long long skeys[];  // p entries, or none
  __shared__ ProbeShared sh;
  unsigned long long* keys = gkeys ? gkeys : skeys;
  const int tid = threadIdx.x;

  float a = -INFINITY, b = -INFINITY;
  for (int i = tid; i < n; i += NT) {
    const size_t r0 = (size_t)i * M;
    top2_push(a, b, fits_m[r0] ? score_m[r0] : -INFINITY);
  }
  block_top2(a, b, sh.f, sh.f2);
  const float top1 = a, top2 = b;

  for (int i = tid; i < p; i += NT) {
    unsigned long long key = NO_KEY;
    if (i < n) {
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
      key = order_key(fits && cur == top1, cur, i);
    }
    keys[i] = key;
  }
  __syncthreads();
  block_bitonic_sort(keys, p);
  for (int k = tid; k < n; k += NT) order[k] = (int)(keys[k] & 0xFFFFFFFFull);
}

// The probe's scatter (shared by K8e and K8f): per_node[order[k]] =
// clip(count - exclusive_cumsum(run[order])[k], 0, run[order[k]]), then
// used2 = used + per_node * demand, coll2 = coll + per_node; returns the
// placed total in every thread.  per_node: i32[n] scratch.
__device__ int probe_scatter(const int* __restrict__ run,
                             const int* __restrict__ order, int count,
                             const float* __restrict__ used,
                             const float* __restrict__ demand,
                             const int* __restrict__ coll, int n,
                             float* __restrict__ used2,
                             int* __restrict__ coll2,
                             int* __restrict__ per_node, ProbeShared& sh) {
  const int tid = threadIdx.x;
  const int per = (n + NT - 1) / NT;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int local = 0;
  for (int k = lo; k < hi; ++k) local += run[order[k]];
  int total;
  int prefix = block_exclusive_scan(local, sh.i, &total);
  for (int k = lo; k < hi; ++k) {
    const int row = order[k];
    const int base = run[row];
    per_node[row] = min(max(count - prefix, 0), base);
    prefix += base;
  }
  __syncthreads();
  float dem[R];
#pragma unroll
  for (int d = 0; d < R; ++d) dem[d] = demand[d];
  int placed = 0;
  for (int i = tid; i < n; i += NT) {
    const int pn = per_node[i];
    const float pf = (float)pn;
#pragma unroll
    for (int d = 0; d < R; ++d) {
      const float inc = pf * dem[d];
      used2[(size_t)i * R + d] = used[(size_t)i * R + d] + inc;
    }
    coll2[i] = coll[i] + pn;
    placed += pn;
  }
  return block_sum(placed, sh.i);
}

// K8e: used2 f32[N, R], coll2 i32[N], placed i32
__global__ void __launch_bounds__(NT, 1)
scatter_kernel(const int* __restrict__ run, const int* __restrict__ order,
               int count, const float* __restrict__ used,
               const float* __restrict__ demand,
               const int* __restrict__ coll, int n,
               float* __restrict__ used2, int* __restrict__ coll2,
               int* __restrict__ placed, int* __restrict__ scratch) {
  __shared__ ProbeShared sh;
  const int total = probe_scatter(run, order, count, used, demand, coll, n,
                                  used2, coll2, scratch, sh);
  if (threadIdx.x == 0) *placed = total;
}

// K8f: the fused wave, K8a-K8e in one program without the [N, M] grid:
// each row's cells are evaluated on the fly.  scratch: i32[3n] (run,
// per_node, order).
__global__ void __launch_bounds__(NT, 1)
fused_wave_kernel(const float* __restrict__ cap,
                  const float* __restrict__ used,
                  const float* __restrict__ demand,
                  const uint8_t* __restrict__ feasible,
                  const float* __restrict__ affinity, int has_affinity,
                  float desired_f, const float* __restrict__ penalty,
                  const int* __restrict__ coll, int count, int M, int n,
                  int p, float* __restrict__ used2, int* __restrict__ coll2,
                  int* __restrict__ placed, int* __restrict__ scratch,
                  unsigned long long* gkeys) {
  extern __shared__ unsigned long long skeys[];  // p entries, or none
  __shared__ ProbeShared sh;
  unsigned long long* keys = gkeys ? gkeys : skeys;
  int* run = scratch;
  int* per_node = scratch + n;
  int* order = scratch + 2 * n;
  const int tid = threadIdx.x;
  const float desired_div = fmaxf(desired_f, 1.0f);
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
    *score = cell_score(fit, coll[i], m, desired_div, penalty[i],
                        has_affinity != 0 && aff != 0.0f, aff);
    return f;
  };

  float a = -INFINITY, b = -INFINITY;
  for (int i = tid; i < n; i += NT) {
    float s;
    const bool f = cell(i, 1.0f, &s);
    top2_push(a, b, f ? s : -INFINITY);
  }
  block_top2(a, b, sh.f, sh.f2);
  const float top1 = a, top2 = b;

  for (int i = tid; i < p; i += NT) {
    unsigned long long key = NO_KEY;
    if (i < n) {
      float s1;
      const bool fits = cell(i, 1.0f, &s1);
      const float cur = fits ? s1 : -INFINITY;
      const float second = (cur == top1) ? top2 : top1;
      int r = 0;
      for (int m = 1; m <= M; ++m) {
        float s = s1;
        const bool f = (m == 1) ? fits : cell(i, (float)m, &s);
        if (!(f && (s > second || m == 1))) break;
        r = m;
      }
      run[i] = r;
      key = order_key(fits && cur == top1, cur, i);
    }
    keys[i] = key;
  }
  __syncthreads();
  block_bitonic_sort(keys, p);
  for (int k = tid; k < n; k += NT) order[k] = (int)(keys[k] & 0xFFFFFFFFull);
  __syncthreads();
  const int total = probe_scatter(run, order, count, used, demand, coll, n,
                                  used2, coll2, per_node, sh);
  if (tid == 0) *placed = total;
}

int cells_grid(int n, int M) {
  return (int)(((long long)n * M + 255) / 256);
}

}  // namespace

extern "C" int feasibility_launch(const float* cap, const float* used,
                                  const float* demand, const uint8_t* feasible,
                                  const float* ms, int n, int M,
                                  float* util_m, uint8_t* fits_m,
                                  void* stream) {
  feasibility_kernel<<<cells_grid(n, M), 256, 0, (cudaStream_t)stream>>>(
      cap, used, demand, feasible, ms, n, M, util_m, fits_m);
  return (int)cudaGetLastError();
}

extern "C" int fit_launch(const float* cap, const float* util_m, int n, int M,
                          float* fit_m, void* stream) {
  fit_kernel<<<cells_grid(n, M), 256, 0, (cudaStream_t)stream>>>(
      cap, util_m, n, M, fit_m);
  return (int)cudaGetLastError();
}

extern "C" int score_launch(const float* fit_m, const int* coll,
                            const float* ms, float desired_f,
                            const float* penalty, const float* affinity,
                            int has_affinity, int n, int M, float* score_m,
                            void* stream) {
  score_kernel<<<cells_grid(n, M), 256, 0, (cudaStream_t)stream>>>(
      fit_m, coll, ms, desired_f, penalty, affinity, has_affinity, n, M,
      score_m);
  return (int)cudaGetLastError();
}

// gkeys: NULL for n <= SMEM_SORT_ROWS (the sort runs in shared memory),
// else a u64[sort_len(n)] global scratch
extern "C" int argmax_launch(const uint8_t* fits_m, const float* score_m,
                             const float* ms, int n, int M, int* run,
                             int* order, unsigned long long* gkeys,
                             void* stream) {
  if ((gkeys == nullptr) != (n <= SMEM_SORT_ROWS)) return (int)cudaErrorInvalidValue;
  const int p = sort_len(n);
  const size_t smem = gkeys ? 0 : (size_t)p * sizeof(unsigned long long);
  cudaError_t err = allow_smem_sort(argmax_kernel);
  if (err != cudaSuccess) return (int)err;
  argmax_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      fits_m, score_m, ms, n, M, p, run, order, gkeys);
  return (int)cudaGetLastError();
}

extern "C" int scatter_launch(const int* run, const int* order, int count,
                              const float* used, const float* demand,
                              const int* coll, int n, float* used2,
                              int* coll2, int* placed, int* scratch,
                              void* stream) {
  scatter_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      run, order, count, used, demand, coll, n, used2, coll2, placed,
      scratch);
  return (int)cudaGetLastError();
}

extern "C" int fused_wave_launch(const float* cap, const float* used,
                                 const float* demand, const uint8_t* feasible,
                                 const float* affinity, int has_affinity,
                                 float desired_f, const float* penalty,
                                 const int* coll, int count, int fill_grid,
                                 int n, float* used2, int* coll2, int* placed,
                                 int* scratch, unsigned long long* gkeys,
                                 void* stream) {
  if ((gkeys == nullptr) != (n <= SMEM_SORT_ROWS)) return (int)cudaErrorInvalidValue;
  const int p = sort_len(n);
  const size_t smem = gkeys ? 0 : (size_t)p * sizeof(unsigned long long);
  cudaError_t err = allow_smem_sort(fused_wave_kernel);
  if (err != cudaSuccess) return (int)err;
  fused_wave_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      cap, used, demand, feasible, affinity, has_affinity, desired_f,
      penalty, coll, count, fill_grid, n, p, used2, coll2, placed, scratch,
      gkeys);
  return (int)cudaGetLastError();
}
