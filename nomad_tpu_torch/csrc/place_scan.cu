// place_scan.cu — sequential placement scan over the slots of one
// evaluation, for Hopper (sm_90a).
//
// Replaces: nomad_tpu/ops/place.py `place_eval_packed_jit` (and, with the
// unpacked wrapper, `place_eval_jit`): the `lax.scan` of `_place_step`
// with `_spread_boost` and `_pack_outputs`.  The plain PyTorch version is
// nomad_tpu_torch/ops/place.py `place_eval_plain`; the two must agree
// exactly on every integer output.
//
// What bounds it on this card: latency, not bytes.  Each slot step reads
// the group's node fields (~44 bytes a node, ~0.7 MB at 16K nodes) and
// must finish its argmax before the next step can start, because the
// carry (used, tg_count, place_cap, spread counts) changes at the row it
// picks.  S steps are S dependent block-wide reductions.
//
// Design: ONE block of 1024 threads loops the S slots inside the kernel.
// Per step, the threads first compute each active spread's min/max over
// placed values (K tiny reductions), then each thread scores its nodes
// (rows t, t+1024, ...) through the full scoring stack and keeps its own
// top-5 list; a shared-memory tree merges the lists into the block's
// top-5, ordered like `lax.top_k` (descending, lower row first on ties,
// -inf rows included).  Its head is the argmax (lowest row among equal
// maxima).  Thread 0 then updates one row of used, tg_count and
// place_cap and K entries of the spread counts.  Inactive (padding)
// slots write their fixed output without scoring.
//
// Numerics: compiled without fast math and with -fmad=false; powf (not
// __powf); the reference's operation order (fit/18 as a multiply by the
// f32 reciprocal, as XLA compiles it; -(coll+1)/max(desired,1);
// total/n_scorers).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
constexpr int NW = NT / 32;
constexpr int R = 4;
constexpr int RES_CPU = 0;
constexpr int RES_MEM = 1;
constexpr int TOPK = 5;
constexpr int OUTW = 5 + 2 * TOPK;
constexpr int MAXK = 64;
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ float free_frac(float cap, float use) {
  float frac = 1.0f - use / cap;
  if (cap <= 0.0f) frac = (use > 0.0f) ? -INFINITY : 1.0f;
  return frac;
}

__device__ __forceinline__ float score_fit(const float* cap, const float* u,
                                           int spread) {
  float total = powf(10.0f, free_frac(cap[RES_CPU], u[RES_CPU])) +
                powf(10.0f, free_frac(cap[RES_MEM], u[RES_MEM]));
  float raw = spread ? (total - 2.0f) : (20.0f - total);
  return fminf(fmaxf(raw, 0.0f), 18.0f);
}

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
  for (int k = 0; k < TOPK; ++k) { t.v[k] = -INFINITY; t.i[k] = 0x7fffffff; }
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

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT, 1)
place_scan_kernel(const float* __restrict__ capacity,
                  const float* __restrict__ used0,
                  const uint8_t* __restrict__ feasible,
                  const float* __restrict__ affinity,
                  const uint8_t* __restrict__ has_affinity,
                  const int* __restrict__ desired_count,
                  const uint8_t* __restrict__ penalty,
                  const int* __restrict__ tg_count0,
                  const int* __restrict__ spread_vidx,
                  const float* __restrict__ spread_desired,
                  const uint8_t* __restrict__ spread_targeted,
                  const float* __restrict__ spread_wfrac,
                  const float* __restrict__ spread_counts0,
                  const uint8_t* __restrict__ spread_active,
                  const int* __restrict__ place_cap0,
                  const float* __restrict__ demand,
                  const int* __restrict__ slot_tg,
                  const uint8_t* __restrict__ slot_active,
                  int G, int N, int K, int V1, int S, int spread_alg,
                  float* __restrict__ out, float* __restrict__ used,
                  int* __restrict__ tg_count, int* __restrict__ place_cap,
                  float* __restrict__ counts) {
  __shared__ float tv[NT][TOPK];
  __shared__ int ti[NT][TOPK];
  __shared__ int sh_a[NW], sh_b[NW];
  __shared__ float s_minc[MAXK], s_maxc[MAXK], s_wfrac[MAXK];
  __shared__ uint8_t s_anyp[MAXK], s_active[MAXK], s_targeted[MAXK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = V1 - 1;   // value slot V = "missing attribute"

  // carries start from the inputs
  for (int i = tid; i < N * R; i += NT) used[i] = used0[i];
  for (int i = tid; i < G * N; i += NT) {
    tg_count[i] = tg_count0[i];
    place_cap[i] = place_cap0[i];
  }
  for (int i = tid; i < G * K * V1; i += NT) counts[i] = spread_counts0[i];
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    float* o = out + (size_t)s * OUTW;
    if (!slot_active[s]) {
      // nothing fits an inactive slot: every row scores -inf
      if (tid == 0) {
        o[0] = -1.0f; o[1] = 0.0f; o[2] = 0.0f; o[3] = 0.0f; o[4] = 0.0f;
        for (int k = 0; k < TOPK; ++k) {
          o[5 + k] = (float)k;
          o[5 + TOPK + k] = -INFINITY;
        }
      }
      continue;
    }
    const int g = slot_tg[s];
    float dem[R];
#pragma unroll
    for (int d = 0; d < R; ++d) dem[d] = demand[s * R + d];

    // -- per-spread statistics of group g: min/max over placed values
    if (tid < K) {
      const int gk = g * K + tid;
      const float* c = counts + (size_t)gk * V1;
      float mn = BIG, mx = -BIG;
      bool anyp = false;
      for (int v = 0; v < V; ++v) {
        const float x = c[v];
        const bool placed = x > 0.0f;
        anyp = anyp || placed;
        mn = fminf(mn, placed ? x : BIG);
        mx = fmaxf(mx, placed ? x : -BIG);
      }
      s_minc[tid] = mn;
      s_maxc[tid] = mx;
      s_anyp[tid] = anyp;
      s_active[tid] = spread_active[gk];
      s_targeted[tid] = spread_targeted[gk];
      s_wfrac[tid] = spread_wfrac[gk];
    }
    __syncthreads();
    bool any_active = false;
    for (int k = 0; k < K; ++k) any_active = any_active || s_active[k];

    const bool has_aff = has_affinity[g] != 0;
    const float desired_div = fmaxf((float)desired_count[g], 1.0f);

    Top top;
    top_init(top);
    int n_eval = 0, n_exh = 0;
    for (int i = tid; i < N; i += NT) {
      const size_t gi = (size_t)g * N + i;
      const bool feas = feasible[gi] && place_cap[gi] != 0;
      float cap[R], u[R];
      bool fits = feas;
#pragma unroll
      for (int d = 0; d < R; ++d) {
        cap[d] = capacity[i * R + d];
        u[d] = used[i * R + d] + dem[d];
        fits = fits && (u[d] <= cap[d]);
      }
      const float fit = score_fit(cap, u, spread_alg) * (1.0f / 18.0f);
      float total = fit;
      float n = 1.0f;

      const float coll = (float)tg_count[gi];
      const float anti = -(coll + 1.0f) / desired_div;
      const bool hc = coll > 0.0f;
      total = total + (hc ? anti : 0.0f);
      n = n + (hc ? 1.0f : 0.0f);

      const bool pen = penalty[gi] != 0;
      total = total - (pen ? 1.0f : 0.0f);
      n = n + (pen ? 1.0f : 0.0f);

      const float aff = affinity[gi];
      const bool aff_on = has_aff && (aff != 0.0f);
      total = total + (aff_on ? aff : 0.0f);
      n = n + (aff_on ? 1.0f : 0.0f);

      float sboost = 0.0f;
      for (int k = 0; k < K; ++k) {
        const int gk = g * K + k;
        const int v = spread_vidx[(size_t)gk * N + i];
        const bool missing = v >= V;
        const int safe = min(v, V);
        const float cur = counts[(size_t)gk * V1 + safe];
        const float des = spread_desired[(size_t)gk * V1 + safe];
        // targeted spread: ((desired - (used+1)) / desired) * weight_frac
        float t = -1.0f;
        if (!missing && des >= 0.0f)
          t = ((des - (cur + 1.0f)) / fmaxf(des, 1e-9f)) * s_wfrac[k];
        // even spread: delta vs min/max of placed values
        const float mn = s_minc[k], mx = s_maxc[k];
        const float mn_ = fmaxf(mn, 1e-9f);
        float e;
        if (cur != mn) e = (mn - cur) / mn_;
        else e = (mn == mx) ? -1.0f : (mx - mn) / mn_;
        if (missing) e = -1.0f;
        if (!s_anyp[k]) e = 0.0f;
        const float boost = s_targeted[k] ? t : e;
        sboost = sboost + (s_active[k] ? boost : 0.0f);
      }
      const bool sb_on = any_active && (sboost != 0.0f);
      total = total + (sb_on ? sboost : 0.0f);
      n = n + (sb_on ? 1.0f : 0.0f);

      const float masked = fits ? total / n : -INFINITY;
      top_insert(top, masked, i);
      n_eval += feas ? 1 : 0;
      n_exh += (feas && !fits) ? 1 : 0;
    }

    // -- block top-5 (its head is the argmax) and the two counts
#pragma unroll
    for (int k = 0; k < TOPK; ++k) { tv[tid][k] = top.v[k]; ti[tid][k] = top.i[k]; }
    n_eval = warp_sum(n_eval);
    n_exh = warp_sum(n_exh);
    if (lane == 0) { sh_a[warp] = n_eval; sh_b[warp] = n_exh; }
    __syncthreads();
    for (int stride = NT / 2; stride > 0; stride >>= 1) {
      if (tid < stride) {
        float av[TOPK], bv[TOPK], rv[TOPK];
        int ai[TOPK], bi[TOPK], ri[TOPK];
#pragma unroll
        for (int k = 0; k < TOPK; ++k) {
          av[k] = tv[tid][k]; ai[k] = ti[tid][k];
          bv[k] = tv[tid + stride][k]; bi[k] = ti[tid + stride][k];
        }
        int x = 0, y = 0;
#pragma unroll
        for (int k = 0; k < TOPK; ++k) {
          if (before(bv[y], bi[y], av[x], ai[x])) { rv[k] = bv[y]; ri[k] = bi[y]; ++y; }
          else { rv[k] = av[x]; ri[k] = ai[x]; ++x; }
        }
#pragma unroll
        for (int k = 0; k < TOPK; ++k) { tv[tid][k] = rv[k]; ti[tid][k] = ri[k]; }
      }
      __syncthreads();
    }

    if (tid == 0) {
      int ne = 0, nx = 0;
      for (int w = 0; w < NW; ++w) { ne += sh_a[w]; nx += sh_b[w]; }
      const int sel = ti[0][0];
      const float best = tv[0][0];
      const bool ok = best > -INFINITY;
      float fit_sel = 0.0f;
      if (ok) {
        float cap[R], u[R];
        for (int d = 0; d < R; ++d) {
          cap[d] = capacity[sel * R + d];
          u[d] = used[sel * R + d] + dem[d];
        }
        fit_sel = score_fit(cap, u, spread_alg) * (1.0f / 18.0f);
        // carry updates at the picked row
        for (int d = 0; d < R; ++d) used[sel * R + d] = used[sel * R + d] + dem[d];
        const size_t gs = (size_t)g * N + sel;
        tg_count[gs] += 1;
        if (place_cap[gs] > 0) place_cap[gs] -= 1;
        for (int k = 0; k < K; ++k) {
          const int gk = g * K + k;
          const int v = spread_vidx[(size_t)gk * N + sel];
          if (s_active[k] && v < V1 - 1) counts[(size_t)gk * V1 + v] += 1.0f;
        }
      }
      o[0] = ok ? (float)sel : -1.0f;
      o[1] = ok ? best : 0.0f;
      o[2] = fit_sel;
      o[3] = (float)ne;
      o[4] = (float)nx;
      for (int k = 0; k < TOPK; ++k) {
        o[5 + k] = (float)ti[0][k];
        o[5 + TOPK + k] = tv[0][k];
      }
    }
    __syncthreads();
  }
}

}  // namespace

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
    float* counts, void* stream) {
  if (K < 1 || K > MAXK || N < TOPK || V1 < 1) return (int)cudaErrorInvalidValue;
  place_scan_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      capacity, used0, feasible, affinity, has_affinity, desired_count,
      penalty, tg_count0, spread_vidx, spread_desired, spread_targeted,
      spread_wfrac, spread_counts0, spread_active, place_cap0, demand,
      slot_tg, slot_active, G, N, K, V1, S, spread_alg, out, used, tg_count,
      place_cap, counts);
  return (int)cudaGetLastError();
}
