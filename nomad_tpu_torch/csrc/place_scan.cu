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
// and `place_batch_packed_plain`; they must agree exactly on every
// integer output.
//
// What bounds it on this card: latency, not bytes.  Each slot step reads
// the group's node fields (~44 bytes a node, ~0.7 MB at 16K nodes) and
// must finish its argmax before the next step can start, because the
// carry (used, tg_count, place_cap, spread counts) changes at the row it
// picks.  S steps are S dependent block-wide reductions; K3's E evals
// are E*S of them, since the usage carry passes from eval to eval.
//
// Design: ONE block of 1024 threads loops the S slots inside the kernel
// (K3's block also loops the E evals: one launch a chain).  Per step,
// the threads first compute each active spread's min/max over placed
// values (K tiny reductions), then each thread scores its nodes (rows
// t, t+1024, ...) through the full scoring stack and keeps its own
// top-5 list; a shared-memory tree merges the lists into the block's
// top-5, ordered like `lax.top_k` (descending, lower row first on ties,
// -inf rows included).  Its head is the argmax (lowest row among equal
// maxima).  Thread 0 then updates one row of used, tg_count and
// place_cap and K entries of the spread counts.  Inactive (padding)
// slots write their fixed output without scoring.  The field reads go
// through an accessor (K2: typed arrays; K3: the packed f32 blocks,
// integers value-encoded, booleans > 0.5), so both kernels run one body.
// K3 adds each eval's deltas into the usage carry (in order, by thread
// 0, rows outside [0, N) dropped) before its slots, and keeps them: the
// reference's chain carries them on to later evals.
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

struct ScanShared {
  float tv[NT][TOPK];
  int ti[NT][TOPK];
  int a[NW], b[NW];
  float minc[MAXK], maxc[MAXK], wfrac[MAXK];
  uint8_t anyp[MAXK], active[MAXK], targeted[MAXK];
};

// One eval's slot scan.  `used` (f32[N, R]) is the usage carry, updated
// in place; tg_count/place_cap (i32[G, N]) and counts (f32[G, K, V1]) are
// scratch the body fills from the eval's fields first.  out: f32[S, OUTW].
template <class Src>
__device__ void scan_eval(const float* __restrict__ capacity,
                          float* __restrict__ used, const Src& f, int G,
                          int N, int K, int V1, int S, int spread_alg,
                          float* __restrict__ out, int* __restrict__ tg_count,
                          int* __restrict__ place_cap,
                          float* __restrict__ counts, ScanShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = V1 - 1;   // value slot V = "missing attribute"

  for (int i = tid; i < G * N; i += NT) {
    tg_count[i] = f.tg0(i);
    place_cap[i] = f.cap0(i);
  }
  for (int i = tid; i < G * K * V1; i += NT) counts[i] = f.counts0(i);
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    float* o = out + (size_t)s * OUTW;
    if (!f.sact(s)) {
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
    const int g = f.stg(s);
    float dem[R];
#pragma unroll
    for (int d = 0; d < R; ++d) dem[d] = f.dem(s, d);

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
      sh.minc[tid] = mn;
      sh.maxc[tid] = mx;
      sh.anyp[tid] = anyp;
      sh.active[tid] = f.active(gk);
      sh.targeted[tid] = f.targeted(gk);
      sh.wfrac[tid] = f.wfrac(gk);
    }
    __syncthreads();
    bool any_active = false;
    for (int k = 0; k < K; ++k) any_active = any_active || sh.active[k];

    const bool has_aff = f.has_aff(g);
    const float desired_div = fmaxf((float)f.desired(g), 1.0f);

    Top top;
    top_init(top);
    int n_eval = 0, n_exh = 0;
    for (int i = tid; i < N; i += NT) {
      const size_t gi = (size_t)g * N + i;
      const bool feas = f.feas(gi) && place_cap[gi] != 0;
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

      const bool pen = f.pen(gi);
      total = total - (pen ? 1.0f : 0.0f);
      n = n + (pen ? 1.0f : 0.0f);

      const float aff = f.aff(gi);
      const bool aff_on = has_aff && (aff != 0.0f);
      total = total + (aff_on ? aff : 0.0f);
      n = n + (aff_on ? 1.0f : 0.0f);

      float sboost = 0.0f;
      for (int k = 0; k < K; ++k) {
        const int gk = g * K + k;
        const int v = f.vidx((size_t)gk * N + i);
        const bool missing = v >= V;
        const int safe = min(v, V);
        const float cur = counts[(size_t)gk * V1 + safe];
        const float des = f.sdes((size_t)gk * V1 + safe);
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
      n = n + (sb_on ? 1.0f : 0.0f);

      const float masked = fits ? total / n : -INFINITY;
      top_insert(top, masked, i);
      n_eval += feas ? 1 : 0;
      n_exh += (feas && !fits) ? 1 : 0;
    }

    // -- block top-5 (its head is the argmax) and the two counts
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
      const int sel = sh.ti[0][0];
      const float best = sh.tv[0][0];
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
          const int v = f.vidx((size_t)gk * N + sel);
          if (sh.active[k] && v < V1 - 1) counts[(size_t)gk * V1 + v] += 1.0f;
        }
      }
      o[0] = ok ? (float)sel : -1.0f;
      o[1] = ok ? best : 0.0f;
      o[2] = fit_sel;
      o[3] = (float)ne;
      o[4] = (float)nx;
      for (int k = 0; k < TOPK; ++k) {
        o[5 + k] = (float)sh.ti[0][k];
        o[5 + TOPK + k] = sh.tv[0][k];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT, 1)
place_scan_kernel(const float* __restrict__ capacity,
                  const float* __restrict__ used0, K2Src src, int G, int N,
                  int K, int V1, int S, int spread_alg,
                  float* __restrict__ out, float* __restrict__ used,
                  int* __restrict__ tg_count, int* __restrict__ place_cap,
                  float* __restrict__ counts) {
  __shared__ ScanShared sh;
  for (int i = threadIdx.x; i < N * R; i += NT) used[i] = used0[i];
  __syncthreads();
  scan_eval(capacity, used, src, G, N, K, V1, S, spread_alg, out, tg_count,
            place_cap, counts, sh);
}

// K3: E chained evals.  heavy f32[E, Lh], dyn f32[E * Ll]; `used` is the
// usage carry (starts as used0, ends as the chain's final usage).
__global__ void __launch_bounds__(NT, 1)
place_batch_kernel(const float* __restrict__ capacity,
                   const float* __restrict__ used0,
                   const float* __restrict__ heavy,
                   const float* __restrict__ dyn, int E, int G, int N, int K,
                   int V1, int S, int D, int spread_alg,
                   float* __restrict__ out, float* __restrict__ used,
                   int* __restrict__ tg_count, int* __restrict__ place_cap,
                   float* __restrict__ counts) {
  __shared__ ScanShared sh;
  const size_t GN = (size_t)G * N, GKN = (size_t)G * K * N,
               GKV = (size_t)G * K * V1;
  const size_t Lh = 5 * GN + GKN + 2 * GKV + 2 * (size_t)G + 3 * (size_t)G * K;
  const size_t Ll = (size_t)S * (R + 2) + (size_t)D * (R + 1);
  for (int i = threadIdx.x; i < N * R; i += NT) used[i] = used0[i];
  __syncthreads();
  for (int e = 0; e < E; ++e) {
    const float* l = dyn + e * Ll;
    // this eval's deltas go into the carry, and stay there
    if (threadIdx.x == 0) {
      const float* rows = l + (size_t)S * (R + 2);
      const float* vals = rows + D;
      for (int k = 0; k < D; ++k) {
        const int r = (int)rows[k];
        if (r < 0 || r >= N) continue;
        for (int d = 0; d < R; ++d) used[r * R + d] = used[r * R + d] + vals[k * R + d];
      }
    }
    __syncthreads();
    const K3Src src{heavy + e * Lh, l, GN, GKN, GKV, G, G * K, S};
    scan_eval(capacity, used, src, G, N, K, V1, S, spread_alg,
              out + (size_t)e * S * OUTW, tg_count, place_cap, counts, sh);
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
  const K2Src src{feasible, affinity, has_affinity, desired_count, penalty,
                  tg_count0, spread_vidx, spread_desired, spread_targeted,
                  spread_wfrac, spread_counts0, spread_active, place_cap0,
                  demand, slot_tg, slot_active};
  place_scan_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      capacity, used0, src, G, N, K, V1, S, spread_alg, out, used, tg_count,
      place_cap, counts);
  return (int)cudaGetLastError();
}

extern "C" int place_batch_launch(const float* capacity, const float* used0,
                                  const float* heavy, const float* dyn, int E,
                                  int G, int N, int K, int V1, int S, int D,
                                  int spread_alg, float* out, float* used,
                                  int* tg_count, int* place_cap, float* counts,
                                  void* stream) {
  if (K < 1 || K > MAXK || N < TOPK || V1 < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  place_batch_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      capacity, used0, heavy, dyn, E, G, N, K, V1, S, D, spread_alg, out,
      used, tg_count, place_cap, counts);
  return (int)cudaGetLastError();
}
