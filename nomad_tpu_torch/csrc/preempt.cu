// preempt.cu — greedy selection of preemption victims on every node at
// once (K6), for Hopper (sm_90a).
//
// Replaces: nomad_tpu/ops/preempt.py `preempt_for_task_group` (the jitted
// vmap over nodes of `_node_preempt`, a `lax.scan` of `max_steps` pick
// steps).  The plain PyTorch version is nomad_tpu_torch/ops/preempt.py
// `preempt_for_task_group_plain`; the two must agree bit for bit on all
// three outputs (met, picked, avail).
//
// Per node, per step (reference semantics, ops/preempt.py:36-69):
//   open  = valid & ~picked
//   tier  = open & (prio == min prio over open; INT32_MAX when none)
//   dist  = sqrt(sum_r coord_r^2), coord_r = (needed_r - res_r) /
//           max(needed_r, 1e-9) where needed_r > 0, else 0; 3.4e38 off
//           the tier
//   pick  = argmin(dist) over all A candidates: NaN first, then the
//           smallest value, the lowest index among equals (np.argmin,
//           jnp.argmin and torch.argmin); an in-tier +inf sorts above
//           an off-tier 3.4e38, so such a step picks an off-tier
//           candidate (picked or invalid), as the reference does
//   when the tier is non-empty and the node is not yet met: mark the
//   pick, avail += res[pick], needed -= res[pick]; met |= all(avail >=
//   ask).  `needed` starts at ask, `avail` at remaining, `met` at
//   all(remaining >= ask).
//
// What bounds it on this card: latency.  The bytes are N*A*(4R+5) +
// N*(8R+1): 6.3 MB at the scheduler path's 16,384 x 16 x 4, about 1.9 us
// at 3.35 TB/s, and the float work is a few MFLOP.  Each step depends on
// the previous one's pick, so a node's steps form a chain of reductions
// over its candidates; at the path's shape every node is met by its
// first pick, so a launch is mostly its loads and two step heads.  On
// longer chains the IEEE divisions of the distances are the largest
// part of a step (PERF.md §6, K6).
//
// Design:
//  - A node takes a segment of W lanes of one warp: for A <= 32, W is
//    the smallest power of two >= A (two nodes a warp at A = 16, four at
//    A = 8), candidate i on lane i of the segment; for A > 32, W = 32
//    and candidate i sits in slot i / 32 of lane i % 32 (SL slots, a
//    power of two, so A <= 1024).  Blocks of 256 threads, N * W threads
//    in all.
//  - The node's state is in registers: R (1..8) and SL are template
//    parameters, so needed, avail and ask are register arrays, held,
//    identical, by every lane of the segment.
//  - Records are loaded once, before the first step: each lane's
//    candidates' priorities, validity (a bit mask) and the resources of
//    its valid candidates (float4 loads where R is a multiple of 4).
//    Where SL * R > REG_FLOATS (A > 256 at R = 8, A > 512 at R = 4) the
//    resources stay in global memory and a step reads them there.
//  - A step computes its open candidates' distances first, so the
//    divisions overlap the tier's priority minimum, then drops the ones
//    off the tier.  The argmin is an orderable 32-bit key of each lane's
//    best distance (NaN 0, -0.0 as +0.0, the float order above): its
//    minimum over the node's lanes, then the lowest index holding it
//    (each lane's best is its lowest index with its least key, so the
//    pick is the lowest index among equal keys: the path's identical
//    fillers tie on every node).
//  - Every warp-wide operation takes the full mask.  A node on the whole
//    warp reduces with one redux.sync (the tier's priority, the key, the
//    index); a node on W < 32 lanes with a shuffle butterfly over its
//    lanes, and finds the pick's lane with one ballot, lane order being
//    index order there.  (A first form, with redux.sync over a mask of
//    the node's lanes, which differs between a warp's nodes, took
//    1.3-1.8x as long at A = 4 and 8: PERF.md §6, K6.)
//  - The picked candidate's resources come from its lane by shuffle
//    (an invalid one, picked only when every tier distance is +inf, is
//    read from global memory by its lane).
//  - A node stops at the first step that cannot pick (met, or no open
//    candidate): every later step of the reference is a no-op but the
//    first adds 0.0 to avail, which the kernel repeats (it turns a -0.0
//    into 0.0, as the plain version's `avail + freed` does).  All lanes
//    of a segment stop together; a warp loops until its last segment
//    stops, the stopped ones idle.
//  - The kernel uses no shared memory and no block barrier, only
//    warp-synchronous intrinsics, so the delay sites of cluster.cuh do
//    not apply to it.
//
// Numerics: compiled without fast math and with -fmad=false (IEEE '/',
// sqrtf, no fused multiply-add); the squares are summed in dimension
// order, c0*c0 + c1*c1 + ..., as the plain version writes them out.  A
// sum of 0 or +inf is its own root: sqrtf's slow path, which every pick
// among the path's identical fillers took, is skipped there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_R = 8;
constexpr int MAX_SL = 32;
constexpr int MAX_A = 32 * MAX_SL;
// resources kept in registers when a lane holds at most this many floats
constexpr int REG_FLOATS = 64;
constexpr int INT_MAX_ = 2147483647;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;   // above every distance's key

// The argmin's key: unsigned order is argmin's order, NaN first (key 0;
// every other key is at least 0x007fffff) and -0.0 equal to +0.0.
__device__ __forceinline__ unsigned dist_key(float d) {
  if (isnan(d)) return 0u;
  const unsigned u = __float_as_uint(d + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The minimum over a node's W lanes, the same on each of them, with the
// full mask on every lane (see the header on masks of a node's lanes).
template <typename T>
__device__ __forceinline__ T seg_min(T v, int W) {
  if (W == 32) return __reduce_min_sync(FULL, v);
  for (int off = W >> 1; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

template <int R>
__device__ __forceinline__ void load_res(const float* __restrict__ p,
                                         bool v4, float* out) {
  if constexpr (R % 4 == 0) {
    if (v4) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
        out[4 * q] = x.x;
        out[4 * q + 1] = x.y;
        out[4 * q + 2] = x.z;
        out[4 * q + 3] = x.w;
      }
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = __ldg(p + r);
}

// (NT, 1): with no minimum of blocks, ptxas held some instantiations to
// 64-128 registers and spilled 4-40 bytes; with it none spills.
template <int R, int SL>
__global__ void __launch_bounds__(NT, 1)
preempt_kernel(const float* __restrict__ cand_res,
               const int* __restrict__ cand_prio,
               const uint8_t* __restrict__ cand_valid,
               const float* __restrict__ remaining,
               const float* __restrict__ ask, int N, int A, int wlog,
               int max_steps, uint8_t* __restrict__ met_out,
               uint8_t* __restrict__ picked_out,
               float* __restrict__ avail_out) {
  constexpr bool REG = SL * R <= REG_FLOATS;
  const int W = 1 << wlog;
  const int lane = threadIdx.x & 31;
  const int sl = lane & (W - 1);          // the lane within its segment
  const int base = lane - sl;
  const unsigned seg = W == 32 ? FULL : ((1u << W) - 1u) << base;
  const int node = (int)(((long long)blockIdx.x * NT + threadIdx.x) >> wlog);
  // a segment past N idles, but its lanes take part in the warp's
  // shuffles and votes
  const bool live = node < N;
  const size_t c0 = (size_t)(live ? node : 0) * A;
  const bool v4 = (reinterpret_cast<uintptr_t>(cand_res) & 15u) == 0;

  int pr[SL];
  float rs[REG ? SL : 1][REG ? R : 1];
  unsigned valid = 0u;                    // bit j: slot j's candidate
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    const int i = sl + W * j;
    pr[j] = INT_MAX_;
    if constexpr (REG) {
#pragma unroll
      for (int r = 0; r < R; ++r) rs[j][r] = 0.0f;
    }
    if (live && i < A) {
      pr[j] = __ldg(cand_prio + c0 + i);
      if (__ldg(cand_valid + c0 + i)) {
        valid |= 1u << j;
        if constexpr (REG) load_res<R>(cand_res + (c0 + i) * R, v4, rs[j]);
      }
    }
  }
  float askv[R], need[R], avail[R];
  bool met = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    askv[r] = __ldg(ask + r);
    need[r] = askv[r];
    avail[r] = live ? __ldg(remaining + (size_t)node * R + r) : 0.0f;
    met = met && (avail[r] >= askv[r]);
  }
  bool run = live;
  unsigned picked = 0u;

  for (int step = 0; step < max_steps; ++step) {
    const unsigned open = valid & ~picked;
    int lp = INT_MAX_;
    // the open candidates' distances, while the tier's priority is
    // reduced (an off-tier one is dropped below)
    float dist[SL];
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      dist[j] = BIG;
      if (!((open >> j) & 1u)) continue;
      lp = min(lp, pr[j]);
      float x[R];
      if constexpr (REG) {
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] = rs[j][r];
      } else {
        load_res<R>(cand_res + (c0 + sl + W * j) * R, v4, x);
      }
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float nd = need[r];
        const float c = nd > 0.0f ? (nd - x[r]) / fmaxf(nd, 1e-9f) : 0.0f;
        acc = r == 0 ? c * c : acc + c * c;
      }
      // 0, +inf and NaN are their own roots (the key reads no NaN
      // payload), and would take sqrtf's slow path
      dist[j] = (acc > 0.0f && acc < INFINITY) ? sqrtf(acc) : acc;
    }
    // the tier is non-empty exactly when some candidate is open
    const bool any_open = (__ballot_sync(FULL, open != 0u) & seg) != 0u;
    if (run && (met || !any_open)) {
#pragma unroll
      for (int r = 0; r < R; ++r) avail[r] = avail[r] + 0.0f;
      run = false;
    }
    if (!__any_sync(FULL, run)) break;
    const int pmin = seg_min(lp, W);

    // this lane's least key, at its lowest index, and (REG) that
    // candidate's resources
    unsigned bk = NONE;
    int bj = 0;
    float bres[R];
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      if (sl + W * j >= A) continue;
      const bool tier = ((open >> j) & 1u) && pr[j] == pmin;
      const unsigned k = dist_key(tier ? dist[j] : BIG);
      if (k < bk) {
        bk = k;
        bj = j;
        if constexpr (REG) {
#pragma unroll
          for (int r = 0; r < R; ++r) bres[r] = rs[j][r];
        }
      }
    }
    const unsigned kmin = seg_min(bk, W);
    // the pick: the lowest index holding kmin.  Past 32 candidates a
    // lane's slots interleave with the others', so the index is reduced;
    // below, lane order is index order and the first such lane is it.
    int owner, pj;
    unsigned p;
    if (W == 32) {
      p = __reduce_min_sync(FULL, bk == kmin ? (unsigned)(sl + 32 * bj) : NONE);
      owner = (int)(p & 31u);
      pj = (int)(p >> 5);
    } else {
      owner = __ffs(__ballot_sync(FULL, bk == kmin) & seg) - 1;
      p = (unsigned)(owner - base);
      pj = 0;
    }

    // the pick's resources, from its lane (the owner's best is the
    // pick)
    if (lane == owner && live && !(REG && ((valid >> pj) & 1u)))
      load_res<R>(cand_res + (c0 + p) * R, v4, bres);
#pragma unroll
    for (int r = 0; r < R; ++r) bres[r] = __shfl_sync(FULL, bres[r], owner);
    if (run) {
      if (lane == owner) picked |= 1u << pj;
      bool now = true;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        avail[r] = avail[r] + bres[r];
        need[r] = need[r] - bres[r];
        now = now && (avail[r] >= askv[r]);
      }
      met = now;
    }
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    const int i = sl + W * j;
    if (i < A) picked_out[c0 + i] = (picked >> j) & 1u;
  }
  if (sl == 0) {
    met_out[node] = met;
#pragma unroll
    for (int r = 0; r < R; ++r) avail_out[(size_t)node * R + r] = avail[r];
  }
}

template <int R, int SL>
void launch(int blocks, cudaStream_t stream, const float* cand_res,
            const int* cand_prio, const uint8_t* cand_valid,
            const float* remaining, const float* ask, int N, int A, int wlog,
            int max_steps, uint8_t* met, uint8_t* picked, float* avail) {
  preempt_kernel<R, SL><<<blocks, NT, 0, stream>>>(
      cand_res, cand_prio, cand_valid, remaining, ask, N, A, wlog, max_steps,
      met, picked, avail);
}

template <int R>
void launch_r(int SL, int blocks, cudaStream_t stream, const float* cand_res,
              const int* cand_prio, const uint8_t* cand_valid,
              const float* remaining, const float* ask, int N, int A,
              int wlog, int max_steps, uint8_t* met, uint8_t* picked,
              float* avail) {
#define PREEMPT_SL(S)                                                       \
  case S:                                                                   \
    launch<R, S>(blocks, stream, cand_res, cand_prio, cand_valid,           \
                 remaining, ask, N, A, wlog, max_steps, met, picked, avail); \
    break;
  switch (SL) {
    PREEMPT_SL(1)
    PREEMPT_SL(2)
    PREEMPT_SL(4)
    PREEMPT_SL(8)
    PREEMPT_SL(16)
    PREEMPT_SL(32)
  }
#undef PREEMPT_SL
}

}  // namespace

extern "C" int preempt_launch(const float* cand_res, const int* cand_prio,
                              const uint8_t* cand_valid, const float* remaining,
                              const float* ask, int N, int A, int R,
                              int max_steps, uint8_t* met, uint8_t* picked,
                              float* avail, void* stream) {
  if (A < 1 || A > MAX_A || R < 1 || R > MAX_R || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  // lanes a node (2^wlog) and slots a lane
  int wlog = 0, SL = 1;
  if (A <= 32) {
    while ((1 << wlog) < A) ++wlog;
  } else {
    wlog = 5;
    while (32 * SL < A) SL *= 2;
  }
  const long long threads = (long long)N << wlog;
  const int blocks = (int)((threads + NT - 1) / NT);
  cudaStream_t s = (cudaStream_t)stream;
#define PREEMPT_R(RR)                                                        \
  case RR:                                                                   \
    launch_r<RR>(SL, blocks, s, cand_res, cand_prio, cand_valid, remaining,  \
                 ask, N, A, wlog, max_steps, met, picked, avail);            \
    break;
  switch (R) {
    PREEMPT_R(1)
    PREEMPT_R(2)
    PREEMPT_R(3)
    PREEMPT_R(4)
    PREEMPT_R(5)
    PREEMPT_R(6)
    PREEMPT_R(7)
    PREEMPT_R(8)
  }
#undef PREEMPT_R
  return (int)cudaGetLastError();
}
