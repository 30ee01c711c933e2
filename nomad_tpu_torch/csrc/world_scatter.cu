// world_scatter.cu — row scatters into the device-resident usage basis,
// for Hopper (sm_90a).
//
// Replaces: nomad_tpu/parallel/world.py `_single_device_fns`, the two
// jitted scatters of the unsharded world:
//   set_rows:  d.at[r].set(v, mode="drop")
//   add_rank1: d.at[r].add(c[:, None].f32 * dem, mode="drop")
// on the resident f32[N, 4] matrix; and (K5', with a row offset) the
// shard-local twins of nomad_tpu/parallel/sharded.py `_set_rows_local` /
// `_add_rank1_local` (serving_update_fns), where the matrix is one node
// shard's rows [off, off + N) and each global row index is translated by
// `off`.  The plain PyTorch versions are nomad_tpu_torch/parallel/world.py
// `set_rows_plain` / `add_rank1_plain` (and their `row_offset`).
// add_rank1 must equal the host twin (native.scatter_add_rank1: a
// separate f32 multiply, then an add) bit for bit: the world's host
// snapshot and device basis stay in lockstep only through that.
//
// What bounds it on this card: bytes, and at these sizes the launch.
// A bucket of B rows moves B*16 bytes of values (plus B*4 of indices)
// in and B*16 out: 64 KB at the largest bucket (4096 rows), about 40
// ns at 3.35 TB/s, far below the few microseconds a launch costs.
//
// Design: one thread per (row, column) element, 256 threads a block.
// Row indices are unique (they come from np.nonzero / flatnonzero; the
// plain path asserts it), so no two threads write one element and no
// atomics are needed.  Pad rows (index N, or anything outside [0, N))
// are dropped, as mode="drop" does; on a shard, rows outside it drop.  Updates are in place: the caller
// owns the buffer and every use of it is ordered on one stream.
// Compiled with -fmad=false so add_rank1's multiply and add round
// separately, as numpy's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 4;
constexpr int NT = 256;

__global__ void set_rows_kernel(float* __restrict__ d,
                                const int* __restrict__ rows,
                                const float* __restrict__ vals, int B, int N,
                                int off) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= B * R) return;
  const int b = idx / R, c = idx % R;
  const int r = rows[b] - off;
  if (r < 0 || r >= N) return;
  d[(size_t)r * R + c] = vals[idx];
}

__global__ void add_rank1_kernel(float* __restrict__ d,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ counts,
                                 const float* __restrict__ dem, int B, int N,
                                 int off) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= B * R) return;
  const int b = idx / R, c = idx % R;
  const int r = rows[b] - off;
  if (r < 0 || r >= N) return;
  const float inc = (float)counts[b] * dem[c];
  d[(size_t)r * R + c] = d[(size_t)r * R + c] + inc;
}

}  // namespace

// N: the rows `d` holds; off: the global row of its first (0 unsharded)
extern "C" int set_rows_launch(float* d, const int* rows, const float* vals,
                               int B, int N, int off, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B * R + NT - 1) / NT;
  set_rows_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(d, rows, vals, B, N,
                                                           off);
  return (int)cudaGetLastError();
}

extern "C" int add_rank1_launch(float* d, const int* rows, const int* counts,
                                const float* dem, int B, int N, int off,
                                void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B * R + NT - 1) / NT;
  add_rank1_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(d, rows, counts,
                                                            dem, B, N, off);
  return (int)cudaGetLastError();
}
