// world_scatter.cu — segmented row scatters into the device-resident
// world (capacity and usage basis), for Hopper (sm_90a).
//
// Replaces: nomad_tpu/parallel/world.py `_single_device_fns`, the two
// jitted scatters of the unsharded world:
//   set_rows:  d.at[r].set(v, mode="drop")
//   add_rank1: d.at[r].add(c[:, None].f32 * dem, mode="drop")
// on a resident f32[N, 4] matrix; and (K5', with a row offset) the
// shard-local twins of nomad_tpu/parallel/sharded.py `_set_rows_local` /
// `_add_rank1_local` (serving_update_fns), where the matrix is one node
// shard's rows [off, off + n) and each global row index is translated by
// `off`.  The plain PyTorch versions are nomad_tpu_torch/parallel/world.py
// `set_rows_plain` / `add_rank1_plain` (and their `row_offset`), looped
// over the segments by `scatter_segments_plain`.  add_rank1 must equal
// the host twin (native.scatter_add_rank1: a separate f32 multiply, then
// an add) bit for bit: the world's host snapshot and device basis stay
// in lockstep only through that.
//
// A set segment may also carry the rows' old host values (`olds`): then
// d[r] = v + (d[r] - old), which keeps what the device holds beyond the
// host snapshot (a chained dispatch's placements still in flight) where
// a plain set would erase it, and equals the set where the device row
// is the snapshot's.  The reference sets these rows and loses them
// (ROADMAP queue C).
//
// What bounds it on this card: neither bytes nor operations.  A bucket
// of B rows moves B*16 bytes of values (plus B*4 of indices) in and
// B*16 out: 64 KB at the largest bucket (4096 rows), about 20 ns at
// 3.35 TB/s.  What a world update costs is the launch and the upload of
// its operands, a few microseconds each, and a blocking upload would
// also wait for every kernel already queued on the stream.
//
// Design: one launch does every scatter a world update makes on a card.
// A segment is one destination (capacity or basis, or one node shard
// of it) with its row offset, row count and its own operands; up to
// MAX_SEGS segments go to the kernel by value as one parameter struct
// (the host launcher fills it from an array of records), so the operands arrive in one staged buffer and one launch
// covers capacity, basis and every node shard on this card.  Grid: x over
// a segment's rows (one thread a row, neighbouring threads on
// neighbouring rows), y over the segments.  A row is 16 bytes, so a
// thread moves it with one float4 load and one float4 store (add_rank1:
// load, add, store); the wrapper checks that destinations and values
// are 16-byte aligned.  Pad rows and rows outside [off, off + n) drop,
// as mode="drop" does.  Row indices are unique within a destination
// (they come from np.nonzero / flatnonzero; the plain path asserts it)
// and segments of one launch never write one row twice, so no atomics.
// Updates are in place, ordered on the caller's stream.  Compiled with
// -fmad=false so add_rank1's multiply and add round separately, as
// numpy's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_SEGS = 32;   // parallel/world.py MAX_SEGMENTS
// int64 words of one host record: d, rows, vals, olds, counts, dem, B, n,
// off (a null pointer where the segment has no such operand)
constexpr int REC = 9;

struct Seg {
  float4* d;            // destination rows [off, off + n)
  const int* rows;      // i32[B] global row indices
  const float4* vals;   // set: f32[B, 4]
  const float4* olds;   // set, optional: f32[B, 4] old host values
  const int* counts;    // add: i32[B]
  const float* dem;     // add: f32[4]
  int B, n, off;
};

// the parameter struct: 2 KB, inside the 4 KB a kernel's parameters may
// take; a launch reads only its first `count` segments
struct Segs {
  Seg s[MAX_SEGS];
};

__global__ void set_rows_kernel(const __grid_constant__ Segs p) {
  const Seg& s = p.s[blockIdx.y];
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= s.B) return;
  const int r = s.rows[b] - s.off;
  if (r < 0 || r >= s.n) return;
  float4 v = s.vals[b];
  if (s.olds != nullptr) {
    const float4 d = s.d[r], o = s.olds[b];
    v.x = v.x + (d.x - o.x);
    v.y = v.y + (d.y - o.y);
    v.z = v.z + (d.z - o.z);
    v.w = v.w + (d.w - o.w);
  }
  s.d[r] = v;
}

__global__ void add_rank1_kernel(const __grid_constant__ Segs p) {
  const Seg& s = p.s[blockIdx.y];
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= s.B) return;
  const int r = s.rows[b] - s.off;
  if (r < 0 || r >= s.n) return;
  const float c = (float)s.counts[b];
  float4 v = s.d[r];
  v.x = v.x + c * s.dem[0];
  v.y = v.y + c * s.dem[1];
  v.z = v.z + c * s.dem[2];
  v.w = v.w + c * s.dem[3];
  s.d[r] = v;
}

// Fill the parameter struct from `count` (<= MAX_SEGS) host records;
// returns the largest B (0: nothing to launch).
int fill(const long long* recs, int count, Segs* p) {
  int maxB = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = recs + (size_t)i * REC;
    Seg& s = p->s[i];
    s.d = (float4*)(uintptr_t)r[0];
    s.rows = (const int*)(uintptr_t)r[1];
    s.vals = (const float4*)(uintptr_t)r[2];
    s.olds = (const float4*)(uintptr_t)r[3];
    s.counts = (const int*)(uintptr_t)r[4];
    s.dem = (const float*)(uintptr_t)r[5];
    s.B = (int)r[6];
    s.n = (int)r[7];
    s.off = (int)r[8];
    if (s.B > maxB) maxB = s.B;
  }
  return maxB;
}

int launch(bool add, const long long* recs, int count, void* stream) {
  if (count <= 0) return 0;
  if (count > MAX_SEGS) return (int)cudaErrorInvalidValue;
  Segs p;
  const int maxB = fill(recs, count, &p);
  if (maxB == 0) return 0;
  const dim3 grid((maxB + NT - 1) / NT, count);
  if (add)
    add_rank1_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(p);
  else
    set_rows_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// recs: `count` records of REC int64 words each (see fill); one launch
extern "C" int set_rows_launch(const long long* recs, int count,
                               void* stream) {
  return launch(false, recs, count, stream);
}

extern "C" int add_rank1_launch(const long long* recs, int count,
                                void* stream) {
  return launch(true, recs, count, stream);
}
