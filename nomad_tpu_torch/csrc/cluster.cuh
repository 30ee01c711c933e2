// cluster.cuh — what the thread-block-cluster kernels share: the launch
// of one cluster through cudaLaunchKernelEx, the cluster barrier in two
// halves, and the random delays that stand in for a race checker.
// Included by place_bulk.cu (K1, K4), place_scan.cu (K2, K3), sharded.cu
// (K7a, K7c) and stage_probe.cu (K8d, K8e, K8f); each source builds into its
// own library, so the delays' seed and switch are each library's own.
//
// The delays: compute-sanitizer's racecheck and synccheck do not run on
// every machine with the card, so a library's set_jitter(seed) entry
// turns on random delays of a few microseconds, per block and per warp,
// at each `jitter` site of its kernels: before every write of shared or
// distributed shared memory that another thread reads and after every
// barrier that orders such a read.  A missing barrier then shows as an
// output that differs from the plain version's.  The kernels are
// compiled with the sites and without them (template parameter J); a
// launch takes the delayed form only while a seed other than 0 is set,
// so the default path runs code without the sites.
#pragma once

#include <cuda_runtime.h>

namespace {

__constant__ unsigned c_jitter = 0u;   // the delays' seed (J kernels)
bool jitter_on = false;                // the seed is not 0

__device__ __forceinline__ unsigned mix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

// A delay from the seed, the site, the clock (in ~9 us steps), the block
// and the warp: a block sleeps ~16 us at one site in four, the same for
// all its threads (delays that differed per thread would even out at the
// block's next barrier and leave the blocks in step), so blocks run
// ahead of one another; each warp adds up to ~2 us of its own.
template <bool J>
__device__ __forceinline__ void jitter(unsigned site) {
  if constexpr (J) {
    const unsigned hb = mix32(c_jitter * 0x9E3779B9u ^
                              blockIdx.x * 0x85EBCA6Bu ^ site * 0x27D4EB2Fu ^
                              (unsigned)(clock64() >> 14));
    const unsigned hw = mix32(hb ^ (threadIdx.x >> 5) * 0xC2B2AE35u);
    __nanosleep(((hb & 3u) == 0u ? 16000u : 0u) + (hw & 2047u));
  }
}

// The delays' seed for the launches that follow on `stream` (0: the
// kernels without the delay sites).  A check's setting: no other host
// thread may launch the library's kernels meanwhile.
inline cudaError_t set_jitter(int seed, cudaStream_t stream) {
  const unsigned v = (unsigned)seed;
  jitter_on = v != 0u;
  cudaError_t err = cudaMemcpyToSymbolAsync(c_jitter, &v, sizeof(v), 0,
                                            cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return err;
  return cudaStreamSynchronize(stream);
}

// Barrier.cluster in two halves: every thread of the cluster arrives
// once (release) and waits (acquire), with work of its own in between.
// An arrive at a kernel's start and a wait before the first store into
// another block's shared memory say that every block has started; an
// arrive after a block's last read of another's shared memory and a wait
// before it exits say that no block exits while another reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One cluster of `blocks` blocks x `threads` threads.  The kernel's
// dynamic shared memory limit is set to `max_smem` before every launch
// (the same value every time, so concurrent launches from several host
// threads never see a smaller limit); clusters past 8 blocks need the
// non-portable size allowed.  Returns the launch's error, then
// cudaGetLastError().
template <class... ExpTypes, class... Args>
cudaError_t cluster_launch(void (*kernel)(ExpTypes...), int blocks,
                           int threads, size_t max_smem, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
  if (err != cudaSuccess) return err;
  if (blocks > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
