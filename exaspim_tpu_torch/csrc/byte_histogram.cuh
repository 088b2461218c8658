// The histogram core shared by the two entries of byte_histogram.cu: a
// block counts bytes into shared-memory counters, takes per-bin totals, and
// a thread-block cluster sums its blocks' totals through distributed shared
// memory and writes f32 counts straight to the output. One launch, no
// memset, no conversion kernel, no global atomics.
//
// The counters, chosen by measurement on an H100 (PERF.md, Findings). Hopper's
// shared atomic add merges a warp's adds to one address; what it
// serialises is distinct addresses in one bank. So the skew of the proxy's
// planes (the hi plane of a z-delta of noisy counts is almost all 0x00 and
// 0xFF, the lo plane within about +-20 of 0) is cheap, and uniform bytes
// are the slow case. Each entry fixes its layout at compile time:
//   LANES        a column of 32-bit counters per lane, word (bin << 5) |
//                lane: a warp's 32 adds fall on 32 banks whatever the bytes
//                are (32 KB a histogram; the per-bin total reads a bin's 32
//                columns rotated by the bin, 32 banks a warp again). Its
//                time does not depend on the data, so the row entry, which
//                takes any bytes, uses it.
//   WARP_COPIES  one 256-bin copy per warp (8 KB): fastest on skewed bytes,
//                slowest on uniform ones. The chunk entry, which only ever
//                counts z-delta planes, uses it.
//
// Integer sums are exact and order-free, so either layout, every cluster
// size and every launch give the same counts; the f32 output is exact for
// counts below 2^24 (a 64^3 plane has 2^18).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace bhist {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int LANE_WORDS = 256 * 32;  // one histogram's counters (LANES)

enum Counters : int { LANES, WARP_COPIES };

// Shared 32-bit words a histogram's counters take in layout S.
__host__ __device__ constexpr int counter_words(int s) {
  return s == LANES ? LANE_WORDS : WARPS * 256;
}

// Dynamic shared memory of a block with NH histograms: counters, then
// NH * 256 per-bin totals.
__host__ __device__ constexpr size_t smem_bytes(int s, int nh) {
  return (size_t)nh * (counter_words(s) + 256) * sizeof(uint32_t);
}

template <int S>
__device__ __forceinline__ void zero(uint32_t* h) {
  for (int i = threadIdx.x; i < counter_words(S); i += THREADS) h[i] = 0;
}

// Count one byte value ``bin`` (0..255).
template <int S>
__device__ __forceinline__ void add(uint32_t* h, uint32_t bin) {
  if (S == LANES)
    atomicAdd(&h[(bin << 5) | (threadIdx.x & 31u)], 1u);
  else
    atomicAdd(&h[((threadIdx.x >> 5) << 8) | bin], 1u);
}

// The four bytes of a little-endian word, lowest address first.
template <int S>
__device__ __forceinline__ void add_word(uint32_t* h, uint32_t w) {
  add<S>(h, w & 0xFFu);
  add<S>(h, (w >> 8) & 0xFFu);
  add<S>(h, (w >> 16) & 0xFFu);
  add<S>(h, w >> 24);
}

// The block's total for ``bin``, from counters no thread adds to any more.
template <int S>
__device__ __forceinline__ uint32_t bin_total(const uint32_t* h, int bin) {
  uint32_t s = 0;
  if (S == LANES) {
#pragma unroll
    for (int l = 0; l < 32; ++l) s += h[(bin << 5) | ((l + bin) & 31)];
  } else {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += h[(w << 8) | bin];
  }
  return s;
}

// Every block of the cluster holds its totals of NH histograms in
// ``part`` (NH * 256 words of its own shared memory). Block r of a cluster
// of cs (a power of two <= 8) sums bins [r * NH * 256 / cs, ...) over the
// cluster's blocks, rank 0 first, and writes them as f32 to ``out``
// (NH * 256 floats). The second cluster barrier keeps every block's shared
// memory alive until the others have read it.
template <int NH>
__device__ __forceinline__ void cluster_write(const uint32_t* part,
                                              float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  cluster.sync();
  const int per = NH * 256 / cs;
  for (int i = threadIdx.x; i < per; i += THREADS) {
    const int bin = r * per + i;
    uint32_t s = 0;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)  // the remote loads issued together
      if (q < cs)
        s += cluster.map_shared_rank(const_cast<uint32_t*>(part), q)[bin];
    out[bin] = __uint2float_rn(s);
  }
  cluster.sync();
}

// Clusters of at most the portable size, a power of two, so that the bins
// split evenly over the blocks.
inline int pow2_at_most(long long n) {
  int cs = 1;
  while (cs < MAX_CLUSTER && 2LL * cs <= n) cs *= 2;
  return cs;
}

// Launch ``kernel`` on ``blocks`` blocks in clusters of ``cs`` with
// ``smem`` bytes of dynamic shared memory; returns the launch's error.
template <typename... Args, typename... Act>
cudaError_t launch(void (*kernel)(Args...), long long blocks, int cs,
                   size_t smem, cudaStream_t stream, Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace bhist
