// 256-bin histograms of uint8 rows: counts[r, v] = #{i : data[r, i] == v}.
//
// Replaces exaspim_tpu/compression/proxy.py:_histogram_pallas_call (the
// Pallas TPU kernel behind byte_histogram, body at :76). The TPU kernel
// avoids scatter (it serialises on the TPU) by comparing each VMEM tile
// against a 256-bin iota, 256 compares per byte. On Hopper shared-memory
// integer atomics are cheap, so this is the direct histogram: one row per
// blockIdx.y (one byte plane of one chunk), the row split over blockIdx.x,
// each warp adding into its own 256-bin copy in shared memory (fewer
// collisions between warps), then one global integer atomicAdd per non-zero
// bin and block. Integer sums are exact and order-free, so the result does
// not depend on the schedule. A second small kernel converts to f32 (a
// 64^3 plane's 262,144 counts are exact in f32).
//
// What bounds it on an H100: it reads each byte once and does one shared
// atomic per byte, so the bound is bytes (16.8 MB for a validation batch of
// 32 64^3 volumes, ~5 us at 3.35 TB/s); skewed data (most delta bytes are
// 0x00 or 0xFF) serialises the atomics on a few bins, which the per-warp
// copies only partly relieve.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one shared histogram copy each
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void add_word(int* h, uint32_t w) {
  atomicAdd(&h[w & 0xFFu], 1);
  atomicAdd(&h[(w >> 8) & 0xFFu], 1);
  atomicAdd(&h[(w >> 16) & 0xFFu], 1);
  atomicAdd(&h[w >> 24], 1);
}

__global__ void __launch_bounds__(THREADS)
    byte_histogram_kernel(const uint8_t* data, long long len, int* counts) {
  __shared__ int h[WARPS][256];
  for (int i = threadIdx.x; i < WARPS * 256; i += THREADS) (&h[0][0])[i] = 0;
  __syncthreads();
  const uint8_t* row = data + (long long)blockIdx.y * len;
  int* hw = h[threadIdx.x >> 5];
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (len % 16 == 0) {
    // Rows start 16-byte aligned (the wrapper checks the base pointer).
    const uint4* v = reinterpret_cast<const uint4*>(row);
    for (long long i = first; i < len / 16; i += stride) {
      const uint4 w = v[i];
      add_word(hw, w.x);
      add_word(hw, w.y);
      add_word(hw, w.z);
      add_word(hw, w.w);
    }
  } else {
    for (long long i = first; i < len; i += stride) atomicAdd(&hw[row[i]], 1);
  }
  __syncthreads();
  for (int bin = threadIdx.x; bin < 256; bin += THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += h[w][bin];
    if (s) atomicAdd(&counts[(long long)blockIdx.y * 256 + bin], s);
  }
}

__global__ void counts_to_f32_kernel(const int* counts, float* out,
                                     long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = static_cast<float>(counts[i]);
}

}  // namespace

// C entry point, bound with ctypes. data: (rows, len) uint8, contiguous,
// 16-byte aligned; counts: (rows, 256) int32 scratch; out: (rows, 256) f32.
// The wrapper (exaspim_tpu_torch/compression/proxy.py) allocates both and
// keeps rows <= 65535. Launches on `stream`, does not synchronise, returns
// the cudaError_t of the launches.
extern "C" int byte_histogram_u8(const void* data, long long rows,
                                 long long len, void* counts, void* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(counts);
  cudaMemsetAsync(c, 0, (size_t)rows * 256 * sizeof(int), s);
  // About eight 16-byte vectors per thread; at most 64 blocks per row.
  long long per_block = (long long)THREADS * 16 * 8;
  long long bx = (len + per_block - 1) / per_block;
  if (bx < 1) bx = 1;
  if (bx > 64) bx = 64;
  dim3 grid((unsigned)bx, (unsigned)rows);
  byte_histogram_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(data), len, c);
  const long long n = rows * 256;
  counts_to_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      c, static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
