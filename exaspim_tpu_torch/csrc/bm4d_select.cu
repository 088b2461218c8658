// BM4D group selection over a distance table: per reference, the K smallest
// of W^3 packed keys, decoded to unclipped block starts.
//
// Replaces exaspim_tpu/ops/pallas_bm4d.py:126 _select_kernel, the TPU
// kernel that runs K rounds of a vector minimum over column chunks of a
// padded table. On the teacher path the selection runs inside the fused
// matching kernel (bm4d_match.cu), on keys that never leave shared memory;
// this entry point runs the same routine (bm4d_select.cuh) on a table that
// is already in device memory, so that the table instance of bm4d_match.cu
// and the selection can each be held against their plain versions.
//
// Input: the bf16 table (R, W^3), offsets in (dz, dy, dx) order, read as
// 16-bit patterns. Output: a (3, R, K) int32 tensor (z, y, x), best first,
// step * grid index + digit - W / 2 per axis. One warp owns two
// references; the block's shared memory holds only the W^3 low halves of
// the keys.
//
// What bounds it on an H100: bytes. It reads the table once (13.5 MB per
// 64^3 stage at W 9) and writes 3 * R * K ints (1.8 MB).

#include <cuda_runtime.h>

#include "bm4d_select.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
    bm4d_select_kernel(const unsigned short* __restrict__ table, int refs,
                       int gy, int gx, int K, int step, int W,
                       int* __restrict__ out) {
  extern __shared__ unsigned short low[];
  bm4d::fill_low(low, W);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Two references a warp; an odd last one is selected twice, stored once.
  const int r0 = 2 * (blockIdx.x * WARPS + warp);
  if (r0 >= refs) return;  // a whole warp leaves; no barrier below
  const int rs[2] = {r0, r0 + 1 < refs ? r0 + 1 : r0};
  const int w3 = W * W * W;
  const unsigned short* rows[2] = {table + (long long)rs[0] * w3,
                                   table + (long long)rs[1] * w3};
  int keys[2];
  bm4d::warp_topk<2>(rows, low, w3, K, lane, keys);
  for (int j = 0; j < 2 - (rs[1] == rs[0]); ++j) {
    const int r = rs[j];
    const int gk = r % gx, gj = (r / gx) % gy, gi = r / (gx * gy);
    bm4d::store_starts(out, refs, r, K, lane, keys[j], step * gi, step * gj,
                       step * gk, W / 2);
  }
}

}  // namespace

// C entry point, bound with ctypes. table: (gz * gy * gx, W^3) bf16,
// contiguous; out: (3, R, K) int32. The wrapper keeps W <= 15 and
// 1 <= K <= min(32, W^3). Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch.
extern "C" int bm4d_select_bf16(const void* table, int gz, int gy, int gx,
                                int K, int step, int W, void* out,
                                void* stream) {
  const int refs = gz * gy * gx;
  const size_t shared = sizeof(unsigned short) * W * W * W;
  const unsigned blocks = (unsigned)((refs + 2 * WARPS - 1) / (2 * WARPS));
  bm4d_select_kernel<<<blocks, WARPS * 32, shared,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(table), refs, gy, gx, K, step, W,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
