// BM4D group selection: per reference, the K smallest of W^3 packed keys.
//
// Each entry of the bf16 distance table (R, W^3; offsets in (dz, dy, dx)
// order, written by bm4d_match.cu) becomes one int32 sort key:
//
//   key = bf16 bits << 16 | min(|d|^2, 15) << 12 | dy << 8 | dx << 4 | dz
//
// with offset digits in [0, W), W <= 15. A non-negative bf16 orders as its
// bit pattern; the low half prefers near offsets among equal distances and
// makes every key of a reference unique, so the K smallest are one exact,
// order-free set. The kernel emits unclipped absolute block starts,
// step * grid index + digit - W / 2 per axis, best first, into a (3, R, K)
// int32 tensor (z, y, x).
//
// Replaces exaspim_tpu/ops/pallas_bm4d.py:_select_kernel. The TPU kernel
// runs K rounds of a vector minimum over column chunks of a padded table
// and masks its padded rows; here one warp owns one reference. Each lane
// builds the keys of its strided share of the row (23 of 729 at W 9) in
// shared memory, which it alone reads and writes, and keeps their minimum
// in a register. A round is one __reduce_min_sync over the warp; only the
// lane that held the winner retires it and rescans its share. Lane k keeps
// the k-th winner, so the starts leave in one coalesced store per axis.
//
// What bounds it on an H100: bytes. It reads the table once (13.5 MB per
// 64^3 stage at W 9) and writes 3 * R * K ints (1.8 MB).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

__global__ void bm4d_select_kernel(const unsigned short* __restrict__ table,
                                   int refs, int gy, int gx, int K, int step,
                                   int W, int* __restrict__ out) {
  extern __shared__ int keys[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * warps + warp;
  if (r >= refs) return;  // a whole warp leaves; no block-wide barrier below
  const int w3 = W * W * W, half = W / 2;
  int* kw = keys + warp * w3;
  const unsigned short* row = table + (long long)r * w3;
  int best = INT_MAX;
  for (int c = lane; c < w3; c += 32) {
    const int dx = c % W, dy = (c / W) % W, dz = c / (W * W);
    const int n2 = (dz - half) * (dz - half) + (dy - half) * (dy - half) +
                   (dx - half) * (dx - half);
    const int key = ((int)row[c] << 16) | (min(n2, 15) << 12) | (dy << 8) |
                    (dx << 4) | dz;
    kw[c] = key;
    best = min(best, key);
  }
  int mine = 0;
  for (int k = 0; k < K; ++k) {
    const int mk = __reduce_min_sync(0xffffffffu, best);
    if (lane == k) mine = mk;
    if (best == mk) {  // keys are unique: exactly one lane
      best = INT_MAX;
      for (int c = lane; c < w3; c += 32) {
        const int v = kw[c];
        if (v == mk)
          kw[c] = INT_MAX;
        else
          best = min(best, v);
      }
    }
  }
  if (lane < K) {
    const int gk = r % gx, gj = (r / gx) % gy, gi = r / (gx * gy);
    const long long plane = (long long)refs * K;
    const long long o = (long long)r * K + lane;
    out[o] = step * gi + (mine & 15) - half;
    out[plane + o] = step * gj + ((mine >> 8) & 15) - half;
    out[2 * plane + o] = step * gk + ((mine >> 4) & 15) - half;
  }
}

}  // namespace

// C entry point, bound with ctypes. table: (gz * gy * gx, W^3) bf16,
// contiguous; out: (3, R, K) int32. The wrapper keeps W <= 15 and
// K <= 32. Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch.
extern "C" int bm4d_select_bf16(const void* table, int gz, int gy, int gx,
                                int K, int step, int W, void* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int refs = gz * gy * gx;
  const int w3 = W * W * W;
  // As many warps per block as fit 48 KB of shared memory, at most 8.
  int warps = (48 * 1024) / (w3 * (int)sizeof(int));
  if (warps > 8) warps = 8;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((refs + warps - 1) / warps);
  bm4d_select_kernel<<<blocks, warps * 32, (size_t)warps * w3 * sizeof(int),
                       s>>>(static_cast<const unsigned short*>(table), refs,
                            gy, gx, K, step, W, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
