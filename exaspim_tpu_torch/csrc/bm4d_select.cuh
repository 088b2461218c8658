// BM4D group selection shared by bm4d_match.cu (the fused matching kernel)
// and bm4d_select.cu (the standalone selection over a distance table).
//
// One warp selects, for one reference, the K smallest of W^3 packed keys
//
//   key = bf16 bits << 16 | min(|d|^2, 15) << 12 | dy << 8 | dx << 4 | dz
//
// (offset digits in [0, W), W <= 15). A non-negative bf16 orders as its bit
// pattern; the low half prefers near offsets among equal distances and makes
// every key of a reference unique, so the K smallest are one exact set, and
// the kernels emit them best first, as the plain version's sorted topk does.
//
// The keys are read from a row of 16-bit distance bits (shared memory in the
// fused kernel, the table in device memory in the standalone one) and a
// per-offset table of low halves in shared memory. Each lane keeps the LIST
// smallest keys of its strided share of the row in registers, sorted, from
// one pass. A round is one __reduce_min_sync over the lists' heads; the lane
// that held the winner pops it. Only a lane whose LIST keys were all taken
// reads its share again, for the keys above its last one, so at K = 16 and
// W = 9 (23 keys a lane) a round is a reduction and a register shift, and
// the serial chain of a rescan in every round is gone. Keys are never
// written back: a refill takes the keys above the lane's last winner. The
// K rounds are still a chain of reductions; a warp runs two references'
// chains at once, so that one's reduction is in flight while the other's
// waits.

#pragma once

#include <limits.h>

namespace bm4d {

constexpr int LIST = 4;

__device__ __forceinline__ unsigned short key_low(int c, int W) {
  const int half = W / 2;
  const int dx = c % W, dy = (c / W) % W, dz = c / (W * W);
  const int n2 = (dz - half) * (dz - half) + (dy - half) * (dy - half) +
                 (dx - half) * (dx - half);
  return (unsigned short)((min(n2, 15) << 12) | (dy << 8) | (dx << 4) | dz);
}

// low[c] for every offset c < W^3, by the whole block.
__device__ __forceinline__ void fill_low(unsigned short* low, int W) {
  const int w3 = W * W * W;
  for (int c = threadIdx.x; c < w3; c += blockDim.x) low[c] = key_low(c, W);
}

__device__ __forceinline__ void list_insert(int (&v)[LIST], int key) {
  if (key < v[LIST - 1]) {
#pragma unroll
    for (int i = LIST - 1; i > 0; --i)
      v[i] = key < v[i - 1] ? v[i - 1] : (key < v[i] ? key : v[i]);
    v[0] = min(v[0], key);
  }
}

// The LIST smallest keys above `after` of this lane's share, ascending,
// INT_MAX where the share has fewer.
__device__ __forceinline__ void list_fill(int (&v)[LIST],
                                          const unsigned short* row,
                                          const unsigned short* low, int w3,
                                          int lane, int after) {
#pragma unroll
  for (int i = 0; i < LIST; ++i) v[i] = INT_MAX;
  for (int c = lane; c < w3; c += 32) {
    const int key = (int)(((unsigned)row[c] << 16) | low[c]);
    if (key > after) list_insert(v, key);
  }
}

// Lane k (k < K) gets in mine[j] the k-th smallest key of rows[j], for NR
// rows at once: their rounds are independent, so their reductions overlap.
// K <= min(32, w3). The whole warp calls it.
template <int NR>
__device__ __forceinline__ void warp_topk(const unsigned short* const* rows,
                                          const unsigned short* low, int w3,
                                          int K, int lane, int (&mine)[NR]) {
  int v[NR][LIST], used[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    list_fill(v[j], rows[j], low, w3, lane, INT_MIN);
    used[j] = 0;
    mine[j] = INT_MAX;
  }
  for (int k = 0; k < K; ++k) {
    int mk[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j)
      mk[j] = __reduce_min_sync(0xffffffffu, v[j][0]);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      if (lane == k) mine[j] = mk[j];
      if (v[j][0] == mk[j]) {  // keys are unique: exactly one lane
#pragma unroll
        for (int i = 0; i < LIST - 1; ++i) v[j][i] = v[j][i + 1];
        v[j][LIST - 1] = INT_MAX;
        if (++used[j] == LIST) {
          list_fill(v[j], rows[j], low, w3, lane, mk[j]);
          used[j] = 0;
        }
      }
    }
  }
}

// Unclipped absolute starts of lane k's key for output row r of a
// (3, rows, K) int32 tensor: step * grid index + digit - W / 2 per axis.
__device__ __forceinline__ void store_starts(int* out, long long rows,
                                             long long r, int K, int lane,
                                             int key, int zb, int yb, int xb,
                                             int half) {
  if (lane < K) {
    const long long plane = rows * K;
    const long long o = r * K + lane;
    out[o] = zb + (key & 15) - half;
    out[plane + o] = yb + ((key >> 8) & 15) - half;
    out[2 * plane + o] = xb + ((key >> 4) & 15) - half;
  }
}

}  // namespace bm4d
