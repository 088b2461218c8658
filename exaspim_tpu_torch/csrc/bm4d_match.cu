// BM4D block-matching distance table.
//
// For every reference block r on the stride-`step` grid of a guide volume
// and every window offset (dz, dy, dx) in [0, W)^3 (offset digit minus
// half = signed shift):
//
//   D[r, d] = sum over the B^3 block of (g(r + v) - g(r + d - half + v))^2
//
// on the guide already reflect-padded by half = W / 2 on all three axes
// (the wrapper pads), with three rounding points that decide near-ties:
// the squared differences are summed over the block's z extent in f32
// (t = 0..B-1 in order) and rounded to bf16, those are summed over y in
// f32 and rounded to bf16, those over x in f32 and rounded to bf16 for the
// table. The adds, the subtract and the multiply are the _rn intrinsics,
// which the compiler never contracts into FMAs, so the table equals the
// plain PyTorch version's (exaspim_tpu_torch/ops/bm4d_match.py).
//
// Replaces exaspim_tpu/ops/pallas_bm4d.py:_match_kernel. The TPU kernel
// walks (reference z-row, dy) grid steps over VMEM-resident z-slabs and
// does the y/x box sums as band-matrix matmuls on the MXU. None of that is
// carried over: on Hopper a box sum of four is three adds, and blocks run
// in parallel, so this is one thread block per reference. The block stages
// the (B + W - 1)^3 search region of its reference in shared memory
// (6.9 KB at B 4, W 9; the guide itself stays in L2) and each thread then
// computes whole table entries from it, neighbouring threads taking
// neighbouring dx, so the table row is written contiguously.
//
// What bounds it on an H100: the function reads the guide once and writes
// the table once (1 MB + 13.5 MB at 64^3, W 9). Evaluated separably, with
// the squared differences shared between overlapping blocks and the box
// sums taken axis by axis, it needs about 0.46 GFLOP per 64^3 stage; with
// no matrix product in it the FP32 vector peak applies, so at the defaults
// operations bound it. This kernel is brute force instead: 3 B^3
// operations (1.3 GFLOP per stage) and 2 B^3 shared-memory loads per entry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// BT > 0: the block size is known at compile time and the loops unroll;
// BT == 0: any block size.
template <int BT>
__global__ void __launch_bounds__(THREADS)
    bm4d_match_kernel(const float* __restrict__ gp, int yp, int xp, int gy,
                      int gx, int block, int step, int W,
                      __nv_bfloat16* __restrict__ table) {
  extern __shared__ float s[];
  const int B = BT > 0 ? BT : block;
  const int span = B + W - 1;
  const int r = blockIdx.x;
  const int gk = r % gx, gj = (r / gx) % gy, gi = r / (gx * gy);
  const float* base =
      gp + ((long long)(gi * step) * yp + gj * step) * xp + gk * step;
  const int n = span * span * span;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int x = i % span, y = (i / span) % span, z = i / (span * span);
    s[i] = base[((long long)z * yp + y) * xp + x];
  }
  __syncthreads();
  const int half = W / 2;
  const float* ref = s + (half * span + half) * span + half;
  const int w3 = W * W * W;
  for (int c = threadIdx.x; c < w3; c += THREADS) {
    const int dx = c % W, dy = (c / W) % W, dz = c / (W * W);
    const float* cand = s + (dz * span + dy) * span + dx;
    float fx = 0.f;
#pragma unroll
    for (int xx = 0; xx < B; ++xx) {
      float fy = 0.f;
#pragma unroll
      for (int yy = 0; yy < B; ++yy) {
        float fz = 0.f;
#pragma unroll
        for (int t = 0; t < B; ++t) {
          const int o = (t * span + yy) * span + xx;
          const float d = __fsub_rn(ref[o], cand[o]);
          fz = __fadd_rn(fz, __fmul_rn(d, d));
        }
        fy = __fadd_rn(fy, bf16_round(fz));
      }
      fx = __fadd_rn(fx, bf16_round(fy));
    }
    table[(long long)r * w3 + c] = __float2bfloat16_rn(fx);
  }
}

}  // namespace

// C entry point, bound with ctypes. gp: (zp, yp, xp) f32, the guide padded
// by W / 2 per side, contiguous; table: (gz * gy * gx, W^3) bf16, offsets
// in (dz, dy, dx) order. The wrapper checks that (B + W - 1)^3 floats fit
// the static shared-memory limit. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch.
extern "C" int bm4d_match_f32(const void* gp, int zp, int yp, int xp, int gz,
                              int gy, int gx, int block, int step, int W,
                              void* table, void* stream) {
  (void)zp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int span = block + W - 1;
  const size_t shared = sizeof(float) * span * span * span;
  const unsigned refs = (unsigned)gz * gy * gx;
  const float* g = static_cast<const float*>(gp);
  __nv_bfloat16* t = static_cast<__nv_bfloat16*>(table);
  if (block == 4)
    bm4d_match_kernel<4><<<refs, THREADS, shared, s>>>(g, yp, xp, gy, gx,
                                                       block, step, W, t);
  else
    bm4d_match_kernel<0><<<refs, THREADS, shared, s>>>(g, yp, xp, gy, gx,
                                                       block, step, W, t);
  return (int)cudaGetLastError();
}
