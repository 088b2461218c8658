// 3x3x3 SAME convolution (no bias) over channels-last bf16 volumes, with an
// optional fused GroupNorm-statistics epilogue.
//
// Replaces exaspim_tpu/ops/nb_conv.py:_fwd_kernel (the Pallas TPU kernel
// behind nb_conv3d / nb_conv3d_stats). It computes the same function, not
// the TPU's layout: the natural-phase blocking, the 72*C wide panel, the
// resident halo rows and the z-block VMEM budget exist only for Mosaic and
// are gone. Here the conv is an implicit GEMM over plain NDHWC tensors:
//
//   M = output voxels of one batch element, N = Cout, K = 27 * (Ca + Cb)
//
// with k = tap * Cin + c, tap = (kz * 3 + ky) * 3 + kx, which is exactly the
// row order of the DHWIO taps reshaped to (27, Cin, Cout). The input may be
// two channel segments x_a (Ca channels) and x_b (Cb channels): the
// decoder's [skip, up] concat is consumed as two K-segments and never built
// in memory. Taps that fall outside the volume read zero by explicit
// (z, y, x) bounds checks on every shifted voxel, so nothing wraps across
// rows or slabs and no padded copy exists.
//
// Numerics: bf16 inputs, f32 accumulation (mma.sync m16n8k16), one rounding
// to bf16 at the end. With stats, the epilogue also sums y and y*y of the
// bf16-ROUNDED outputs per (batch, output channel): reduced in registers,
// across lanes by shuffles, across warps in shared memory, then one
// atomicAdd per tile and channel into buffers the caller zeroed.
//
// What bounds it on an H100: at the 96^3 32->32 stage each output voxel
// costs 2*27*32*32 = 55 kFLOP against 128 B of compulsory traffic (64 B
// in, 64 B out), ~430 FLOP/B, above the card's ~295 FLOP/B ridge for bf16
// tensor cores: it is compute bound, and deeper stages (more channels) are
// more so. The design therefore keeps the tensor cores fed from shared
// memory: a 64-voxel x (32|64)-channel output tile per 4-warp block, a
// 2x2 warp grid with 32 x (16|32) warp tiles, K streamed in 32-deep chunks
// (one tap x 32 channels of one segment, staged with 16-byte loads), each
// input voxel re-read from L2 by up to 27 taps. The Cin=1 entry conv
// (K = 27) uses a scalar loader that decodes (tap, channel) per element and
// zero-pads K to 32 in shared memory. wgmma, TMA and a pipelined or
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output voxels per block
constexpr int BK = 32;       // K depth per staged chunk
constexpr int THREADS = 128; // 4 warps, 2 (M) x 2 (N)
constexpr int APAD = 8;      // row padding (bf16) against bank conflicts
constexpr int BPAD = 8;

struct Params {
  const uint16_t* xa;  // (B, D, H, W, ca) bf16 bits
  const uint16_t* xb;  // (B, D, H, W, cb) bf16 bits, or null when cb == 0
  const uint16_t* w;   // (27, ca + cb, cout) bf16 bits
  uint16_t* out;       // (B, D, H, W, cout) bf16 bits
  float* s1;           // (B, cout) sum of y, or null
  float* s2;           // (B, cout) sum of y*y, or null
  int ca, cb, cin, cout;
  int D, H, W;
  int dhw;             // voxels per batch element
  int K;               // 27 * cin
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// One staged K chunk: As[m][k] (k contiguous) times Bs[k][n].
template <int BN>
__device__ __forceinline__ void mma_chunk(
    uint16_t (*As)[BK + APAD], uint16_t (*Bs)[BN + BPAD],
    float (*acc)[BN / 16][4], int wm, int wn, int g, int t4) {
  constexpr int NI = BN / 16;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[2][4];
    uint32_t bfr[NI][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      const int k = kk + t4 * 2;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][k]);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k]);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][k + 8]);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][k + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = wn * (BN / 2) + ni * 8 + g;
      const int k = kk + t4 * 2;
      bfr[ni][0] = pack2(Bs[k][n], Bs[k + 1][n]);
      bfr[ni][1] = pack2(Bs[k + 8][n], Bs[k + 9][n]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
  }
}

// ALIGNED: every segment's channel count is a multiple of BK, so a chunk is
// one tap of one segment and both tiles load as 16-byte vectors. Otherwise
// (the Cin = 1 entry conv) a scalar loader decodes (tap, channel) per
// element and zero-fills K past 27 * cin.
template <int BN, bool ALIGNED, bool STATS>
__global__ void __launch_bounds__(THREADS) nb_conv3d_kernel(Params p) {
  constexpr int NI = BN / 16;
  __shared__ __align__(16) uint16_t As[BM][BK + APAD];
  __shared__ __align__(16) uint16_t Bs[BK][BN + BPAD];
  __shared__ float ssum[2 * BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int HW = p.H * p.W;
  const long long bvox = (long long)b * p.dhw;

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  if (STATS) {
    for (int i = tid; i < 2 * BN; i += THREADS) ssum[i] = 0.f;
  }

  if (ALIGNED) {
    // Thread -> (row, 8-channel vector) of the A tile: rows tid/4 and
    // tid/4 + 32, vector tid%4.
    int rz[2], ry[2], rx[2];
    bool rv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = m0 + (tid >> 2) + 32 * i;
      rv[i] = v < p.dhw;
      const int q = rv[i] ? v : 0;
      rz[i] = q / HW;
      ry[i] = (q / p.W) % p.H;
      rx[i] = q % p.W;
    }
    constexpr int VPR = BN / 8;  // 16-byte vectors per B row
    for (int tap = 0; tap < 27; ++tap) {
      const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
      long long src[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int zz = rz[i] + dz, yy = ry[i] + dy, xx = rx[i] + dx;
        const bool ok = rv[i] && zz >= 0 && zz < p.D && yy >= 0 &&
                        yy < p.H && xx >= 0 && xx < p.W;
        src[i] = ok ? bvox + ((long long)zz * p.H + yy) * p.W + xx : -1;
      }
      for (int seg = 0; seg < 2; ++seg) {
        const int cs = seg ? p.cb : p.ca;
        const uint16_t* xs = seg ? p.xb : p.xa;
        const int coff = seg ? p.ca : 0;
        for (int c0 = 0; c0 < cs; c0 += BK) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (src[i] >= 0)
              v = *reinterpret_cast<const uint4*>(xs + src[i] * cs + c0 +
                                                  t4 * 8);
            *reinterpret_cast<uint4*>(&As[(tid >> 2) + 32 * i][t4 * 8]) = v;
          }
          const long long krow0 = (long long)tap * p.cin + coff + c0;
          for (int e = tid; e < BK * VPR; e += THREADS) {
            const int kr = e / VPR, nv = e % VPR;
            const int n = n0 + nv * 8;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (n < p.cout)
              v = *reinterpret_cast<const uint4*>(
                  p.w + (krow0 + kr) * p.cout + n);
            *reinterpret_cast<uint4*>(&Bs[kr][nv * 8]) = v;
          }
          __syncthreads();
          mma_chunk<BN>(As, Bs, acc, wm, wn, g, t4);
          __syncthreads();
        }
      }
    }
  } else {
    for (int kc0 = 0; kc0 < p.K; kc0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kr = e % BK;
        const int kg = kc0 + kr;
        const int v = m0 + r;
        uint16_t val = 0;
        if (kg < p.K && v < p.dhw) {
          const int tap = kg / p.cin, c = kg % p.cin;
          const int zz = v / HW + tap / 9 - 1;
          const int yy = (v / p.W) % p.H + (tap / 3) % 3 - 1;
          const int xx = v % p.W + tap % 3 - 1;
          if (zz >= 0 && zz < p.D && yy >= 0 && yy < p.H && xx >= 0 &&
              xx < p.W) {
            const long long vox = bvox + ((long long)zz * p.H + yy) * p.W + xx;
            val = c < p.ca ? p.xa[vox * p.ca + c]
                           : p.xb[vox * p.cb + (c - p.ca)];
          }
        }
        As[r][kr] = val;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kr = e / BN, nn = e % BN;
        const int kg = kc0 + kr, n = n0 + nn;
        Bs[kr][nn] = (kg < p.K && n < p.cout)
                         ? p.w[(long long)kg * p.cout + n]
                         : (uint16_t)0;
      }
      __syncthreads();
      mma_chunk<BN>(As, Bs, acc, wm, wn, g, t4);
      __syncthreads();
    }
  }

  // Epilogue: round once to bf16, store, and (STATS) sum the rounded values.
  float ps1[NI][2], ps2[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) ps1[ni][j] = ps2[ni][j] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = n0 + wn * (BN / 2) + ni * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int v = m0 + wm * 32 + mi * 16 + g + half * 8;
        if (v >= p.dhw || n >= p.cout) continue;
        const __nv_bfloat162 y = __floats2bfloat162_rn(
            acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(p.out + (bvox + v) * p.cout + n) = y;
        if (STATS) {
          const float f0 = __low2float(y), f1 = __high2float(y);
          ps1[ni][0] += f0;
          ps1[ni][1] += f1;
          ps2[ni][0] += f0 * f0;
          ps2[ni][1] += f1 * f1;
        }
      }
    }
  }
  if (STATS) {
    // Lanes sharing t4 own the same columns: fold the 8 row groups.
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          ps1[ni][j] += __shfl_xor_sync(0xffffffffu, ps1[ni][j], off);
          ps2[ni][j] += __shfl_xor_sync(0xffffffffu, ps2[ni][j], off);
        }
    if (g == 0) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wn * (BN / 2) + ni * 8 + t4 * 2 + j;
          atomicAdd(&ssum[col], ps1[ni][j]);
          atomicAdd(&ssum[BN + col], ps2[ni][j]);
        }
    }
    __syncthreads();
    for (int col = tid; col < BN; col += THREADS) {
      const int n = n0 + col;
      if (n < p.cout) {
        atomicAdd(&p.s1[(long long)b * p.cout + n], ssum[col]);
        atomicAdd(&p.s2[(long long)b * p.cout + n], ssum[BN + col]);
      }
    }
  }
}

template <int BN, bool ALIGNED>
void launch(const Params& p, bool stats, dim3 grid, cudaStream_t s) {
  if (stats)
    nb_conv3d_kernel<BN, ALIGNED, true><<<grid, THREADS, 0, s>>>(p);
  else
    nb_conv3d_kernel<BN, ALIGNED, false><<<grid, THREADS, 0, s>>>(p);
}

}  // namespace

// C entry point, bound with ctypes. Shapes and layouts are validated by the
// Python wrapper (exaspim_tpu_torch/ops/nb_conv.py); cout must be a
// multiple of 8 and, for the vector path, ca and cb multiples of 32.
// s1 == s2 == null selects the plain conv. Returns the cudaError_t of the
// launch (0 on success). Launches on `stream` and does not synchronise.
extern "C" int nb_conv3d_bf16(const void* xa, const void* xb, int ca, int cb,
                              const void* w, void* out, void* s1, void* s2,
                              int B, int D, int H, int W, int cout,
                              void* stream) {
  Params p;
  p.xa = static_cast<const uint16_t*>(xa);
  p.xb = static_cast<const uint16_t*>(xb);
  p.w = static_cast<const uint16_t*>(w);
  p.out = static_cast<uint16_t*>(out);
  p.s1 = static_cast<float*>(s1);
  p.s2 = static_cast<float*>(s2);
  p.ca = ca;
  p.cb = cb;
  p.cin = ca + cb;
  p.cout = cout;
  p.D = D;
  p.H = H;
  p.W = W;
  p.dhw = D * H * W;
  p.K = 27 * p.cin;
  const bool stats = s1 != nullptr;
  const bool aligned = (ca % BK == 0) && (cb % BK == 0);
  const int bn = (cout % 64 == 0) ? 64 : 32;
  dim3 grid((p.dhw + BM - 1) / BM, (cout + bn - 1) / bn, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) {
    if (aligned) launch<64, true>(p, stats, grid, s);
    else launch<64, false>(p, stats, grid, s);
  } else {
    if (aligned) launch<32, true>(p, stats, grid, s);
    else launch<32, false>(p, stats, grid, s);
  }
  return (int)cudaGetLastError();
}
