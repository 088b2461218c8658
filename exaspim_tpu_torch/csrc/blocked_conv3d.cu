// 3x3x3 SAME convolution (no bias, one input, no statistics) over
// channels-last bf16 volumes, from a halo'd input tile staged in shared
// memory.
//
// Replaces exaspim_tpu/ops/pallas_conv.py:_kernel (the Pallas TPU kernel
// behind blocked_conv3d). It computes the same function and keeps the TPU
// kernel's one real idea: the im2col panel lives on chip and never in
// device memory. Nothing of the TPU's layout comes along: no 2x2 (y, x)
// space-to-depth fold into lanes, no 12 tap groups (48/27 of the FLOP), no
// doubled-lane packed input, no packed weight matrix, no unpack pass. The
// kernel reads plain NDHWC and (27, Cin, Cout) taps and writes plain NDHWC.
//
// One block computes a 4 x 4 x 8 (z, y, x) tile of output voxels for BN
// output channels. Per 32-channel chunk of the input it loads the
// 6 x 6 x 10 halo'd voxel tile once, with zeros written for voxels outside
// the volume, so the 27 taps are 27 shifted views of shared memory: no
// bounds check and no global read in the inner loop (csrc/nb_conv3d.cu
// re-reads every input voxel from L2 once per tap and checks the bounds of
// every shifted voxel). Each tap's 32 x BN weight slice is staged
// transposed (k contiguous), so A and B fragments are both single 32-bit
// shared loads, conflict-free at a row stride of 40 bf16; the next tap's
// slice is fetched into registers while the tensor cores work on this one
// (two weight buffers, one barrier per tap).
//
// Numerics: bf16 inputs, f32 accumulation over all 27 * Cin products
// (mma.sync m16n8k16), one rounding to bf16 at the end.
//
// What bounds it on an H100: 2 * 27 * Cin * Cout FLOP per voxel against
// 2 * (Cin + Cout) compulsory bytes, 432 FLOP/B at 32 -> 32 and more with
// more channels, above the ~295 FLOP/B ridge of the bf16 tensor cores:
// operations. The halo costs 360 / 128 = 2.8 tile loads per output tile
// (from L2 for the most part), against 27 per voxel without it. wgmma, TMA,
// ldmatrix and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TZ = 4, TY = 4, TX = 8;              // output tile (voxels)
constexpr int HZ = TZ + 2, HY = TY + 2, HX = TX + 2;
constexpr int HV = HZ * HY * HX;                   // 360 halo'd voxels
constexpr int CK = 32;                             // input channels per chunk
constexpr int LD = CK + 8;                         // shared row stride (bf16)
constexpr int THREADS = 256;                       // 8 warps: 4 (z) x 2 (N)

struct Params {
  const uint16_t* x;  // (B, D, H, W, cin) bf16 bits
  const uint16_t* w;  // (27, cin, cout) bf16 bits
  uint16_t* out;      // (B, D, H, W, cout) bf16 bits
  int cin, cout;
  int D, H, W;
  int tiles_y, tiles_x;
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BN>
__global__ void __launch_bounds__(THREADS) blocked_conv3d_kernel(Params p) {
  constexpr int NI = BN / 16;        // 8-wide N fragments per warp
  constexpr int WVEC = CK * BN / 8;  // 16-byte vectors of one tap's slice
  __shared__ __align__(16) uint16_t Xs[HV][LD];
  __shared__ __align__(16) uint16_t Ws[2][BN][LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // wm: the tile's z plane
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  int t = blockIdx.x;
  const int x0 = (t % p.tiles_x) * TX;
  t /= p.tiles_x;
  const int y0 = (t % p.tiles_y) * TY;
  const int z0 = (t / p.tiles_y) * TZ;

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // This thread's vector of a tap's weight slice: input channel kr of the
  // chunk, output channels n0 + nv * 8 .. + 8. Consecutive threads take
  // consecutive kr, so the transposed 16-bit stores below fall on
  // consecutive shared words.
  const int kr = tid % CK, nv = tid / CK;
  const bool wthread = tid < WVEC;

  for (int c0 = 0; c0 < p.cin; c0 += CK) {
    // The previous chunk's last tap ended with a barrier: Xs and Ws[0] are
    // free. Halo'd tile of this chunk, zeros outside the volume.
    for (int e = tid; e < HV * (CK / 8); e += THREADS) {
      const int hv = e >> 2, vec = e & 3;
      const int z = z0 - 1 + hv / (HY * HX);
      const int y = y0 - 1 + (hv / HX) % HY;
      const int x = x0 - 1 + hv % HX;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W) {
        const long long vox = (((long long)b * p.D + z) * p.H + y) * p.W + x;
        v = *reinterpret_cast<const uint4*>(p.x + vox * p.cin + c0 + vec * 8);
      }
      *reinterpret_cast<uint4*>(&Xs[hv][vec * 8]) = v;
    }
    const uint16_t* wsrc =
        p.w + ((long long)c0 + kr) * p.cout + n0 + nv * 8;
    const long long wtap = (long long)p.cin * p.cout;
    if (wthread) {
      const uint4 v = *reinterpret_cast<const uint4*>(wsrc);
      const uint16_t* h = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) Ws[0][nv * 8 + j][kr] = h[j];
    }
    __syncthreads();

    for (int tap = 0; tap < 27; ++tap) {
      const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
      uint4 wnext = make_uint4(0u, 0u, 0u, 0u);
      if (wthread && tap + 1 < 27)
        wnext = *reinterpret_cast<const uint4*>(wsrc + (tap + 1) * wtap);

      const uint16_t(*Wt)[LD] = Ws[tap & 1];
      // Fragment row r of M-fragment mi is voxel (wm, 2 mi + r / 8, r % 8).
      const uint16_t* arow[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          arow[mi][half] =
              &Xs[((wm + kz) * HY + (mi * 2 + half + ky)) * HX + g + kx]
                 [t4 * 2];
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        uint32_t af[2][4];
        uint32_t bfr[NI][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          af[mi][0] = *reinterpret_cast<const uint32_t*>(arow[mi][0] + kk);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(arow[mi][1] + kk);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(arow[mi][0] + kk + 8);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(arow[mi][1] + kk + 8);
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint16_t* brow = &Wt[wn * (BN / 2) + ni * 8 + g][kk + t4 * 2];
          bfr[ni][0] = *reinterpret_cast<const uint32_t*>(brow);
          bfr[ni][1] = *reinterpret_cast<const uint32_t*>(brow + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
      }

      // The other buffer was last read one tap ago, before that tap's
      // barrier: free to fill while other warps still read this one.
      if (wthread && tap + 1 < 27) {
        const uint16_t* h = reinterpret_cast<const uint16_t*>(&wnext);
#pragma unroll
        for (int j = 0; j < 8; ++j) Ws[(tap + 1) & 1][nv * 8 + j][kr] = h[j];
      }
      __syncthreads();
    }
  }

  // Epilogue: one rounding to bf16; voxels of a tile that overhangs the
  // volume are not written.
  const int z = z0 + wm;
  if (z >= p.D) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int y = y0 + mi * 2 + half, x = x0 + g;
      if (y >= p.H || x >= p.W) continue;
      const long long vox = (((long long)b * p.D + z) * p.H + y) * p.W + x;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * (BN / 2) + ni * 8 + t4 * 2;
        *reinterpret_cast<__nv_bfloat162*>(p.out + vox * p.cout + n) =
            __floats2bfloat162_rn(acc[mi][ni][2 * half],
                                  acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. Shapes and layouts are validated by the
// Python wrapper (exaspim_tpu_torch/ops/blocked_conv.py); cin and cout must
// be multiples of 32. Returns the cudaError_t of the launch (0 on success).
// Launches on `stream` and does not synchronise.
extern "C" int blocked_conv3d_bf16(const void* x, const void* w, void* out,
                                   int B, int D, int H, int W, int cin,
                                   int cout, void* stream) {
  if (cin <= 0 || cout <= 0 || cin % CK || cout % 32 || B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.w = static_cast<const uint16_t*>(w);
  p.out = static_cast<uint16_t*>(out);
  p.cin = cin;
  p.cout = cout;
  p.D = D;
  p.H = H;
  p.W = W;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  const long long tiles =
      (long long)((D + TZ - 1) / TZ) * p.tiles_y * p.tiles_x;
  if (tiles <= 0 || tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int bn = (cout % 64 == 0) ? 64 : 32;
  dim3 grid((unsigned)tiles, cout / bn, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    blocked_conv3d_kernel<64><<<grid, THREADS, 0, s>>>(p);
  else
    blocked_conv3d_kernel<32><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
