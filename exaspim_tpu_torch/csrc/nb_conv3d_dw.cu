// Weight gradient of the 3x3x3 SAME convolution (no bias) over channels-last
// bf16 volumes: dL/dW[tap, c, n] = sum over batch and voxels v of
// x[v + delta_tap, c] * g[v, n], accumulated in f32.
//
// Replaces exaspim_tpu/ops/nb_conv.py:_dw_kernel (the Pallas TPU kernel
// behind _nb_conv_dw). It computes the same function, not the TPU's rolling-z
// slab panels: as a GEMM it is
//
//   M = 27 * (Ca + Cb) rows (tap-major, the (27, Cin, Cout) packing),
//   N = Cout, K = every voxel of every batch element,
//
// so K is huge (8.4 M at B = 32, 64^3) and M x N tiny (864 x 32). The
// parallelism therefore comes from splitting K: each block owns a voxel
// range (a "split") and one (M, N) tile, and writes its f32 partial sums to
// its own slice of a workspace (splits, 27 * Cin, Cout). A second kernel
// adds the slices in a fixed order, so a run repeats bit for bit (no float
// atomics).
//
// Per K step of KV voxels the block stages the gradient tile g[voxels][n]
// ONCE in shared memory and reuses it for every tap it owns. In the aligned
// path (every segment's channel count a multiple of 32) a block owns the
// three taps of one (dz, dy) row (dx = -1, 0, +1) times 32 input channels of
// one segment: the shifted x tiles are read with 16-byte loads and the same
// explicit (z, y, x) bounds checks as nb_conv3d.cu (outside taps read zero).
// Otherwise (the Cin = 1 entry conv, M = 27) a scalar loader decodes
// (tap, channel) per element and zero-fills rows past 27 * Cin. Both tiles
// are stored voxel-major and fed to mma.sync m16n8k16 (bf16 in, f32
// accumulate) through ldmatrix.trans.
//
// What bounds it on an H100: at 64^3 B = 32 32->32 it does 2*27*32*32 FLOP
// per voxel against 128 B of compulsory traffic (x and g read once), ~430
// FLOP/B, above the bf16 ridge (~295): compute bound, 0.47 ms at the
// tensor-core peak. The design keeps the tensor cores fed from shared
// memory and re-reads each x voxel from L2 once per (dz, dy) tap row; wgmma,
// TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KV = 64;        // voxels per staged K step
constexpr int THREADS = 128;  // 4 warps, 2 (M) x 2 (N)
constexpr int PAD = 8;        // row padding (bf16) against bank conflicts

struct Params {
  const uint16_t* xa;  // (B, D, H, W, ca) bf16 bits
  const uint16_t* xb;  // (B, D, H, W, cb) bf16 bits, or null when cb == 0
  const uint16_t* g;   // (B, D, H, W, cout) bf16 bits
  float* ws;           // (splits, 27 * cin, cout) f32 partial sums
  int ca, cb, cin, cout;
  int D, H, W;
  int dhw;
  long long nvox;       // B * dhw
  long long per_split;  // voxels per split, a multiple of KV
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const uint16_t* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void decode(const Params& p, long long q, int& b,
                                       int& z, int& y, int& x) {
  b = static_cast<int>(q / p.dhw);
  const int v = static_cast<int>(q - (long long)b * p.dhw);
  z = v / (p.H * p.W);
  y = (v / p.W) % p.H;
  x = v % p.W;
}

// A block's tile: MT rows of M (As[k][m], voxel-major) times BN columns of
// N (Bs[k][n], voxel-major), over KV voxels. Warp (wm, wn) owns rows
// wm * MT/2 .. and columns wn * BN/2 ..
template <int MT, int BN>
__device__ __forceinline__ void mma_step(const uint16_t (*As)[MT + PAD],
                                         const uint16_t (*Bs)[BN + PAD],
                                         float (*acc)[BN / 16][4], int wm,
                                         int wn, int lane) {
  constexpr int MI = MT / 32;
  constexpr int NI = BN / 16;
  const int rr = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KV; kk += 16) {
    uint32_t af[MI][4];
    uint32_t bfr[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      // Matrices: (k 0, m 0) (k 0, m 8) (k 8, m 0) (k 8, m 8) = a0..a3.
      const int k = kk + (mat >> 1) * 8 + rr;
      const int m = wm * (MT / 2) + mi * 16 + (mat & 1) * 8;
      ldmatrix_x4_trans(af[mi], &As[k][m]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ni += 2) {
      // Matrices: (k 0, n 0) (k 8, n 0) (k 0, n 8) (k 8, n 8) =
      // b0, b1 of tile ni and b0, b1 of tile ni + 1.
      const int k = kk + (mat & 1) * 8 + rr;
      const int n = wn * (BN / 2) + ni * 8 + (mat >> 1) * 8;
      uint32_t r[4];
      ldmatrix_x4_trans(r, &Bs[k][n]);
      bfr[ni][0] = r[0];
      bfr[ni][1] = r[1];
      bfr[ni + 1][0] = r[2];
      bfr[ni + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
  }
}

// ALIGNED: MT = 96 rows = 3 taps (dx = -1, 0, 1 of tap row blockIdx.x % 9)
// x 32 channels (chunk blockIdx.x / 9 of the concatenated channels).
// Otherwise MT = 32 rows m = blockIdx.x * 32 + r of the flattened
// (tap, channel) index, decoded per element.
template <int MT, int BN, bool ALIGNED>
__global__ void __launch_bounds__(THREADS) nb_conv3d_dw_kernel(Params p) {
  constexpr int MI = MT / 32;
  constexpr int NI = BN / 16;
  constexpr int VPR = BN / 8;  // 16-byte vectors per g row
  __shared__ __align__(16) uint16_t As[KV][MT + PAD];
  __shared__ __align__(16) uint16_t Bs[KV][BN + PAD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.y * BN;
  const long long q_begin = (long long)blockIdx.z * p.per_split;
  const long long q_end =
      q_begin + p.per_split < p.nvox ? q_begin + p.per_split : p.nvox;
  const int mrows = 27 * p.cin;

  // Aligned path: this block's tap row and channel chunk.
  const int trow = blockIdx.x % 9;
  const int cglob = (blockIdx.x / 9) * 32;
  const bool in_a = cglob < p.ca;
  const uint16_t* xs = in_a ? p.xa : p.xb;
  const int cs = in_a ? p.ca : p.cb;
  const int cl = in_a ? cglob : cglob - p.ca;
  const int dz = trow / 3 - 1, dy = trow % 3 - 1;
  const int m0 = blockIdx.x * MT;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  for (long long q0 = q_begin; q0 < q_end; q0 += KV) {
    // Thread -> voxels (tid / 4) + 32 i, 8-channel vector tid % 4.
    const int vj = tid & 3;
#pragma unroll
    for (int i = 0; i < KV / 32; ++i) {
      const int vi = (tid >> 2) + 32 * i;
      const long long q = q0 + vi;
      const bool qv = q < q_end;
      for (int j = vj; j < VPR; j += 4) {
        const int n = n0 + j * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (qv && n < p.cout)
          v = *reinterpret_cast<const uint4*>(p.g + q * p.cout + n);
        *reinterpret_cast<uint4*>(&Bs[vi][j * 8]) = v;
      }
      if (ALIGNED) {
        int b = 0, z = 0, y = 0, x = 0;
        if (qv) decode(p, q, b, z, y, x);
        const int zz = z + dz, yy = y + dy;
        const bool zy = qv && zz >= 0 && zz < p.D && yy >= 0 && yy < p.H;
        const long long row = zy ? ((long long)b * p.D + zz) * p.H + yy : 0;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const int xx = x + t - 1;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (zy && xx >= 0 && xx < p.W)
            v = *reinterpret_cast<const uint4*>(
                xs + (row * p.W + xx) * cs + cl + vj * 8);
          *reinterpret_cast<uint4*>(&As[vi][t * 32 + vj * 8]) = v;
        }
      }
    }
    if (!ALIGNED) {
      for (int e = tid; e < MT * KV; e += THREADS) {
        const int r = e % MT, vi = e / MT;
        const int m = m0 + r;
        const long long q = q0 + vi;
        uint16_t val = 0;
        if (m < mrows && q < q_end) {
          const int tap = m / p.cin, c = m % p.cin;
          int b, z, y, x;
          decode(p, q, b, z, y, x);
          const int zz = z + tap / 9 - 1;
          const int yy = y + (tap / 3) % 3 - 1;
          const int xx = x + tap % 3 - 1;
          if (zz >= 0 && zz < p.D && yy >= 0 && yy < p.H && xx >= 0 &&
              xx < p.W) {
            const long long vox =
                (((long long)b * p.D + zz) * p.H + yy) * p.W + xx;
            val = c < p.ca ? p.xa[vox * p.ca + c]
                           : p.xb[vox * p.cb + (c - p.ca)];
          }
        }
        As[vi][r] = val;
      }
    }
    __syncthreads();
    mma_step<MT, BN>(As, Bs, acc, wm, wn, lane);
    __syncthreads();
  }

  // Epilogue: this split's partial sums into its workspace slice.
  float* out = p.ws + (long long)blockIdx.z * mrows * p.cout;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * (MT / 2) + mi * 16 + g + half * 8;
      const int grow =
          ALIGNED ? (trow * 3 + r / 32) * p.cin + cglob + r % 32 : m0 + r;
      if (grow >= mrows) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * (BN / 2) + ni * 8 + t4 * 2;
        if (n >= p.cout) continue;
        *reinterpret_cast<float2*>(out + (long long)grow * p.cout + n) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

// out[i] = sum over splits s = 0, 1, ... of ws[s][i], in that order.
__global__ void dw_reduce_kernel(const float* ws, float* out, long long mn,
                                 int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[(long long)k * mn + i];
    out[i] = s;
  }
}

template <int MT, int BN, bool ALIGNED>
void launch(const Params& p, int mblocks, int splits, cudaStream_t s) {
  dim3 grid(mblocks, (p.cout + BN - 1) / BN, splits);
  nb_conv3d_dw_kernel<MT, BN, ALIGNED><<<grid, THREADS, 0, s>>>(p);
}

}  // namespace

// C entry point, bound with ctypes. The Python wrapper
// (exaspim_tpu_torch/ops/nb_conv.py) validates shapes and layouts, picks
// `splits` and allocates ws (splits * 27 * cin * cout f32) and out
// (27 * cin * cout f32). cout must be a multiple of 8, pointers 16-byte
// aligned. The aligned path needs ca and cb multiples of 32. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launches.
extern "C" int nb_conv3d_dw_bf16(const void* xa, const void* xb, int ca,
                                 int cb, const void* g, void* ws, void* out,
                                 int B, int D, int H, int W, int cout,
                                 int splits, void* stream) {
  Params p;
  p.xa = static_cast<const uint16_t*>(xa);
  p.xb = static_cast<const uint16_t*>(xb);
  p.g = static_cast<const uint16_t*>(g);
  p.ws = static_cast<float*>(ws);
  p.ca = ca;
  p.cb = cb;
  p.cin = ca + cb;
  p.cout = cout;
  p.D = D;
  p.H = H;
  p.W = W;
  p.dhw = D * H * W;
  p.nvox = (long long)B * p.dhw;
  const long long steps = (p.nvox + KV - 1) / KV;
  p.per_split = ((steps + splits - 1) / splits) * KV;
  const bool aligned = (ca % 32 == 0) && (cb % 32 == 0);
  const bool wide = cout % 64 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    const int mblocks = 9 * (p.cin / 32);
    if (wide) launch<96, 64, true>(p, mblocks, splits, s);
    else launch<96, 32, true>(p, mblocks, splits, s);
  } else {
    const int mblocks = (27 * p.cin + 31) / 32;
    if (wide) launch<32, 64, false>(p, mblocks, splits, s);
    else launch<32, 32, false>(p, mblocks, splits, s);
  }
  const long long mn = 27LL * p.cin * cout;
  long long rblocks = (mn + 255) / 256;
  if (rblocks > 4096) rblocks = 4096;
  dw_reduce_kernel<<<(unsigned)rblocks, 256, 0, s>>>(p.ws, static_cast<float*>(out),
                                                     mn, splits);
  return (int)cudaGetLastError();
}
