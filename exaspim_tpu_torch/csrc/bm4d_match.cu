// BM4D block matching, fused with the group selection.
//
// For every reference block r on the stride-`step` grid of a guide and every
// window offset (dz, dy, dx) in [0, W)^3 (digit minus W / 2 = signed shift):
//
//   D[r, d] = sum over the B^3 block of (g(r + v) - g(r + d - W/2 + v))^2
//
// on the guide reflect-padded by W / 2 per side (the wrapper pads), with
// three rounding points that decide near-ties: the squared differences are
// summed over the block's z extent in f32 (t = 0..B-1 in order) and rounded
// to bf16, those over y in f32 and rounded to bf16, those over x in f32 and
// rounded to bf16. The subtract, multiply and adds are the _rn intrinsics,
// which the compiler never contracts into FMAs, so every distance has the
// bits of the plain PyTorch version's table (ops/bm4d_match.py).
//
// Two instances of one tile loop:
// - the fused kernel (bm4d_match_topk_f32): per reference, the K smallest
//   packed keys of its W^3 distances (bm4d_select.cuh), decoded to
//   unclipped block starts, a (3, N * R, K) int32 tensor. The distances
//   never reach device memory.
// - the table (bm4d_match_table_f32): the (N * R, W^3) bf16 distances, for
//   holding the matching alone against its plain version.
//
// Replaces exaspim_tpu/ops/pallas_bm4d.py:53 _match_kernel and :126
// _select_kernel. The TPU kernels walk (reference z-row, dy) grid steps
// over VMEM slabs, do the y/x box sums as band-matrix products on the MXU,
// write the (R, W^3) table to HBM and select from it in a second kernel.
// None of that is carried over.
//
// What bounds it on an H100: operations. Evaluated separably, with each
// squared difference formed once and the box sums taken axis by axis, a
// 64^3 stage needs about 0.46 GFLOP, with no matrix product in it, so the
// FP32 vector peak applies (67 TFLOP/s: 6.9 us); the bytes are the guide
// read once (1.1 MB padded) and 3 * R * K * 4 B of starts (1.8 MB at K 16:
// 0.9 us).
//
// The design, and what it does about the brute-force kernel it replaces
// (one block per reference, each staging its own (B + W - 1)^3 region, 3 B^3
// operations and 2 B^3 shared loads per entry, and the whole table written
// to device memory and read back by a second kernel):
// - A block owns a tile of TY x TX references of one z row of one volume
//   (the plan, _match_plan in ops/bm4d_match.py, picks it: 3 x 7 on a 64^3
//   guide, whose 21 x 21 reference rows it covers without a ragged tile)
//   and stages the tile's union search region in shared memory once (12 x
//   18 x 30 floats, where 21 per-reference regions would stage 12^3 floats
//   each), by cp.async, all copies of a thread in flight at once. Blocks of
//   one launch may come from any volume of the batch.
// - Each lane owns D window offsets that differ only in dy (D = 3 where
//   W % 3 == 0) and walks the tile's columns: for each column x, the rows y
//   of the tile in order, each reference row's B z-values loaded once (one
//   broadcast float4 load for the warp at B = 4, from a copy of the
//   reference rows laid out z-fastest) and the candidate rows kept in a
//   ring of D rows in registers, so one new candidate row serves D offsets.
//   A squared difference is formed once per voxel of a reference row and
//   shared by the overlapping references of that row; the z sums of a row
//   feed every reference row that holds it, the y sums every reference
//   column.
// - The z sum, the y sum and the x sum run in the order of the function, in
//   registers: y sums per reference row (the y loop is unrolled, so their
//   indices are constants), x sums in a shift register of (B-1)/S + 1 slots
//   per reference row: a reference always completes in slot (B-1)/S.
// - The union is laid out with pitches chosen so that the 32 lanes of a warp
//   (32 consecutive offset tasks) read 32 different banks; at the defaults
//   the pitches are compile-time constants, so that every shared load takes
//   its offset as an immediate. The inner loop is then the function's
//   subtracts, multiplies, adds and bf16 roundings, and the loads: the
//   kernel is bound by instruction issue, not by the memory.
// - The keys of a tile (TY TX W^3 16-bit distances, 30 KB at 3 x 7) stay in
//   shared memory; after a barrier each warp selects for its references
//   (bm4d_select.cuh), two at a time, and writes their starts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bm4d_select.cuh"

namespace {

constexpr int THREADS_MAX = 256;
constexpr int MAX_SHARED = 227 * 1024;
// The instance for any block size and step: its register arrays are sized
// for blocks up to MAXB and tiles up to MAXTY reference rows.
constexpr int MAXB = 16;
constexpr int MAXTY = 4;

struct Params {
  const float* gp;         // (n, zp, yp, xp) padded guides
  int n, zp, yp, xp;
  int gz, gy, gx;          // reference grid of one volume
  int B, S, W, K;
  int ty, tx;              // tile: reference rows and columns
  int tiles_y, tiles_x;
  int uz, uy, ux;          // union search region of a tile
  int sy, sz;              // its row and plane pitches in shared memory
  int groups, tasks;       // dy groups of D offsets; W * groups * W tasks
  void* out;               // starts (3, n R, K) int32, or table (n R, W^3)
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4-byte global -> shared copy that bypasses registers; zeros if !in.
__device__ __forceinline__ void copy_async4(float* dst, const float* src,
                                            bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float sq_diff(float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fmul_rn(d, d);
}

// BT, ST, TYT > 0: block, step and tile rows known at compile time (the y
// loop unrolls); 0: the runtime values, within MAXB and MAXTY. D: window
// offsets per lane. SYT, SZT > 0: the shared pitches known at compile time
// (every shared load then takes its offset as an immediate); 0: runtime.
template <int BT, int ST, int TYT, int D, int SYT, int SZT, bool TABLE>
__global__ void __launch_bounds__(THREADS_MAX, 2)
    bm4d_match_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = BT ? BT : MAXB;
  constexpr int NTY = TYT ? TYT : MAXTY;
  constexpr int NA = BT ? (BT - 1) / ST + 1 : MAXB;
  constexpr int NRY = (BT && TYT) ? (TYT - 1) * ST + BT : 0;
  // Blocks of 4: the reference rows also as float4 along z, one load each.
  constexpr bool R4 = BT == 4 && TYT > 0;
  const int B = BT ? BT : p.B;
  const int S = ST ? ST : p.S;
  const int TY = TYT ? TYT : p.ty;
  const int J = (B - 1) / S;  // the x slot in which a reference completes
  const int RY = (TY - 1) * S + B, RX = (p.tx - 1) * S + B;
  const int W = p.W, w3 = W * W * W, half = W / 2;
  const int sy = SYT ? SYT : p.sy, sz = SZT ? SZT : p.sz;
  float* u = reinterpret_cast<float*>(smem);
  float4* reft = reinterpret_cast<float4*>(u + ((p.uz * sz + 3) & ~3));
  unsigned short* low = reinterpret_cast<unsigned short*>(
      R4 ? reinterpret_cast<float*>(reft + RX * NRY) : u + p.uz * sz);
  unsigned short* keys = low + ((w3 + 7) & ~7);

  int b = blockIdx.x;
  const int txi = b % p.tiles_x;
  b /= p.tiles_x;
  const int tyi = b % p.tiles_y;
  b /= p.tiles_y;
  const int gi = b % p.gz, n = b / p.gz;
  const int gj0 = tyi * TY, gk0 = txi * p.tx;
  const int nty = min(TY, p.gy - gj0), ntx = min(p.tx, p.gx - gk0);
  const long long R = (long long)p.gz * p.gy * p.gx;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  {  // Stage the union once, a warp per row, every copy in flight at
     // once; past a ragged tile's edge, zeros.
    const float* g = p.gp + ((long long)n * p.zp + gi * S) * p.yp * p.xp;
    const int y0 = gj0 * S, x0 = gk0 * S;
    for (int row = warp; row < p.uz * p.uy; row += nwarps) {
      const int z = row / p.uy, y = row - z * p.uy;
      const float* src = g + ((long long)z * p.yp + y0 + y) * p.xp + x0;
      float* dst = u + z * sz + y * sy;
      for (int x = lane; x < p.ux; x += 32) {
        const bool in = y0 + y < p.yp && x0 + x < p.xp;
        copy_async4(dst + x, in ? src + x : g, in);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  if (!TABLE) bm4d::fill_low(low, W);
  __syncthreads();
  const float* ref = u + half * sz + half * sy + half;
  if constexpr (R4) {  // reft[x * RY + y] = ref[0..3][y][x]
    for (int i = threadIdx.x; i < RX * NRY; i += blockDim.x) {
      const int x = i / NRY, y = i - x * NRY;
      const float* c = ref + y * sy + x;
      reft[i] = make_float4(c[0], c[sz], c[2 * sz], c[3 * sz]);
    }
    __syncthreads();
  }

  for (int tw = warp; tw * 32 < p.tasks; tw += nwarps) {
    const bool live = tw * 32 + lane < p.tasks;
    const int tau = live ? tw * 32 + lane : p.tasks - 1;
    const int dx = tau % W;
    const int dy0 = (tau / W) % p.groups * D;
    const int dz = tau / (W * p.groups);
    const float* cand = u + dz * sz + dy0 * sy + dx;
    // x sums: slot j holds reference column floor(x / S) - j.
    float fx[NTY][NA][D];
#pragma unroll
    for (int iy = 0; iy < NTY; ++iy)
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int k = 0; k < D; ++k) fx[iy][j][k] = 0.f;
    int xs = 0;  // x % S
    for (int x = 0; x < RX; ++x) {
      if (xs == 0) {  // reference column x / S starts
#pragma unroll
        for (int iy = 0; iy < NTY; ++iy)
#pragma unroll
          for (int k = 0; k < D; ++k) {
#pragma unroll
            for (int j = NA - 1; j > 0; --j) fx[iy][j][k] = fx[iy][j - 1][k];
            fx[iy][0][k] = 0.f;
          }
      }
      // ring[(y + k) % D]: the candidate row y + dy0 + k of this column.
      float ring[D][NB];
      float fy[NTY][D];
#pragma unroll
      for (int k = 0; k < D - 1; ++k)
#pragma unroll
        for (int t = 0; t < NB; ++t)
          if (t < B) ring[k][t] = cand[t * sz + k * sy + x];
#pragma unroll
      for (int y = 0; y < (NRY ? NRY : RY); ++y) {
        const int yn = y + D - 1;
        float r[NB];
#pragma unroll
        for (int t = 0; t < NB; ++t)
          if (t < B) ring[yn % D][t] = cand[t * sz + yn * sy + x];
        if constexpr (R4) {
          const float4 r4 = reft[x * NRY + y];
          r[0] = r4.x, r[1] = r4.y, r[2] = r4.z, r[3] = r4.w;
        } else {
#pragma unroll
          for (int t = 0; t < NB; ++t)
            if (t < B) r[t] = ref[t * sz + y * sy + x];
        }
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float* c = ring[(y + k) % D];
          float fz = sq_diff(r[0], c[0]);
#pragma unroll
          for (int t = 1; t < NB; ++t)
            if (t < B) fz = __fadd_rn(fz, sq_diff(r[t], c[t]));
          fz = bf16_round(fz);
          // Every reference row whose block holds row y, in order of y.
#pragma unroll
          for (int iy = 0; iy < NTY; ++iy) {
            if (iy < TY && iy * S <= y && y < iy * S + B) {
              fy[iy][k] = y == iy * S ? fz : __fadd_rn(fy[iy][k], fz);
              if (y == iy * S + B - 1) {
                const float f = bf16_round(fy[iy][k]);
                // Every open slot takes it; a slot's sum is read only in
                // the column its reference completes in, and is zeroed when
                // its reference starts.
#pragma unroll
                for (int j = 0; j < NA; ++j)
                  if (j <= J) fx[iy][j][k] = __fadd_rn(fx[iy][j][k], f);
              }
            }
          }
        }
      }
      const int xr = x - (B - 1);
      if (live && xr >= 0 && xr % S == 0 && xr / S < ntx) {
        const int ix = xr / S;  // reference column ix completes
#pragma unroll
        for (int iy = 0; iy < NTY; ++iy) {
          if (iy >= nty) break;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < NA; ++j)
              if (j == J) v = fx[iy][j][k];
            const unsigned short bits =
                __bfloat16_as_ushort(__float2bfloat16_rn(v));
            const int c = (dz * W + dy0 + k) * W + dx;
            if (TABLE) {
              const long long r =
                  n * R + ((long long)gi * p.gy + gj0 + iy) * p.gx + gk0 + ix;
              static_cast<unsigned short*>(p.out)[r * w3 + c] = bits;
            } else {
              keys[(iy * p.tx + ix) * w3 + c] = bits;
            }
          }
        }
      }
      xs = xs + 1 == S ? 0 : xs + 1;
    }
  }
  if (TABLE) return;

  __syncthreads();
  // The tile's references q < nty * ntx, NSEL a warp at once (q, q +
  // nwarps, ...); past the last, the first is selected again and not
  // stored.
  constexpr int NSEL = 2;
  const int nq = nty * ntx;
  for (int q = warp; q < nq; q += NSEL * nwarps) {
    int qs[NSEL];
    const unsigned short* rows[NSEL];
#pragma unroll
    for (int j = 0; j < NSEL; ++j) {
      qs[j] = q + j * nwarps < nq ? q + j * nwarps : q;
      rows[j] = keys + ((qs[j] / ntx) * p.tx + qs[j] % ntx) * w3;
    }
    int key[NSEL];
    bm4d::warp_topk<NSEL>(rows, low, w3, p.K, lane, key);
#pragma unroll
    for (int j = 0; j < NSEL; ++j) {
      if (j > 0 && qs[j] == q) continue;
      const int gj = gj0 + qs[j] / ntx, gk = gk0 + qs[j] % ntx;
      bm4d::store_starts(static_cast<int*>(p.out), p.n * R,
                         n * R + ((long long)gi * p.gy + gj) * p.gx + gk,
                         p.K, lane, key[j], S * gi, S * gj, S * gk, half);
    }
  }
}

template <int BT, int ST, int TYT, int D, int SYT, int SZT, bool TABLE>
int launch(const Params& p, size_t shared, int threads, cudaStream_t s) {
  auto kernel = bm4d_match_kernel<BT, ST, TYT, D, SYT, SZT, TABLE>;
  // The dynamic shared memory this instance may use, per device (0: the
  // default 48 KB): the attribute belongs to the current device, so a
  // process that launches on several cards raises it on each. A size, not
  // smem_attr.cuh's bit: an instance asks for what the call's tile plan
  // needs (its pitches), which differs between calls, and each increase
  // has to be allowed.
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  size_t& limit = allowed[dev & 63];
  if (shared > 48 * 1024 && shared > limit) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shared);
    if (e != cudaSuccess) return (int)e;
    limit = shared;
  }
  const unsigned blocks =
      (unsigned)p.n * p.gz * p.tiles_y * (unsigned)p.tiles_x;
  kernel<<<blocks, threads, shared, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool TABLE>
int run(Params p, int d, int threads, void* stream) {
  const int w3 = p.W * p.W * p.W;
  p.tiles_y = (p.gy + p.ty - 1) / p.ty;
  p.tiles_x = (p.gx + p.tx - 1) / p.tx;
  p.uz = p.B + p.W - 1;
  p.uy = (p.ty - 1) * p.S + p.B + p.W - 1;
  p.ux = (p.tx - 1) * p.S + p.B + p.W - 1;
  if (d < 1 || p.W % d || p.sy < p.ux || p.sz < p.uy * p.sy ||
      threads < 32 || threads > THREADS_MAX || threads % 32)
    return (int)cudaErrorInvalidValue;
  p.groups = p.W / d;
  p.tasks = p.W * p.groups * p.W;
  // The union; for the instances of blocks of 4 (fast), 16-byte aligned
  // and followed by the float4 reference rows; then the keys' low halves and
  // the keys. _match_plan computes the same bytes.
  const bool fast = p.B == 4 && p.S == 3 && (p.ty == 3 || p.ty == 4);
  size_t shared = sizeof(float) * p.uz * p.sz;
  if (fast)
    shared = ((shared + 15) & ~(size_t)15) +
             16 * (size_t)((p.tx - 1) * p.S + p.B) * ((p.ty - 1) * p.S + p.B);
  if (!TABLE)
    shared += sizeof(unsigned short) *
              (((w3 + 7) & ~7) + (size_t)p.ty * p.tx * w3);
  if (shared > MAX_SHARED) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast && p.ty == 4) {
    // The plan's pitches at search 9 for tiles up to 7 columns wide.
    if (d == 3 && p.sy == 35 && p.sz == 763)
      return launch<4, 3, 4, 3, 35, 763, TABLE>(p, shared, threads, s);
    if (d == 3) return launch<4, 3, 4, 3, 0, 0, TABLE>(p, shared, threads, s);
    if (d == 1) return launch<4, 3, 4, 1, 0, 0, TABLE>(p, shared, threads, s);
  }
  if (fast) {  // tiles of 3 rows: 21 reference rows (64^3) in 7 tiles
    if (d == 3 && p.sy == 35 && p.sz == 635)
      return launch<4, 3, 3, 3, 35, 635, TABLE>(p, shared, threads, s);
    if (d == 3) return launch<4, 3, 3, 3, 0, 0, TABLE>(p, shared, threads, s);
    if (d == 1) return launch<4, 3, 3, 1, 0, 0, TABLE>(p, shared, threads, s);
  }
  if (d == 1 && p.B <= MAXB && p.ty <= MAXTY)
    return launch<0, 0, 0, 1, 0, 0, TABLE>(p, shared, threads, s);
  return (int)cudaErrorInvalidValue;
}

Params params(const void* gp, int n, int zp, int yp, int xp, int gz, int gy,
              int gx, int block, int step, int W, int K, int ty, int tx,
              int sy, int sz, void* out) {
  Params p{};
  p.gp = static_cast<const float*>(gp);
  p.n = n, p.zp = zp, p.yp = yp, p.xp = xp;
  p.gz = gz, p.gy = gy, p.gx = gx;
  p.B = block, p.S = step, p.W = W, p.K = K;
  p.ty = ty, p.tx = tx, p.sy = sy, p.sz = sz;
  p.out = out;
  return p;
}

}  // namespace

// C entry points, bound with ctypes. gp: (n, zp, yp, xp) f32, n guides
// padded by W / 2 per side, contiguous; (gz, gy, gx) the reference grid of
// one guide. The tile (ty, tx), the offsets per lane d, the shared pitches
// (sy, sz) and the threads per block come from the wrapper's plan
// (_match_plan); an instance that does not take them returns
// cudaErrorInvalidValue. Both launch on `stream`, do not synchronise, and
// return the cudaError_t of the launch.

// out: (3, n * R, K) int32 starts (z, y, x), best first; 1 <= K <= 32.
extern "C" int bm4d_match_topk_f32(const void* gp, int n, int zp, int yp,
                                   int xp, int gz, int gy, int gx, int block,
                                   int step, int W, int K, int ty, int tx,
                                   int d, int sy, int sz, int threads,
                                   void* out, void* stream) {
  return run<false>(params(gp, n, zp, yp, xp, gz, gy, gx, block, step, W, K,
                           ty, tx, sy, sz, out),
                    d, threads, stream);
}

// table: (n * R, W^3) bf16, offsets in (dz, dy, dx) order.
extern "C" int bm4d_match_table_f32(const void* gp, int n, int zp, int yp,
                                    int xp, int gz, int gy, int gx, int block,
                                    int step, int W, int ty, int tx, int d,
                                    int sy, int sz, int threads, void* table,
                                    void* stream) {
  return run<true>(params(gp, n, zp, yp, xp, gz, gy, gx, block, step, W, 0,
                          ty, tx, sy, sz, table),
                   d, threads, stream);
}
