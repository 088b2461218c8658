// The forward 3x3x3 SAME conv kernels of csrc/nb_conv3d.cu (the design note
// is there), kept in a header so that blocked_conv3d.cu instantiates the
// same kernels for its own entry point. Each translation unit that includes
// it gets its own copy (anonymous namespace).

#pragma once

#include "hopper_conv.cuh"

namespace {

constexpr int MODE_HALO = 0, MODE_FLAT = 1, MODE_PANEL = 2, MODE_RES = 3;

struct Params {
  const uint16_t* xa;  // (B, D, H, W, ca) bf16 bits
  const uint16_t* xb;  // (B, D, H, W, cb) bf16 bits, or null when cb == 0
  const uint16_t* w;   // (27, ca + cb, cout) bf16 bits
  uint16_t* out;       // (B, D, H, W, cout) bf16 bits
  float* ws1;          // (B, ws_rows, cout) per-unit Σy, or s1
  float* ws2;          // (B, ws_rows, cout) per-unit Σy², or s2
  int ca, cb, cin, cout;
  int D, H, W, dhw;
  int B, tiles, tiles_y, tiles_x;
  int ws_rows;         // statistics units per batch element (store_tile)
  int nch_a, nchunks;  // 32-channel chunks of segment a, of both
  int debug;           // bit 0: tap 0 reads tap 1's view (planted fault)
};

// A is K-major: lbo = the next 8 channels, sbo = the next 8 rows. B is the
// [n8][k][8] weight slice read MN-major: lbo = the next 8 k (128 B), sbo =
// the next 8 n (CK * 16 B).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return make_desc(addr, 128, CK * 16);
}

// ---- Shared-memory plan --------------------------------------------------

template <int MODE, int BN, int WG>
struct Smem {
  static constexpr int M = 64 * WG;                  // voxels per block
  // A step is TPS taps of one chunk; the ring has STAGES steps and loads
  // PF steps ahead (3 at BN = 32, where a step is short).
  static constexpr int TPS = 3;
  static constexpr int SPC = 27 / TPS;                // steps per chunk
  static constexpr int STAGES = BN == 32 ? 5 : 4;
  static constexpr int PF = STAGES - 2;
  static constexpr int HV = (WG + 2) * HXY * HXY;     // halo voxels
  static constexpr int HALO_BYTES = 4 * HV * 16;      // one chunk's halo
  static constexpr int A_TAP = 4 * M * 16;            // FLAT / PANEL A tile
  static constexpr int B_SLICE = BN * CK * 2;         // one tap's weights
  static constexpr int A_BYTES = MODE == MODE_HALO   ? 2 * HALO_BYTES
                                 : MODE == MODE_FLAT ? STAGES * TPS * A_TAP
                                                     : A_TAP + HV * 2;
  static constexpr int B_OFF = (A_BYTES + 127) / 128 * 128;
  static constexpr int LOOP_BYTES = B_OFF + STAGES * TPS * B_SLICE;
  static constexpr int OUT_LD = BN + 8;               // bf16, epilogue tile
  static constexpr int OUT_BYTES = M * OUT_LD * 2;
  static constexpr int RED_OFF =
      ((LOOP_BYTES > OUT_BYTES ? LOOP_BYTES : OUT_BYTES) + 127) / 128 * 128;
  static constexpr int BYTES = RED_OFF + 32 * WG * BN;  // [WG][2][4][BN]
};

// Epilogue of one tile: round once into a shared tile (ot_smem, M x (BN+8)
// bf16) and store it as 16-byte vectors; with STATS also each warpgroup's
// unit sums (red_smem, WG x 2 x 4 x BN f32). Called by every thread.
//
// A statistics unit is what one warpgroup's m64 rows cover: one z plane of
// an 8 x 8 tile (HALO, PANEL, RES), or 64 consecutive voxels (FLAT). Per
// channel it is summed from the accumulators in one fixed tree: a thread's
// two rows, the 8 row groups of a warp by xor shuffles, then the 4 warps in
// order, with _rn intrinsics so no sum is contracted. The tree depends on
// neither BN nor WG, and the unit's workspace row on neither the tile nor
// the batch slot, so an element's sums are the same bits in any plan.
template <int MODE, int BN, int WG, bool STATS, bool ODD = false>
__device__ __forceinline__ void store_tile(const Params& p, const Acc<BN>& acc,
                                           unsigned char* ot_smem,
                                           unsigned char* red_smem, int b,
                                           int n0, int x0, int y0, int z0,
                                           int m0) {
  // Fragment: this thread holds rows r0 and r0 + 8 of its warpgroup's m64
  // block, columns 8 i + 2 (lane % 4) + {0, 1}.
  constexpr int NT = 128 * WG, M = 64 * WG, OUT_LD = BN + 8;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const long long bvox = (long long)b * p.dhw;
  uint16_t* ot = reinterpret_cast<uint16_t*>(ot_smem);
  float* red = reinterpret_cast<float*>(red_smem);
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  // Rows r0 and r0 + 8 in the volume; this warpgroup's unit.
  bool ok0, ok1, unit_ok;
  long long unit;
  if (MODE == MODE_FLAT) {
    ok0 = m0 + r0 < p.dhw;
    ok1 = m0 + r0 + 8 < p.dhw;
    unit_ok = m0 + wg * 64 < p.dhw;
    unit = (m0 + wg * 64) / 64;
  } else {
    const int x = x0 + (lane >> 2), y = y0 + 2 * warp, z = z0 + wg;
    ok0 = x < p.W && y < p.H && z < p.D;
    ok1 = x < p.W && y + 1 < p.H && z < p.D;
    unit_ok = z < p.D;
    unit = ((long long)z * p.tiles_y + y0 / 8) * p.tiles_x + x0 / 8;
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = i * 8 + (lane & 3) * 2;
    const __nv_bfloat162 v0 =
        __floats2bfloat162_rn(acc.d[4 * i], acc.d[4 * i + 1]);
    const __nv_bfloat162 v1 =
        __floats2bfloat162_rn(acc.d[4 * i + 2], acc.d[4 * i + 3]);
    *reinterpret_cast<__nv_bfloat162*>(ot + r0 * OUT_LD + col) = v0;
    *reinterpret_cast<__nv_bfloat162*>(ot + (r0 + 8) * OUT_LD + col) = v1;
    if (STATS) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float a = ok0 ? (j ? __high2float(v0) : __low2float(v0)) : 0.f;
        const float c = ok1 ? (j ? __high2float(v1) : __low2float(v1)) : 0.f;
        float t1 = __fadd_rn(a, c);
        float t2 = __fadd_rn(__fmul_rn(a, a), __fmul_rn(c, c));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          t1 = __fadd_rn(t1, __shfl_xor_sync(0xffffffffu, t1, off));
          t2 = __fadd_rn(t2, __shfl_xor_sync(0xffffffffu, t2, off));
        }
        if (lane < 4) {
          red[(wg * 8 + warp) * BN + col + j] = t1;
          red[(wg * 8 + 4 + warp) * BN + col + j] = t2;
        }
      }
    }
  }
  __syncthreads();
  if (STATS) {
    const int c = tid & 127;
    if (c < BN && unit_ok && n0 + c < p.cout) {
      const float* q1 = red + wg * 8 * BN + c;
      const float* q2 = q1 + 4 * BN;
      const float u1 =
          __fadd_rn(__fadd_rn(__fadd_rn(q1[0], q1[BN]), q1[2 * BN]),
                    q1[3 * BN]);
      const float u2 =
          __fadd_rn(__fadd_rn(__fadd_rn(q2[0], q2[BN]), q2[2 * BN]),
                    q2[3 * BN]);
      const long long o = ((long long)b * p.ws_rows + unit) * p.cout + n0 + c;
      p.ws1[o] = u1;
      p.ws2[o] = u2;
    }
  }
  auto row_voxel = [&](int r) -> long long {  // -1: outside the volume
    if (MODE == MODE_FLAT) {
      const int v = m0 + r;
      return v < p.dhw ? v : -1;
    }
    const int z = z0 + (r >> 6), y = y0 + ((r >> 3) & 7), x = x0 + (r & 7);
    if (z >= p.D || y >= p.H || x >= p.W) return -1;
    return ((long long)z * p.H + y) * p.W + x;
  };
  if (ODD) {
    // Rows that are not 16-byte aligned: element stores, none past Cout.
    for (int e = tid; e < M * BN; e += NT) {
      const int r = e / BN, c = e % BN;
      const long long vox = row_voxel(r);
      if (vox < 0 || n0 + c >= p.cout) continue;
      p.out[(bvox + vox) * p.cout + n0 + c] = ot[r * OUT_LD + c];
    }
    return;
  }
  constexpr int NV = BN / 8;
  for (int e = tid; e < M * NV; e += NT) {
    const int r = e / NV, v = e % NV;
    const long long vox = row_voxel(r);
    if (vox < 0 || n0 + v * 8 >= p.cout) continue;
    *reinterpret_cast<uint4*>(p.out + (bvox + vox) * p.cout + n0 + v * 8) =
        *reinterpret_cast<const uint4*>(ot + r * OUT_LD + v * 8);
  }
}

// ---- The conv kernel -----------------------------------------------------

template <int MODE, int BN, int WG, bool STATS, bool ODD>
__global__ void __launch_bounds__(128 * WG, 1)
    nb_conv3d_kernel(const Params p) {
  using S = Smem<MODE, BN, WG>;
  constexpr int NT = 128 * WG;
  constexpr int M = S::M;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int tile = blockIdx.x;
  const long long bvox = (long long)b * p.dhw;

  // Tile origin (HALO / PANEL) or first voxel (FLAT).
  int x0 = 0, y0 = 0, z0 = 0, m0 = 0;
  if (MODE == MODE_FLAT) {
    m0 = tile * M;
  } else {
    int t = tile;
    x0 = (t % p.tiles_x) * 8;
    t /= p.tiles_x;
    y0 = (t % p.tiles_y) * 8;
    z0 = (t / p.tiles_y) * WG;
  }

  Acc<BN> acc;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc.d[i] = 0.f;

  // Weight slices of one step, taps tap0 .. tap0 + ntaps: rows
  // (tap0 + t) * cin + rowoff + kr (kr < kvalid) of the (27 * cin, cout)
  // matrix, columns n0 .. n0 + BN, each into [n8][kr][8].
  auto load_weights = [&](int stage, int tap0, int ntaps, int rowoff,
                          int kvalid) {
    if (ODD) {
      // Cout that is no multiple of 8: the rows are not 16-byte aligned.
      // Element loads into the same layout, zeros past Cout.
      uint16_t* dst = reinterpret_cast<uint16_t*>(
          smem + S::B_OFF + stage * S::TPS * S::B_SLICE);
      for (int e = tid; e < ntaps * CK * BN; e += NT) {
        const int n = e % BN, kr = (e / BN) % CK, t = e / (BN * CK);
        const long long krow = (long long)(tap0 + t) * p.cin + rowoff + kr;
        dst[t * (S::B_SLICE / 2) + ((n >> 3) * CK + kr) * 8 + (n & 7)] =
            kr < kvalid && n0 + n < p.cout ? p.w[krow * p.cout + n0 + n]
                                           : (uint16_t)0;
      }
      return;
    }
    const uint32_t dst0 = sbase + S::B_OFF + stage * S::TPS * S::B_SLICE;
    constexpr int NV = BN / 8;
    for (int e = tid; e < ntaps * CK * NV; e += NT) {
      const int n8 = e % NV, kr = (e / NV) % CK, t = e / (NV * CK);
      const int n = n0 + n8 * 8;
      const bool ok = kr < kvalid && n < p.cout;
      const long long krow = (long long)(tap0 + t) * p.cin + rowoff + kr;
      const uint16_t* src = ok ? p.w + krow * p.cout + n : p.w;
      cp_async16(dst0 + t * S::B_SLICE + (n8 * CK + kr) * 16, src, ok);
    }
  };

  if (MODE == MODE_PANEL) {
    // ---- Cin = 1: one-channel halo -> 27 -> 32 im2col panel, one step.
    const uint32_t panel = sbase;                    // [c8][M][8]
    uint16_t* h1 = reinterpret_cast<uint16_t*>(smem + S::A_TAP);
    load_weights(0, 0, 1, 0, 27);
    cp_async_commit();
    for (int hv = tid; hv < S::HV; hv += NT) {
      const int z = z0 - 1 + hv / (HXY * HXY);
      const int y = y0 - 1 + (hv / HXY) % HXY;
      const int x = x0 - 1 + hv % HXY;
      uint16_t v = 0;
      if (z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W)
        v = p.xa[bvox + ((long long)z * p.H + y) * p.W + x];
      h1[hv] = v;
    }
    __syncthreads();
    for (int e = tid; e < M * 4; e += NT) {
      const int r = e >> 2, c8 = e & 3;
      const int rz = r >> 6, ry = (r >> 3) & 7, rx = r & 7;
      uint16_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int k = c8 * 8 + j;
        if (k == 0 && (p.debug & 1)) k = 1;
        v[j] = k < 27 ? h1[((rz + k / 9) * HXY + ry + (k / 3) % 3) * HXY +
                           rx + k % 3]
                      : (uint16_t)0;
      }
      uint4 q;
      q.x = v[0] | ((uint32_t)v[1] << 16);
      q.y = v[2] | ((uint32_t)v[3] << 16);
      q.z = v[4] | ((uint32_t)v[5] << 16);
      q.w = v[6] | ((uint32_t)v[7] << 16);
      *reinterpret_cast<uint4*>(smem + (c8 * M + r) * 16) = q;
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      wgmma_k16(acc,
                make_desc(panel + wg * 64 * 16 + ks * 2 * M * 16, M * 16,
                          128),
                desc_b(sbase + S::B_OFF + ks * 256));
    }
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    // ---- HALO / FLAT: steps (chunk, tap) through the cp.async ring.
    // FLAT: this thread's two (row, c8) slots of the gathered A tile.
    int fz[2], fy[2], fx[2];
    bool fv[2];
    if (MODE == MODE_FLAT) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = m0 + ((tid + i * NT) >> 2);
        fv[i] = v < p.dhw;
        const int q = fv[i] ? v : 0;
        fz[i] = q / (p.H * p.W);
        fy[i] = (q / p.W) % p.H;
        fx[i] = q % p.W;
      }
    }

    auto issue = [&](int q) {
      const int ci = q / S::SPC, tap0 = (q % S::SPC) * S::TPS;
      const bool seg_b = ci >= p.nch_a;
      const int c0 = (seg_b ? ci - p.nch_a : ci) * CK;
      const int cs = seg_b ? p.cb : p.ca;
      const uint16_t* xs = seg_b ? p.xb : p.xa;
      load_weights(q % S::STAGES, tap0, S::TPS, (seg_b ? p.ca : 0) + c0,
                   min(CK, cs - c0));
      if (MODE == MODE_HALO && tap0 == 0) {
        const uint32_t hb = sbase + (ci & 1) * S::HALO_BYTES;
        if ((cs & 7) == 0) {
          load_halo<WG + 2, NT>(hb, xs, cs, c0, bvox, x0, y0, z0, p.D, p.H,
                                  p.W);
        } else {
          // Channel counts that are no multiple of 8: element loads.
          uint16_t* hp = reinterpret_cast<uint16_t*>(
              smem + (ci & 1) * S::HALO_BYTES);
          for (int e = tid; e < S::HV * CK; e += NT) {
            const int hv = e / CK, c = e % CK;
            const int z = z0 - 1 + hv / (HXY * HXY);
            const int y = y0 - 1 + (hv / HXY) % HXY;
            const int x = x0 - 1 + hv % HXY;
            uint16_t v = 0;
            if (c0 + c < cs && z >= 0 && z < p.D && y >= 0 && y < p.H &&
                x >= 0 && x < p.W)
              v = xs[(bvox + ((long long)z * p.H + y) * p.W + x) * cs + c0 +
                     c];
            hp[((c >> 3) * S::HV + hv) * 8 + (c & 7)] = v;
          }
        }
      }
      for (int tt = 0; MODE == MODE_FLAT && tt < S::TPS; ++tt) {
        const int tap = tap0 + tt;
        const int t = (tap == 0 && (p.debug & 1)) ? 1 : tap;
        const int dz = t / 9 - 1, dy = (t / 3) % 3 - 1, dx = t % 3 - 1;
        const uint32_t ab =
            sbase + ((q % S::STAGES) * S::TPS + tt) * S::A_TAP;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = tid + i * NT;
          const int r = e >> 2, c8 = e & 3;
          const int z = fz[i] + dz, y = fy[i] + dy, x = fx[i] + dx;
          const bool ok = fv[i] && c0 + c8 * 8 < cs && z >= 0 && z < p.D &&
                          y >= 0 && y < p.H && x >= 0 && x < p.W;
          const uint16_t* src =
              ok ? xs + (bvox + ((long long)z * p.H + y) * p.W + x) * cs + c0 +
                       c8 * 8
                 : xs;
          cp_async16(ab + (c8 * M + r) * 16, src, ok);
        }
      }
    };

    const int nsteps = p.nchunks * S::SPC;
#pragma unroll 1
    for (int q = 0; q < S::PF; ++q) {
      if (q < nsteps) issue(q);
      cp_async_commit();
    }
#pragma unroll 1
    for (int s = 0; s < nsteps; ++s) {
      // Step s's copies are done (this thread's), visible to the async
      // proxy, and every thread is past step s-1: the buffers of step s-2,
      // whose wgmma group has completed, may be refilled.
      cp_async_wait<S::PF - 1>();
      fence_proxy_async();
      __syncthreads();
      if (s + S::PF < nsteps) issue(s + S::PF);
      cp_async_commit();

      const int ci = s / S::SPC, tap0 = (s % S::SPC) * S::TPS;
      const int stage = s % S::STAGES;
      const uint32_t lbo_a = MODE == MODE_HALO ? S::HV * 16 : M * 16;
      const uint32_t sbo_a = MODE == MODE_HALO ? HXY * 16 : 128;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_acc(acc.d[i]);
      wgmma_fence();
#pragma unroll
      for (int tt = 0; tt < S::TPS; ++tt) {
        const int tap = tap0 + tt;
        uint32_t a0;
        if (MODE == MODE_HALO) {
          const int t = (tap == 0 && (p.debug & 1)) ? 1 : tap;
          const int tv = ((t / 9 + wg) * HXY + (t / 3) % 3) * HXY + t % 3;
          a0 = sbase + (ci & 1) * S::HALO_BYTES + tv * 16;
        } else {
          a0 = sbase + (stage * S::TPS + tt) * S::A_TAP + wg * 64 * 16;
        }
        const uint32_t b0 =
            sbase + S::B_OFF + (stage * S::TPS + tt) * S::B_SLICE;
        wgmma_k16(acc, make_desc(a0, lbo_a, sbo_a), desc_b(b0));
        wgmma_k16(acc, make_desc(a0 + 2 * lbo_a, lbo_a, sbo_a),
                  desc_b(b0 + 256));
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    cp_async_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_acc(acc.d[i]);
  __syncthreads();  // every warpgroup is done with the loop's buffers

  store_tile<MODE, BN, WG, STATS, ODD>(p, acc, smem, smem + S::RED_OFF, b, n0,
                                       x0, y0, z0, m0);
}

// RES mode: a persistent block (two warpgroups, BN = 32) keeps ALL the
// weights of its 32 output channels in shared memory (27 taps x 1 or 2
// chunks, up to 108 KB, loaded once) and walks over the 8 x 8 x 2 tiles
// blockIdx.x, + gridDim.x, ... . A step is one (tile, chunk): its halo
// comes through a ring of 4 buffers loaded 2 steps ahead, so the next
// tiles' halos stream in while this one computes, and the 27 taps are 54
// wgmma k16 against the resident weights. For the 32- and 64-channel
// stages, where a tile's work is short and the weight slices were as many
// bytes as the halo, this takes the weights off the load path.
constexpr int RES_HS = 4;  // halo ring
template <bool STATS>
__global__ void __launch_bounds__(256, 1) nb_conv3d_kernel_res(const Params p) {
  constexpr int BN = 32, WG = 2, NT = 256, PF = RES_HS - 2;
  constexpr int HV = (WG + 2) * HXY * HXY, HALO_BYTES = 4 * HV * 16;
  constexpr int B_SLICE = BN * CK * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.y * BN;
  const int halo_off = p.nchunks * 27 * B_SLICE;
  const int ot_off = halo_off + RES_HS * HALO_BYTES;
  const int red_off = ot_off + 64 * WG * (BN + 8) * 2;
  const int total = p.B * p.tiles;
  const int mine = total > (int)blockIdx.x
                       ? (total - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int nsteps = mine * p.nchunks;

  auto origin = [&](int f, int& b, int& tile, int& x0, int& y0, int& z0) {
    b = f / p.tiles;
    tile = f % p.tiles;
    x0 = (tile % p.tiles_x) * 8;
    y0 = (tile / p.tiles_x % p.tiles_y) * 8;
    z0 = tile / (p.tiles_x * p.tiles_y) * WG;
  };
  auto issue = [&](int q) {
    int b, tile, x0, y0, z0;
    origin(blockIdx.x + (q / p.nchunks) * gridDim.x, b, tile, x0, y0, z0);
    const int ci = q % p.nchunks;
    const bool seg_b = ci >= p.nch_a;
    load_halo<WG + 2, NT>(sbase + halo_off + (q % RES_HS) * HALO_BYTES,
                          seg_b ? p.xb : p.xa, seg_b ? p.cb : p.ca,
                          (seg_b ? ci - p.nch_a : ci) * CK,
                          (long long)b * p.dhw, x0, y0, z0, p.D, p.H, p.W);
  };

  // All weights of this block's channels: slice (chunk, tap) as [n8][k][8].
  for (int e = tid; e < p.nchunks * 27 * CK * 4; e += NT) {
    const int n8 = e & 3, kr = (e >> 2) % CK, sl = e / (4 * CK);
    const int ci = sl / 27, tap = sl % 27;
    const bool seg_b = ci >= p.nch_a;
    const int c0 = (seg_b ? ci - p.nch_a : ci) * CK;
    const int n = n0 + n8 * 8;
    const bool ok = c0 + kr < (seg_b ? p.cb : p.ca) && n < p.cout;
    const long long krow =
        (long long)tap * p.cin + (seg_b ? p.ca : 0) + c0 + kr;
    cp_async16(sbase + sl * B_SLICE + (n8 * CK + kr) * 16,
               ok ? p.w + krow * p.cout + n : p.w, ok);
  }
#pragma unroll 1
  for (int q = 0; q < PF; ++q) {
    if (q < nsteps) issue(q);
    cp_async_commit();
  }
  Acc<BN> acc;
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<PF - 1>();
    fence_proxy_async();
    __syncthreads();
    if (s + PF < nsteps) issue(s + PF);
    cp_async_commit();
    const int ci = s % p.nchunks;
    if (ci == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc.d[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_acc(acc.d[i]);
    wgmma_fence();
    const uint32_t hb = sbase + halo_off + (s % RES_HS) * HALO_BYTES;
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int t = (tap == 0 && (p.debug & 1)) ? 1 : tap;
      const int tv = ((t / 9 + wg) * HXY + (t / 3) % 3) * HXY + t % 3;
      const uint32_t a0 = hb + tv * 16;
      const uint32_t b0 = sbase + (ci * 27 + tap) * B_SLICE;
      wgmma_k16(acc, make_desc(a0, HV * 16, HXY * 16), desc_b(b0));
      wgmma_k16(acc, make_desc(a0 + 2 * HV * 16, HV * 16, HXY * 16),
                desc_b(b0 + 256));
    }
    wgmma_commit();
    if (ci == p.nchunks - 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_acc(acc.d[i]);
      int b, tile, x0, y0, z0;
      origin(blockIdx.x + (s / p.nchunks) * gridDim.x, b, tile, x0, y0, z0);
      // The next tile's epilogue comes after at least one loop-top barrier,
      // so it cannot overwrite the output tile or the unit sums early.
      store_tile<MODE_HALO, BN, WG, STATS>(p, acc, smem + ot_off,
                                           smem + red_off, b, n0, x0, y0, z0,
                                           0);
    } else {
      wgmma_wait<1>();
    }
  }
  cp_async_wait<0>();
}

// Shared bytes of nb_conv3d_kernel_res for nchunks chunks.
int res_smem_bytes(int nchunks) {
  return nchunks * 27 * 32 * CK * 2 + RES_HS * 4 * 400 * 16 + 128 * 40 * 2 +
         2 * 256 * 4;
}

// Fixed-order sum of the per-unit statistics: thread (ty, tx) of block
// (n-group, b) sums, for channel n, units ty + 32 (4 j + u) into partial u
// (four independent sums keep four loads in flight), adds the four in order,
// and the 32 rows are then added in ty order. The order depends only on the
// unit count, which the volume's extents fix.
__global__ void __launch_bounds__(1024)
    nb_stats_reduce_kernel(const float* ws1, const float* ws2, float* s1,
                           float* s2, int tiles, int cout) {
  __shared__ float part[2][32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int b = blockIdx.y, n = blockIdx.x * 32 + tx;
  float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
  if (n < cout) {
    const long long base = (long long)b * tiles * cout + n;
    for (int t0 = ty; t0 < tiles; t0 += 128) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + 32 * u;
        if (t < tiles) {
          a1[u] += ws1[base + (long long)t * cout];
          a2[u] += ws2[base + (long long)t * cout];
        }
      }
    }
  }
  part[0][ty][tx] = (a1[0] + a1[1]) + (a1[2] + a1[3]);
  part[1][ty][tx] = (a2[0] + a2[1]) + (a2[2] + a2[3]);
  __syncthreads();
  if (ty == 0 && n < cout) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      t1 += part[0][i][tx];
      t2 += part[1][i][tx];
    }
    s1[(long long)b * cout + n] = t1;
    s2[(long long)b * cout + n] = t2;
  }
}

template <int MODE, int BN, int WG, bool STATS, bool ODD = false>
int launch(const Params& p, dim3 grid, cudaStream_t s) {
  using S = Smem<MODE, BN, WG>;
  auto k = nb_conv3d_kernel<MODE, BN, WG, STATS, ODD>;
  static unsigned long long done = 0;
  cudaError_t e = allow_smem(k, S::BYTES, done);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, 128 * WG, S::BYTES, s>>>(p);
  return (int)cudaGetLastError();
}

template <int MODE, int WG, bool STATS>
int launch_bn(const Params& p, int bn, dim3 grid, cudaStream_t s) {
  // Cout that is no multiple of 8 has its own instances (element loads of
  // the taps, element stores of y), at BN = 32, the only tile _plan gives
  // such widths; the others are not touched by it.
  if (p.cout & 7)
    return bn == 32 ? launch<MODE, 32, WG, STATS, true>(p, grid, s)
                    : (int)cudaErrorInvalidValue;
  switch (bn) {
    case 32: return launch<MODE, 32, WG, STATS>(p, grid, s);
    case 64: return launch<MODE, 64, WG, STATS>(p, grid, s);
    case 128: return launch<MODE, 128, WG, STATS>(p, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool STATS>
int launch_res(const Params& p, dim3 grid, cudaStream_t s) {
  auto k = nb_conv3d_kernel_res<STATS>;
  static unsigned long long done = 0;
  cudaError_t e = allow_smem(k, res_smem_bytes(2), done);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, 256, res_smem_bytes(p.nchunks), s>>>(p);
  return (int)cudaGetLastError();
}

template <bool STATS>
int dispatch(const Params& p, int mode, int bn, int wg, dim3 grid,
             cudaStream_t s) {
  if (mode == MODE_RES && bn == 32 && wg == 2)
    return launch_res<STATS>(p, grid, s);
  if (mode == MODE_HALO && wg == 2)
    return launch_bn<MODE_HALO, 2, STATS>(p, bn, grid, s);
  if (mode == MODE_HALO && wg == 1)
    return launch_bn<MODE_HALO, 1, STATS>(p, bn, grid, s);
  if (mode == MODE_FLAT && wg == 1)
    return launch_bn<MODE_FLAT, 1, STATS>(p, bn, grid, s);
  if (mode == MODE_PANEL && wg == 2)
    return launch_bn<MODE_PANEL, 2, STATS>(p, bn, grid, s);
  return (int)cudaErrorInvalidValue;
}


// The body of the C entry points (nb_conv3d_bf16, blocked_conv3d_bf16).
// The plan (mode 0 halo / 1 flat / 2 panel / 3 resident, bn, wg, tiles per
// batch element, and for mode 3 the persistent blocks per channel tile,
// pblocks) comes from
// exaspim_tpu_torch/ops/nb_conv.py:_plan, which also checks shapes and
// layouts. Any cout (rows that are no multiple of 8 channels are read and
// written element by element); FLAT needs ca and cb multiples of 8, PANEL
// ca == 1 and no second segment, RES bn 32, wg 2, ca, cb and cout multiples
// of 8 and at most two 32-channel chunks. With stats
// (s1 != null), s1 and s2 (B, cout) receive the sums and ws1, ws2 are f32
// scratch of (B, units, cout), every row written: units = D * ceil(H / 8) *
// ceil(W / 8) (the z planes of the 8 x 8 tiles), or ceil(D * H * W / 64)
// for FLAT. With one unit they may be null (the blocks then write s1 and
// s2, and no reduction runs); otherwise nb_stats_reduce_kernel runs after
// the conv on the same stream, a second launch. debug bit 0 plants a fault
// (tap 0 reads tap 1's view) for the checks in chip_smoke.py; the wrappers
// pass 0. Returns the cudaError_t of the launches (0 on success). Launches on
// `stream` and does not synchronise.
int conv_entry(const void* xa, const void* xb, int ca, int cb, const void* w,
               void* out, void* ws1, void* ws2, void* s1, void* s2, int B,
               int D, int H, int W, int cout, int mode, int bn, int wg,
               int tiles, int pblocks, int debug, void* stream) {
  if (ca <= 0 || cb < 0 || cout <= 0 || B <= 0 || B > 65535 || D <= 0 ||
      H <= 0 || W <= 0 || tiles <= 0)
    return (int)cudaErrorInvalidValue;
  if ((mode == MODE_FLAT || mode == MODE_RES) && (ca % 8 || cb % 8))
    return (int)cudaErrorInvalidValue;
  if (mode == MODE_RES && cout % 8) return (int)cudaErrorInvalidValue;
  if (mode == MODE_PANEL && (ca != 1 || cb != 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xa = static_cast<const uint16_t*>(xa);
  p.xb = static_cast<const uint16_t*>(cb ? xb : xa);
  p.w = static_cast<const uint16_t*>(w);
  p.out = static_cast<uint16_t*>(out);
  p.ws1 = static_cast<float*>(ws1);
  p.ws2 = static_cast<float*>(ws2);
  p.ca = ca;
  p.cb = cb;
  p.cin = ca + cb;
  p.cout = cout;
  p.D = D;
  p.H = H;
  p.W = W;
  p.dhw = D * H * W;
  p.tiles = tiles;
  p.tiles_y = (H + 7) / 8;
  p.tiles_x = (W + 7) / 8;
  p.ws_rows =
      mode == MODE_FLAT ? (p.dhw + 63) / 64 : D * p.tiles_y * p.tiles_x;
  p.nch_a = (ca + CK - 1) / CK;
  p.nchunks = p.nch_a + (cb + CK - 1) / CK;
  p.B = B;
  if (mode == MODE_RES && (p.nchunks > 2 || pblocks <= 0))
    return (int)cudaErrorInvalidValue;
  p.debug = debug;
  const long long want =
      mode == MODE_FLAT
          ? ((long long)p.dhw + 64 * wg - 1) / (64 * wg)
          : (long long)((D + wg - 1) / wg) * p.tiles_y * p.tiles_x;
  if (want != tiles) return (int)cudaErrorInvalidValue;
  const int ntiles = (cout + bn - 1) / bn;
  if (ntiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid = mode == MODE_RES ? dim3((unsigned)pblocks, ntiles, 1)
                               : dim3((unsigned)tiles, ntiles, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = s1 != nullptr;
  if (stats && p.ws_rows == 1) {
    // One row per batch element: the blocks write the sums themselves.
    p.ws1 = static_cast<float*>(s1);
    p.ws2 = static_cast<float*>(s2);
  }
  if (stats && (p.ws1 == nullptr || p.ws2 == nullptr || s2 == nullptr))
    return (int)cudaErrorInvalidValue;
  int rc = stats ? dispatch<true>(p, mode, bn, wg, grid, s)
                 : dispatch<false>(p, mode, bn, wg, grid, s);
  if (rc != 0 || !stats || p.ws_rows == 1) return rc;
  nb_stats_reduce_kernel<<<dim3((cout + 31) / 32, B), 1024, 0, s>>>(
      p.ws1, p.ws2, static_cast<float*>(s1), static_cast<float*>(s2),
      p.ws_rows, cout);
  return (int)cudaGetLastError();
}

}  // namespace
