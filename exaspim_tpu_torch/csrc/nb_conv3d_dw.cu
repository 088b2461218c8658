// Weight gradient of the 3x3x3 SAME convolution (no bias) over channels-last
// bf16 volumes, written for Hopper (sm_90a):
//
//   dW[tap, c, n] = sum over batch and voxels v of x[v + delta_tap, c] * g[v, n]
//
// accumulated in f32 and returned as (27, Cin, Cout) in DHWIO tap order.
//
// Replaces exaspim_tpu/ops/nb_conv.py:448 _dw_kernel (the Pallas TPU kernel
// behind _nb_conv_dw). It computes the same function, not the TPU's
// rolling-z slab panels. The input comes as one or two channel segments
// ([skip, up]), never concatenated; taps outside the volume read zero.
//
// What bounds it on an H100: 2 * 27 * Cin * Cout FLOP per voxel against
// 2 * (Cin + Cout) compulsory bytes: ~430 FLOP/B at 32 -> 32, above the
// ~295 FLOP/B ridge of the bf16 tensor cores, and more at the wider stages:
// operations. The Cin = 1 entry conv (27 * 32 products per voxel against 66
// bytes) is bound by the bytes of g. The design is the forward's
// (nb_conv3d.cu) with the operand roles swapped: the reduction runs over
// voxels, so the voxels are wgmma's K and the halo tile's 8-voxel x runs
// are its K rows.
//
// * Tiles. A HALO block owns one dz plane of taps (9 taps), a Cin slice of
//   64 channels (two 32-channel chunks of the segments, stacked as c8 planes
//   0-3 and 4-7 of one buffer; one chunk when Cin is 32) and a Cout tile of
//   32, and walks the voxel tiles (8 x 8 x 2 voxels of one batch element)
//   of its split in order. Per tile it stages, with 16-byte cp.async and
//   zero fill, the 2 x 10 x 10 zero-padded halo planes that its dz reads,
//   as [c8][voxel][8], and the 128-voxel g tile, as [n8][voxel][8]. Its 9
//   taps are shifted views of that shared memory: no global read, no bounds
//   check and no division in the inner loop; a tile's coordinates are
//   computed once per tile.
// * GEMM. Per tap D_tap (m64 = Cin slice, n32 = Cout tile) += X_tap^T G,
//   K = 16 voxels (two y rows of the tile) per wgmma. Both operands are read
//   MN-major straight from shared memory through no-swizzle descriptors: an
//   8-voxel x run is one 128-byte core matrix (8 k rows of 8 channels) for
//   every tap, the next 8 k are the next y row (160 B on in the halo, 128 B
//   in the g tile), the next 8 of M or N the next c8 / n8 plane. M is taken
//   from Cin because the slice of 64 fills an m64 when Cin >= 64; at Cin = 32
//   (32 -> 32 and 32 -> 64, the top level) HALO would pad half of each m64
//   (Cout as M would pad the same half at 32 -> 32); ZSTACK below fills it
//   with a second dz plane instead, so 27 of its 36 m64 halves carry taps.
//   mma.sync (m16n8k16) would need no padding but reads the same staged
//   tile through ldmatrix, and the loop is set by the bytes it stages, not
//   by its wgmma count (below): it was not built.
// * Accumulators and what bounds it. The 9 taps' m64n32 f32 accumulators
//   (144 registers a thread) stay in registers across the whole split. All
//   27 taps of one (slice, Cout tile) would need 84 % of the register file
//   for accumulators alone: a first version with three warpgroups per block
//   sharing one staged tile spilled and ptxas serialized its wgmma (43.8 ms
//   per training step against 15.3 for this one, NVIDIA H100 80GB HBM3,
//   700 W). So the three dz planes are three blocks that each stage their
//   own halo planes: x is read from L2 3 x 200 / 128 times per voxel and g
//   3 times per Cin slice, against 27 and 9 * Cin / 32 times before. On the
//   card both the bytes staged per tile (~1.6-2.0 TB/s of cp.async traffic
//   in all) and the wgmma count set the time: stacking two taps in one m64
//   at Cin = 32 (6 wgmma a step instead of 9, the halo staged twice) was
//   slower, 3.28 against 2.50 ms at 64^3 32 -> 32; a ring three times
//   deeper did not move it (bandwidth of the staging, not its latency);
//   ZSTACK below, fewer bytes and fewer wgmma, was faster.
//   K steps whose two y rows lie outside the volume (planes under 8 x 8)
//   and z planes past D are skipped; planes of 16 voxels (4^3) take FLAT
//   below, where no K row is padding.
// * ZSTACK mode, Cin a single chunk of at most 32 channels, a multiple of
//   8 (32 -> 32 at 64^3, 32 -> 64 at 32^3): the halo planes are staged
//   once as [z][c8][y][x], so an m64 block is the chunk's 32 channels at
//   dz (rows 0-31) and at dz + 1 (rows 32-63, SBO = one c8 sub-plane, four
//   of them make a z plane). One block of two warpgroups (dz -1 and 0;
//   dz +1) takes all 27 taps from one staged tile and one g tile: 46 %
//   fewer bytes and 18 wgmma a step for 27 taps. It took 64^3 32 -> 32
//   from 2.49-2.63 to 1.91 ms; for two-chunk slices, where it needs 36
//   wgmma for 27 taps, it was slower ((32|32) -> 32 3.78 against 3.29).
// * Pipeline. Three stages of 33 KB, loaded one tile ahead, one wgmma group
//   kept in flight across the barrier; two blocks per SM. Widths that are no
//   multiple of 8 (x segments, or Cout, whose g rows are then not 16-byte
//   aligned) are staged with element loads in the same layout; channels
//   past Cin or Cout are dropped at the store.
// * PANEL mode, Cin = 1: the one-channel halo is staged (element loads, the
//   next tile's while the tensor cores run this one) and a (27 -> 32 tap)
//   x 256-voxel panel is built from it in shared memory ([tap8][voxel][8]),
//   so M = taps and one wgmma per 16 voxels covers all 27 taps; one
//   warpgroup, 51 KB of shared memory, four blocks per SM.
// * Split-K. The voxel tiles (over the whole batch) are cut into `splits`
//   contiguous ranges, one per block row; the blocks of split 0 write their
//   partial sums to the result and those of split s > 0 to slice s - 1 of a
//   workspace (splits - 1, 27, Cin, Cout) f32, and dw_reduce_kernel adds
//   the slices to the result in index order. No float atomics: two launches
//   on the same inputs agree bit for bit. The plan (mode, splits, tiles per
//   split) is exaspim_tpu_torch/ops/nb_conv.py:_dw_plan. The partial sums
//   leave the accumulators as 8-byte pairs. (Adding the slices in the
//   kernel instead, in the last split's blocks once the others had
//   published theirs, was 1.5x slower over a step, 20.45 against 13.57 ms
//   on an NVIDIA H100 80GB HBM3 at 700 W: those blocks wait, then load the
//   other slices element by element, where the reduce kernel spreads that
//   work over the card.)
//
// * FLAT mode, planes of 16 voxels (4 x 4, 8 x 2, 16 x 1; 4^3 of a step):
//   tiles of eight whole planes of the batch staged as three dx-shifted
//   copies, so no K row is padding, and two warpgroups sharing them (see
//   dw_flat_kernel). At 4^3 HALO ran its 8 x 8 tiles at a quarter of their
//   voxels; and the time of both went mostly to the tiles' address
//   arithmetic (64-bit divisions in the copy loop), the workspace and the
//   epilogue, not to the wgmma (measured by switching each off, PERF.md).
//
// Registers (-Xptxas -v, NVIDIA H100 build): 208-212 a thread in HALO,
// ZSTACK and FLAT, 64 in PANEL, 32 in the reduce, no spills; chip_smoke.py prints
// the report and fails on a spill. Left for later: staging less at
// Cin >= 64 (the three dz blocks of a tile sharing one halo, which needs
// the 27 taps' accumulators in fewer registers: N = 64 with fewer taps per
// warpgroup, or a producer warpgroup with setmaxnreg; larger x-y tiles for
// less halo), TMA (its box cannot express the [c8][voxel] interleave), and
// FLAT for other small planes (2^3, 6^3, and 4^3 at widths that are no
// multiple of 8, run HALO with padded rows).

#include "hopper_conv.cuh"

namespace {

constexpr int MODE_HALO = 0, MODE_PANEL = 1, MODE_ZSTACK = 2, MODE_FLAT = 3;
constexpr int BN = 32;                       // Cout tile
// HALO: tiles of 8 x 8 x HZ voxels; a block stages, for its dz, the HZ
// planes of the halo that its 9 taps read (HZ x 10 x 10 voxels, 8 c8
// planes) and the g tile, in a ring of H_STAGES stages loaded one tile
// ahead; two blocks per SM.
constexpr int HZ = 2;
constexpr int H_TV = 64 * HZ;                // voxels of a tile (128)
constexpr int H_HV = HZ * HXY * HXY;         // staged halo voxels (200)
constexpr int H_X = 8 * H_HV * 16;           // 25,600 B
constexpr int H_G = 4 * H_TV * 16;           // 8,192 B
constexpr int H_STAGE = H_X + H_G;           // 33,792 B
constexpr int H_STAGES = 3;
constexpr int HALO_SMEM = H_STAGES * H_STAGE;  // 101,376 B
// PANEL: tiles of 8 x 8 x PZ voxels, the one-channel (PZ+2) x 10 x 10 halo
// twice, the panel's 4 tap8 planes (taps 0..31; the m64 block's rows
// 32..63 read the next 16 KB, the g tiles, and are dropped) and two g
// tiles; four blocks per SM.
constexpr int PZ = 4;
constexpr int P_TV = 64 * PZ;                // 256
constexpr int P_HV = (PZ + 2) * HXY * HXY;   // 600
constexpr int P_H1 = 1280;                   // one halo, bf16, padded
constexpr int P_PANEL = 4 * P_TV * 16;       // 16,384 B
constexpr int P_G = 4 * P_TV * 16;           // 16,384 B
constexpr int PANEL_SMEM = 2 * P_H1 + P_PANEL + 2 * P_G;

struct Params {
  const uint16_t* xa;  // (B, D, H, W, ca) bf16 bits
  const uint16_t* xb;  // (B, D, H, W, cb) bf16 bits (xa when cb == 0)
  const uint16_t* g;   // (B, D, H, W, cout) bf16 bits
  float* out;          // (27, cin, cout) f32: split 0's partial sums
  float* ws;           // (splits - 1, 27, cin, cout): those of splits 1..
  int ca, cb, cin, cout;
  int D, H, W, dhw;
  int tiles_x, tiles_y, tiles;  // voxel tiles of one batch element
  long long total;              // B * tiles (FLAT: tiles of the batch)
  long long total_planes;       // B * D
  long long per;                // tiles per split
  int nch_a, nchunks, ctiles;
  bool vec_x, vec_g;            // 16-byte copies of x rows, of g rows
  int debug;                    // bit 0: tap 0 reads tap 1's view
};

struct Tile {
  long long bvox;  // first voxel of the batch element
  int x0, y0, z0;
  int nz, nr;      // z planes and y-row pairs inside the volume
};

template <int ZT>
__device__ __forceinline__ Tile tile_at(const Params& p, long long f) {
  Tile t;
  const int b = (int)(f / p.tiles);
  int r = (int)(f - (long long)b * p.tiles);
  t.bvox = (long long)b * p.dhw;
  t.x0 = (r % p.tiles_x) * 8;
  r /= p.tiles_x;
  t.y0 = (r % p.tiles_y) * 8;
  t.z0 = (r / p.tiles_y) * ZT;
  t.nz = min(ZT, p.D - t.z0);
  t.nr = min(4, (p.H - t.y0 + 1) / 2);
  return t;
}

// The g tile of t (8 x 8 x ZT voxels), columns n0 .. n0 + 31, as
// [n8][voxel][8] at gb (zeros outside the volume, so padded voxels add
// nothing), by the block's 128 threads.
template <int ZT, int NT = 128>
__device__ __forceinline__ void load_g(const Params& p, uint32_t gb,
                                       uint16_t* gp, const Tile& t, int n0) {
  constexpr int TV = 64 * ZT;
  if (p.vec_g) {
    for (int e = threadIdx.x; e < TV * 4; e += NT) {
      const int v = e >> 2, n8 = e & 3;
      const int z = t.z0 + (v >> 6), y = t.y0 + ((v >> 3) & 7),
                x = t.x0 + (v & 7);
      const int n = n0 + n8 * 8;
      const bool ok = z < p.D && y < p.H && x < p.W && n < p.cout;
      const uint16_t* src =
          ok ? p.g + (t.bvox + ((long long)z * p.H + y) * p.W + x) * p.cout + n
             : p.g;
      cp_async16(gb + (n8 * TV + v) * 16, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < TV * BN; e += NT) {
      const int v = e / BN, n = e % BN;
      const int z = t.z0 + (v >> 6), y = t.y0 + ((v >> 3) & 7),
                x = t.x0 + (v & 7);
      uint16_t val = 0;
      if (z < p.D && y < p.H && x < p.W && n0 + n < p.cout)
        val = p.g[(t.bvox + ((long long)z * p.H + y) * p.W + x) * p.cout +
                  n0 + n];
      gp[((n >> 3) * TV + v) * 8 + (n & 7)] = val;
    }
  }
}

// Where this block's split writes its partial sums: the result (split 0)
// or its workspace slice.
__device__ __forceinline__ float* split_out(const Params& p) {
  return blockIdx.y == 0
             ? p.out
             : p.ws + (long long)(blockIdx.y - 1) * 27 * p.cin * p.cout;
}

// Rows r0 and r0 + 8 of the m64 accumulator (HALO: channels row_c[] of the
// input, -1 to drop; PANEL: taps) into the slice `out` of this split,
// columns n0 + 8 i + 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void store_rows(const Params& p, const Acc<BN>& a,
                                           float* out, const long long* row,
                                           int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row[half] < 0) continue;
    float* o = out + row[half] * p.cout;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + i * 8 + (lane & 3) * 2;
      const float v0 = a.d[4 * i + 2 * half], v1 = a.d[4 * i + 2 * half + 1];
      if ((p.cout & 1) == 0 && n + 1 < p.cout) {  // 8-byte aligned pair
        *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
      } else {
        if (n < p.cout) o[n] = v0;
        if (n + 1 < p.cout) o[n + 1] = v1;
      }
    }
  }
}

// HALO mode: blockIdx.x = kz + 3 * (Cout tile + ctiles * Cin slice),
// blockIdx.y = split. The block's warpgroup owns the taps kz * 9 .. + 8.
__global__ void __launch_bounds__(128, 2) dw_halo_kernel(const Params p) {
  constexpr int NACC = 9;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x;
  const int kz = blockIdx.x % 3;
  const int u = blockIdx.x / 3;
  const int ct = u % p.ctiles, slice = u / p.ctiles;
  const int n0 = ct * BN;
  const long long f0 = (long long)blockIdx.y * p.per;
  const long long f1 = min(f0 + p.per, p.total);
  const int ntile = f1 > f0 ? (int)(f1 - f0) : 0;

  // Chunk j of the slice: planes 4 j .. 4 j + 3, channels cl.. of a
  // segment of cs channels whose first is channel cg0 of the input.
  auto chunk = [&](int j, const uint16_t*& xs, int& cs, int& cl, int& cg0) {
    const int ci = 2 * slice + j;
    const bool seg_b = ci >= p.nch_a;
    xs = seg_b ? p.xb : p.xa;
    cs = seg_b ? p.cb : p.ca;
    cl = (seg_b ? ci - p.nch_a : ci) * CK;
    cg0 = seg_b ? p.ca : 0;
    return ci < p.nchunks;
  };

  // Tile i into stage i % H_STAGES: the halo planes z0 + kz - 1 ..
  // z0 + kz + HZ - 2 (those the dz = kz - 1 taps read) and the g tile.
  auto issue = [&](int i) {
    const Tile t = tile_at<HZ>(p, f0 + i);
    const int st = i % H_STAGES;
    const uint32_t hb = sbase + st * H_STAGE;
    unsigned char* hp = smem + st * H_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint16_t* xs;
      int cs, cl, cg0;
      if (!chunk(j, xs, cs, cl, cg0)) continue;
      if (p.vec_x) {
        load_halo<HZ, 128>(hb + j * 4 * H_HV * 16, xs, cs, cl, t.bvox, t.x0,
                           t.y0, t.z0 + kz, p.D, p.H, p.W);
      } else {
        // Widths that are no multiple of 8: element loads, same layout.
        uint16_t* xp = reinterpret_cast<uint16_t*>(hp) + j * 4 * H_HV * 8;
        for (int e = tid; e < H_HV * CK; e += 128) {
          const int hv = e / CK, c = e % CK;
          const int z = t.z0 + kz - 1 + hv / (HXY * HXY);
          const int y = t.y0 - 1 + (hv / HXY) % HXY;
          const int x = t.x0 - 1 + hv % HXY;
          uint16_t v = 0;
          if (cl + c < cs && z >= 0 && z < p.D && y >= 0 && y < p.H &&
              x >= 0 && x < p.W)
            v = xs[(t.bvox + ((long long)z * p.H + y) * p.W + x) * cs + cl +
                   c];
          xp[((c >> 3) * H_HV + hv) * 8 + (c & 7)] = v;
        }
      }
    }
    load_g<HZ>(p, hb + H_X, reinterpret_cast<uint16_t*>(hp + H_X), t, n0);
  };

  Acc<BN> acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t].d[i] = 0.f;

  if (ntile > 0) issue(0);
  cp_async_commit();
#pragma unroll 1
  for (int i = 0; i < ntile; ++i) {
    // Tile i is in shared memory and visible to the async proxy; every warp
    // is past tile i - 1's wgmma_wait<1>, so tile i - 2's group has
    // completed and its stage ((i + 1) % 3) is refilled now.
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (i + 1 < ntile) issue(i + 1);
    cp_async_commit();

    const Tile t = tile_at<HZ>(p, f0 + i);
    const uint32_t hb = sbase + (i % H_STAGES) * H_STAGE;
    const uint32_t gb = hb + H_X;
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) fence_acc(acc[a].d[k]);
    wgmma_fence();
#pragma unroll 1
    for (int z = 0; z < t.nz; ++z) {
#pragma unroll 1
      for (int r = 0; r < t.nr; ++r) {
        // K = voxels (x 0..7) of tile rows 2r, 2r + 1 of plane z; the
        // halo's plane z is the tile's plane z shifted by dz.
        const uint32_t a0 = hb + (z * HXY + 2 * r) * HXY * 16;
        const uint64_t db =
            make_desc(gb + (z * 64 + r * 16) * 16, 128, H_TV * 16);
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          // Accumulator a reads the view of tap (ky, kx) = (a / 3, a % 3).
          const int ky = a / 3;
          int kx = a % 3;
          if (a == 0 && kz == 0 && (p.debug & 1)) kx = 1;  // planted fault
          wgmma_k16<1>(acc[a],
                       make_desc(a0 + (ky * HXY + kx) * 16, HXY * 16,
                                 H_HV * 16),
                       db);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) fence_acc(acc[a].d[k]);
  cp_async_wait<0>();

  // Row m of the m64 block is channel m % 32 of chunk m / 32.
  const int r0 = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  float* out = split_out(p);
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    long long rr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = r0 + 8 * half, c = m & 31;
      const uint16_t* xs;
      int cs, cl, cg0;
      const bool ok = chunk(m >> 5, xs, cs, cl, cg0) && cl + c < cs;
      rr[half] = ok ? (long long)(kz * 9 + a) * p.cin + cg0 + cl + c : -1;
    }
    store_rows(p, acc[a], out, rr, n0);
  }
}

// ZSTACK mode (every segment a multiple of 8 channels): a block owns one
// 32-channel chunk and a Cout tile, stages the HZ + 2 halo planes once as
// [z][c8][y][x] (a c8 sub-plane 1600 B on, a z plane 6400 B), so that the
// m64 block of a wgmma is 32 channels at dz (rows 0..31) and at dz + 1
// (rows 32..63): warpgroup 0 takes dz = -1 and 0, warpgroup 1 dz = +1 (its
// rows 32..63 read past the halo and are dropped). All 27 taps of the chunk
// from one staged tile and one g tile.
constexpr int Z_HV = (HZ + 2) * HXY * HXY;    // 400 voxels
constexpr int Z_X = 4 * Z_HV * 16;            // 25,600 B
constexpr int Z_STAGE = Z_X + H_G;            // 33,792 B
constexpr int Z_STAGES = 3;
constexpr int ZSTACK_SMEM = Z_STAGES * Z_STAGE;

__global__ void __launch_bounds__(256, 1) dw_zstack_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ci = blockIdx.x % p.nchunks, ct = blockIdx.x / p.nchunks;
  const int n0 = ct * BN;
  const bool seg_b = ci >= p.nch_a;
  const uint16_t* xs = seg_b ? p.xb : p.xa;
  const int cs = seg_b ? p.cb : p.ca;
  const int cl = (seg_b ? ci - p.nch_a : ci) * CK;
  const int cg0 = (seg_b ? p.ca : 0) + cl;
  const long long f0 = (long long)blockIdx.y * p.per;
  const long long f1 = min(f0 + p.per, p.total);
  const int ntile = f1 > f0 ? (int)(f1 - f0) : 0;

  auto issue = [&](int i) {
    const Tile t = tile_at<HZ>(p, f0 + i);
    const uint32_t hb = sbase + (i % Z_STAGES) * Z_STAGE;
    for (int e = tid; e < Z_HV * 4; e += 256) {
      const int c8 = e & 3, hv = e >> 2;
      const int pz = hv / (HXY * HXY), yx = hv % (HXY * HXY);
      const int z = t.z0 - 1 + pz, y = t.y0 - 1 + yx / HXY,
                x = t.x0 - 1 + yx % HXY;
      const bool ok = cl + c8 * 8 < cs && z >= 0 && z < p.D && y >= 0 &&
                      y < p.H && x >= 0 && x < p.W;
      const uint16_t* src =
          ok ? xs + (t.bvox + ((long long)z * p.H + y) * p.W + x) * cs + cl +
                   c8 * 8
             : xs;
      cp_async16(hb + ((pz * 4 + c8) * HXY * HXY + yx) * 16, src, ok);
    }
    load_g<HZ, 256>(p, hb + Z_X,
                    reinterpret_cast<uint16_t*>(smem + (i % Z_STAGES) *
                                                Z_STAGE + Z_X),
                    t, n0);
  };

  Acc<BN> acc[9];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[a].d[k] = 0.f;

  if (ntile > 0) issue(0);
  cp_async_commit();
#pragma unroll 1
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (i + 1 < ntile) issue(i + 1);
    cp_async_commit();

    const Tile t = tile_at<HZ>(p, f0 + i);
    const uint32_t hb = sbase + (i % Z_STAGES) * Z_STAGE;
    const uint32_t gb = hb + Z_X;
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) fence_acc(acc[a].d[k]);
    wgmma_fence();
#pragma unroll 1
    for (int z = 0; z < t.nz; ++z) {
#pragma unroll 1
      for (int r = 0; r < t.nr; ++r) {
        const uint32_t a0 =
            hb + ((z + 2 * wg) * 4 * HXY * HXY + 2 * r * HXY) * 16;
        const uint64_t db =
            make_desc(gb + (z * 64 + r * 16) * 16, 128, H_TV * 16);
#pragma unroll
        for (int a = 0; a < 9; ++a) {
          const int ky = a / 3;
          int kx = a % 3;
          if (a == 0 && wg == 0 && (p.debug & 1)) kx = 1;  // planted fault
          wgmma_k16<1>(acc[a],
                       make_desc(a0 + (ky * HXY + kx) * 16, HXY * 16,
                                 HXY * HXY * 16),
                       db);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) fence_acc(acc[a].d[k]);
  cp_async_wait<0>();

  // Row m of warpgroup wg: channel m % 32 of the chunk at kz = 2 wg + m / 32.
  const int r0 = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  float* out = split_out(p);
#pragma unroll
  for (int a = 0; a < 9; ++a) {
    long long rr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = r0 + 8 * half, c = m & 31, kz = 2 * wg + (m >> 5);
      rr[half] = (kz < 3 && cl + c < cs)
                     ? (long long)(kz * 9 + a) * p.cin + cg0 + c
                     : -1;
    }
    store_rows(p, acc[a], out, rr, n0);
  }
}

// FLAT mode, planes of 16 voxels whose (H + 2) x W padded plane holds at
// most F_PW voxels (4 x 4, 8 x 2, 16 x 1; every segment and Cout a multiple
// of 8): the B * D planes of the batch, in order, are cut into tiles of F_ZT
// planes (a tile may span batch elements), so that a tile's K rows are its
// voxels in order with no padded row. Per tile a block stages, for its dz,
// three copies of the input planes that its taps read, each shifted by one
// dx and padded in y only: [c8][dx][plane][y + 1][x] holds
// x[b, z + dz, y, x + dx] for output plane (b, z). A tap (dy, dx) is then
// copy dx read from row dy on, and 16 consecutive voxels of a plane are 16
// consecutive rows of it (one k16 step) for every tap. Positions outside
// the plane in y or x hold zeros for every tile: the ring is zeroed once and
// they are never loaded. Two warpgroups share the staged x and own one Cout
// tile of 32 each (N = 64 a block), 9 taps each; blockIdx.x = kz + 3 *
// (Cout pair + ctiles * Cin slice), blockIdx.y = split. A tile's copies are
// computed with 32-bit plane arithmetic and shifts (W is 1, 2 or 4); two
// stages of 88 KB, one tile loaded ahead, one block per SM. Tiles of 4 or 6
// planes, and two or three tiles loaded ahead, were no faster at 4^3.
constexpr int F_ZT = 8;                          // planes of a tile
constexpr int F_HW = 16;                         // voxels of a plane
constexpr int F_PW = 24;                         // (H + 2) * W at most
constexpr int F_TV = F_ZT * F_HW;                // voxels of a tile (128)
constexpr int F_NPOS = 3 * F_ZT * F_PW;          // staged rows of a c8 plane
constexpr int F_X = 8 * F_NPOS * 16;             // 73,728 B
constexpr int F_G = 8 * F_TV * 16;               // 16,384 B
constexpr int F_STAGE = F_X + F_G;
constexpr int F_PF = 1;                          // tiles loaded ahead
constexpr int F_STAGES = F_PF + 1;
constexpr int FLAT_SMEM = F_STAGES * F_STAGE;    // 180,224 B

__global__ void __launch_bounds__(256, 1) dw_flat_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int kz = blockIdx.x % 3;
  const int u = blockIdx.x / 3;
  const int ct = u % p.ctiles, slice = u / p.ctiles;
  const int n0 = ct * 2 * BN;                    // this block's 64 columns
  const long long f0 = (long long)blockIdx.y * p.per;
  const long long f1 = min(f0 + p.per, p.total);
  const int ntile = f1 > f0 ? (int)(f1 - f0) : 0;
  const int ph = p.H + 2, wsh = __ffs(p.W) - 1;  // W is 1, 2 or 4
  const int planes = p.total_planes;

  // The x copies' positions that no tile loads stay zero (the g tiles are
  // written whole, with zero fill, for every tile).
  for (int e = tid; e < F_STAGES * F_X / 16; e += 256) {
    const int st = e / (F_X / 16);
    reinterpret_cast<uint4*>(smem + st * F_STAGE)[e - st * (F_X / 16)] =
        make_uint4(0, 0, 0, 0);
  }

  auto issue = [&](int i) {
    const int gp0 = (int)(f0 + i) * F_ZT;        // first plane of the tile
    const uint32_t sb = sbase + (i % F_STAGES) * F_STAGE;
    // x: per plane of the tile, (chunk j, c8, dx copy, y, x) of the live
    // positions.
#pragma unroll
    for (int pz = 0; pz < F_ZT; ++pz) {
      const int gp = gp0 + pz, b = gp / p.D;
      const int z = gp - b * p.D + kz - 1;
      const bool zok = gp < planes && z >= 0 && z < p.D;
      const long long vox0 = ((long long)b * p.D + z) * F_HW;
      for (int e = tid; e < 2 * 4 * 3 * F_HW; e += 256) {
        const int yx = e & (F_HW - 1), q = e >> 4;
        const int dxi = q % 3, c8 = (q / 3) & 3, j = q / 12;
        const int x = yx & (p.W - 1), xi = x + dxi - 1;
        const int ci = 2 * slice + j;
        if (xi < 0 || xi >= p.W || ci >= p.nchunks) continue;
        const bool seg_b = ci >= p.nch_a;
        const int cs = seg_b ? p.cb : p.ca;
        const int cl = (seg_b ? ci - p.nch_a : ci) * CK + c8 * 8;
        if (cl >= cs) continue;
        const uint16_t* xs = seg_b ? p.xb : p.xa;
        const uint16_t* src =
            zok ? xs + (vox0 + yx + xi - x) * cs + cl : xs;
        const int pos = ((dxi * F_ZT + pz) * ph + (yx >> wsh) + 1) * p.W + x;
        cp_async16(sb + ((j * 4 + c8) * F_NPOS + pos) * 16, src, zok);
      }
    }
    // g: the tile's voxels in order, the block's 64 columns as [n8][v][8].
    for (int e = tid; e < F_TV * 8; e += 256) {
      const int n8 = e & 7, v = e >> 3;
      const int n = n0 + n8 * 8;
      const bool ok = gp0 + (v >> 4) < planes && n < p.cout;
      const uint16_t* src =
          ok ? p.g + ((long long)gp0 * F_HW + v) * p.cout + n : p.g;
      cp_async16(sb + F_X + (n8 * F_TV + v) * 16, src, ok);
    }
  };

  Acc<BN> acc[9];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[a].d[k] = 0.f;

  __syncthreads();  // the ring is zero before any copy lands in it
#pragma unroll
  for (int q = 0; q < F_PF; ++q) {
    if (q < ntile) issue(q);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < ntile; ++i) {
    // Tile i has landed and is visible to the async proxy; every thread is
    // past tile i - 1's wgmma_wait<0>, so its stage is refilled now, F_PF
    // tiles ahead.
    cp_async_wait<F_PF - 1>();
    fence_proxy_async();
    __syncthreads();
    if (i + F_PF < ntile) issue(i + F_PF);
    cp_async_commit();

    const int nz = min(F_ZT, planes - (int)(f0 + i) * F_ZT);
    const uint32_t xb = sbase + (i % F_STAGES) * F_STAGE;
    const uint32_t gb = xb + F_X + wg * 4 * F_TV * 16;
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) fence_acc(acc[a].d[k]);
    wgmma_fence();
#pragma unroll 1
    for (int z = 0; z < nz; ++z) {
      // One k16 step: the plane's 16 voxels.
      const uint64_t db = make_desc(gb + z * F_HW * 16, 128, F_TV * 16);
#pragma unroll
      for (int a = 0; a < 9; ++a) {
        const int ky = a / 3;
        int kx = a % 3;
        if (a == 0 && kz == 0 && (p.debug & 1)) kx = 1;  // planted fault
        const int pos = ((kx * F_ZT + z) * ph + ky) * p.W;
        wgmma_k16<1>(acc[a], make_desc(xb + pos * 16, 128, F_NPOS * 16), db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) fence_acc(acc[a].d[k]);
  cp_async_wait<0>();

  // Row m: channel m % 32 of chunk m / 32 of the slice, as in HALO mode.
  const int r0 = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  float* out = split_out(p);
#pragma unroll
  for (int a = 0; a < 9; ++a) {
    long long rr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = r0 + 8 * half, ci = 2 * slice + (m >> 5);
      const bool seg_b = ci >= p.nch_a;
      const int cl = (seg_b ? ci - p.nch_a : ci) * CK + (m & 31);
      rr[half] = ci < p.nchunks && cl < (seg_b ? p.cb : p.ca)
                     ? (long long)(kz * 9 + a) * p.cin + (seg_b ? p.ca : 0) +
                           cl
                     : -1;
    }
    store_rows(p, acc[a], out, rr, n0 + wg * BN);
  }
}

// PANEL mode (Cin = 1): blockIdx.x = Cout tile, blockIdx.y = split; M = the
// 27 taps (rows 27..63 dropped). The next tile's one-channel halo is read
// while the tensor cores run this one.
__global__ void __launch_bounds__(128) dw_panel_kernel(const Params p) {
  constexpr int NT = 128, NH = (P_HV + NT - 1) / NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const uint32_t panel = sbase + 2 * P_H1;
  const uint32_t gbase = panel + P_PANEL;  // the panel's rows 32..63 read here
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const long long f0 = (long long)blockIdx.y * p.per;
  const long long f1 = min(f0 + p.per, p.total);
  const int ntile = f1 > f0 ? (int)(f1 - f0) : 0;

  auto load_h1 = [&](int i) {
    const Tile t = tile_at<PZ>(p, f0 + i);
    uint16_t* h1 = reinterpret_cast<uint16_t*>(smem + (i & 1) * P_H1);
    uint16_t v[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      const int hv = tid + k * NT;
      const int z = t.z0 - 1 + hv / (HXY * HXY);
      const int y = t.y0 - 1 + (hv / HXY) % HXY;
      const int x = t.x0 - 1 + hv % HXY;
      v[k] = 0;
      if (hv < P_HV && z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 &&
          x < p.W)
        v[k] = p.xa[t.bvox + ((long long)z * p.H + y) * p.W + x];
    }
#pragma unroll
    for (int k = 0; k < NH; ++k)
      if (tid + k * NT < P_HV) h1[tid + k * NT] = v[k];
  };
  auto issue_g = [&](int i) {
    load_g<PZ>(p, gbase + (i & 1) * P_G,
               reinterpret_cast<uint16_t*>(smem + 2 * P_H1 + P_PANEL +
                                           (i & 1) * P_G),
               tile_at<PZ>(p, f0 + i), n0);
  };

  Acc<BN> acc;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc.d[i] = 0.f;
  if (ntile > 0) {
    load_h1(0);
    issue_g(0);
  }
  cp_async_commit();
#pragma unroll 1
  for (int i = 0; i < ntile; ++i) {
    const Tile t = tile_at<PZ>(p, f0 + i);
    const uint16_t* h1 =
        reinterpret_cast<const uint16_t*>(smem + (i & 1) * P_H1);
    __syncthreads();  // halo i written; tile i - 1's wgmma done everywhere
    // Panel row (tap k, voxel v) = the halo at v shifted by tap k: per
    // voxel 27 loads at constant offsets, four 16-byte stores.
    for (int v = tid; v < P_TV; v += NT) {
      const uint16_t* hv = h1 + ((v >> 6) * HXY + ((v >> 3) & 7)) * HXY +
                           (v & 7);
#pragma unroll
      for (int t8 = 0; t8 < 4; ++t8) {
        uint32_t w[4];
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          uint32_t pair = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = t8 * 8 + j2 * 2 + h;
            if (k < 27) {
              const int off = (k / 9) * HXY * HXY + ((k / 3) % 3) * HXY + k % 3;
              // Planted fault: tap 0 reads tap 1's view.
              const uint32_t val = (k == 0 && (p.debug & 1)) ? hv[1] : hv[off];
              pair |= val << (16 * h);
            }
          }
          w[j2] = pair;
        }
        *reinterpret_cast<uint4*>(smem + 2 * P_H1 + (t8 * P_TV + v) * 16) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // panel and g tile i visible to wgmma
    if (i + 1 < ntile) issue_g(i + 1);
    cp_async_commit();

    const uint32_t gb = gbase + (i & 1) * P_G;
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) fence_acc(acc.d[k]);
    wgmma_fence();
#pragma unroll 1
    for (int z = 0; z < t.nz; ++z) {
#pragma unroll 1
      for (int r = 0; r < t.nr; ++r) {
        const int off = (z * 64 + r * 16) * 16;
        wgmma_k16<1>(acc, make_desc(panel + off, 128, P_TV * 16),
                     make_desc(gb + off, 128, P_TV * 16));
      }
    }
    wgmma_commit();
    if (i + 1 < ntile) load_h1(i + 1);
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) fence_acc(acc.d[k]);
  }
  cp_async_wait<0>();

  const int r0 = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  long long row[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    row[half] = r0 + 8 * half < 27 ? r0 + 8 * half : -1;
  store_rows(p, acc, split_out(p), row, n0);
}

// out[i] += ws[0][i], ws[1][i], ... (splits 1, 2, ...), in that order.
__global__ void dw_reduce_kernel(const float* ws, float* out, long long mn,
                                 int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = out[i];
    for (int k = 0; k < splits - 1; ++k) s += ws[(long long)k * mn + i];
    out[i] = s;
  }
}

}  // namespace

// C entry point, bound with ctypes. The plan (mode 0 halo / 1 panel /
// 2 zstack / 3 flat, splits, tiles per split) comes from
// exaspim_tpu_torch/ops/nb_conv.py:_dw_plan, which also checks shapes and
// layouts (contiguous, 16-byte aligned tensors). Any Cin and Cout; PANEL
// needs ca == 1 and no second segment, ZSTACK segments that are multiples
// of 8, FLAT that and Cout a multiple of 8, planes of 16 voxels and
// (H + 2) * W <= 24. out is (27, ca + cb, cout) f32; ws is (splits - 1,
// 27, ca + cb, cout) f32 scratch (unused when splits == 1). With more than
// one split dw_reduce_kernel runs after the conv on the same stream, a
// second launch. debug bit 0 plants a fault (tap 0 reads tap 1's view) for the
// checks in chip_smoke.py; the wrappers pass 0. Returns the cudaError_t of
// the launches (0 on success); launches on `stream`, does not synchronise.
extern "C" int nb_conv3d_dw_bf16(const void* xa, const void* xb, int ca,
                                 int cb, const void* g, void* ws, void* out,
                                 int B, int D, int H, int W, int cout,
                                 int mode, int splits, long long per,
                                 int debug, void* stream) {
  if (ca <= 0 || cb < 0 || cout <= 0 || B <= 0 || D <= 0 || H <= 0 ||
      W <= 0 || splits <= 0 || splits > 65535 || per <= 0)
    return (int)cudaErrorInvalidValue;
  if (mode == MODE_PANEL && (ca != 1 || cb != 0))
    return (int)cudaErrorInvalidValue;
  if (mode != MODE_PANEL && mode != MODE_HALO && mode != MODE_ZSTACK &&
      mode != MODE_FLAT)
    return (int)cudaErrorInvalidValue;
  if ((mode == MODE_ZSTACK || mode == MODE_FLAT) && (ca % 8 || cb % 8))
    return (int)cudaErrorInvalidValue;
  if (mode == MODE_FLAT && (cout % 8 || H * W != F_HW ||
                           (H + 2) * W > F_PW || (long long)B * D >= (1 << 30)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xa = static_cast<const uint16_t*>(xa);
  p.xb = static_cast<const uint16_t*>(cb ? xb : xa);
  p.g = static_cast<const uint16_t*>(g);
  p.out = static_cast<float*>(out);
  p.ws = static_cast<float*>(ws);
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  p.ca = ca;
  p.cb = cb;
  p.cin = ca + cb;
  p.cout = cout;
  p.D = D;
  p.H = H;
  p.W = W;
  p.dhw = D * H * W;
  p.tiles_x = (W + 7) / 8;
  p.tiles_y = (H + 7) / 8;
  const int zt = mode == MODE_PANEL ? PZ : HZ;
  p.tiles = ((D + zt - 1) / zt) * p.tiles_y * p.tiles_x;
  p.total = (long long)B * p.tiles;
  p.total_planes = (long long)B * D;
  if (mode == MODE_FLAT) p.total = (p.total_planes + F_ZT - 1) / F_ZT;
  p.per = per;
  if ((long long)(splits - 1) * per >= p.total ||
      (long long)splits * per < p.total)
    return (int)cudaErrorInvalidValue;  // every split holds a tile, all held
  p.nch_a = (ca + CK - 1) / CK;
  p.nchunks = p.nch_a + (cb + CK - 1) / CK;
  p.ctiles = (cout + BN - 1) / BN;
  if (mode == MODE_FLAT) p.ctiles = (p.ctiles + 1) / 2;  // pairs
  p.vec_x = ca % 8 == 0 && cb % 8 == 0;
  p.vec_g = cout % 8 == 0;
  p.debug = debug;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == MODE_ZSTACK) {
    const long long bx = (long long)p.nchunks * p.ctiles;
    if (bx > 2147483647LL) return (int)cudaErrorInvalidValue;
    static unsigned long long done = 0;
    e = allow_smem(dw_zstack_kernel, ZSTACK_SMEM, done);
    if (e != cudaSuccess) return (int)e;
    dw_zstack_kernel<<<dim3((unsigned)bx, splits), 256, ZSTACK_SMEM, s>>>(p);
  } else if (mode == MODE_FLAT) {
    const long long bx = 3LL * ((p.nchunks + 1) / 2) * p.ctiles;
    if (bx > 2147483647LL) return (int)cudaErrorInvalidValue;
    static unsigned long long done = 0;
    e = allow_smem(dw_flat_kernel, FLAT_SMEM, done);
    if (e != cudaSuccess) return (int)e;
    dw_flat_kernel<<<dim3((unsigned)bx, splits), 256, FLAT_SMEM, s>>>(p);
  } else if (mode == MODE_HALO) {
    const long long bx = 3LL * ((p.nchunks + 1) / 2) * p.ctiles;
    if (bx > 2147483647LL) return (int)cudaErrorInvalidValue;
    static unsigned long long done = 0;
    e = allow_smem(dw_halo_kernel, HALO_SMEM, done);
    if (e != cudaSuccess) return (int)e;
    dw_halo_kernel<<<dim3((unsigned)bx, splits), 128, HALO_SMEM, s>>>(p);
  } else {
    static unsigned long long done = 0;
    e = allow_smem(dw_panel_kernel, PANEL_SMEM, done);
    if (e != cudaSuccess) return (int)e;
    dw_panel_kernel<<<dim3(p.ctiles, splits), 128, PANEL_SMEM, s>>>(p);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = 27LL * p.cin * cout;
  long long rblocks = (mn + 255) / 256;
  if (rblocks > 4096) rblocks = 4096;
  dw_reduce_kernel<<<(unsigned)rblocks, 256, 0, s>>>(p.ws, p.out, mn,
                                                      splits);
  return (int)cudaGetLastError();
}
