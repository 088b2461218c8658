// 3x3x3 SAME convolution (no bias) over channels-last bf16 volumes, with an
// optional fused GroupNorm-statistics epilogue, written for Hopper (sm_90a).
//
// Replaces exaspim_tpu/ops/nb_conv.py:358 _fwd_kernel (the Pallas TPU kernel
// behind nb_conv3d / nb_conv3d_stats:896). It computes the same function, not
// the TPU's layout: an implicit GEMM over plain NDHWC tensors,
//
//   M = output voxels, N = Cout, K = 27 * (Ca + Cb),
//
// with the taps (27, Cin, Cout) in DHWIO order and the input given as one or
// two channel segments (the decoder's [skip, up] concat is consumed as two
// K segments and never built). bf16 in, f32 accumulation, one rounding to
// bf16; with stats also Σy and Σy² per (batch, channel) of the ROUNDED y.
//
// What bounds it on an H100: at 32 -> 32 a voxel costs 2*27*32*32 = 55 kFLOP
// against 128 compulsory bytes, ~430 FLOP/B, above the ~295 FLOP/B ridge of
// the bf16 tensor cores; wider stages are more so: operations. The design
// feeds the tensor cores through wgmma and keeps the loads off their path:
//
// * Tiles. A block has WG consumer warpgroups (1 or 2) and owns BN output
//   channels (32, 64 or 128) of M = 64 * WG output voxels, one m64 row block
//   per warpgroup. HALO mode: an 8 (x) x 8 (y) x WG (z) tile. Per 32-channel
//   chunk of a segment the zero-padded (WG+2) x 10 x 10 halo is staged once
//   (25.6 KB at WG = 2); each of the 27 taps is then a shifted view of shared
//   memory: no bounds check and no global read in the inner loop. FLAT mode,
//   for planes too small for an 8 x 8 tile (4^3, the deep levels): 64 * WG
//   consecutive voxels of one batch element, their rows gathered per tap with
//   zero fill. PANEL mode, the Cin = 1 entry conv: the one-channel halo is
//   staged and the 27 -> 32 im2col panel (zeros at k 27..31) is built from it
//   in shared memory, one k32 step of the same wgmma loop.
// * Shared layout and the A operand. The halo is stored as [c8][voxel][8]:
//   16 bytes per voxel and 8-channel group. With TX = 8 the 8 rows of a wgmma
//   core matrix are 8 contiguous halo voxels (128 contiguous bytes) for every
//   tap, so A is read by wgmma straight from shared memory through a
//   descriptor in the no-swizzle (interleave) layout: a tap moves the start
//   address by (kz*10 + ky)*10 + kx voxels, the 8-row groups (y) sit 160 B
//   apart, the channel groups one c8 plane apart. A swizzled layout is keyed
//   on address bits and would not survive a one-voxel (16 B) shift; the
//   register (RS) form would cost the same shared reads plus ldmatrix work.
// * B. Each step's 32 x BN weight slice is copied as it lies in memory (N
//   contiguous) into [n8][k][8] and read as the MN-major (transposed) B
//   operand, so no thread transposes anything.
// * Pipeline. A step is some taps of one 32-channel chunk. All threads issue
//   16-byte cp.async copies with zero fill (src-size 0 outside the volume or
//   past Cin/Cout) into a ring of 4 or 5 steps of 3 taps, loading 2 or 3
//   steps ahead while the tensor cores run step s. The halo ring has 2
//   chunk buffers, refilled 2 or 3 steps before a chunk starts. One wgmma
//   group stays in flight across the barrier. Convs of 32 or 64 output
//   channels over at most 64 input channels take the RES kernel below
//   (persistent blocks, weights resident). TMA is not used: its box cannot
//   express the per-tap shift into the interleaved [c8][voxel] layout
//   without a transposing copy, and the Cin = 1 and odd-Cin segments need
//   element loads anyway.
// * Other widths. Segments whose channel count is no multiple of 8 stage
//   their halo with element loads (synchronous, same layout). A chunk
//   narrower than 32 channels is zero-filled to 32 in A and B (both k16
//   steps always run, with no branch between the wgmmas); Cout that is no
//   multiple of BN is zero-filled in B and not stored, and Cout that is no
//   multiple of 8 (rows not 16-byte aligned) is loaded and stored element
//   by element, in the same layouts.
// * Epilogue. The accumulators are rounded once to bf16 into a shared tile
//   and stored as 16-byte vectors; voxels of an overhanging tile are skipped.
//   Stats are deterministic and independent of the plan: per channel the
//   rounded values of each unit (one z plane of an 8 x 8 tile, or 64 FLAT
//   voxels) are summed from the accumulators in one fixed tree and written
//   (no atomics) to that unit's row of a (B, units, Cout) workspace; a
//   second small kernel, nb_stats_reduce_kernel, sums the units in a fixed
//   order. Every mode and every (WG, BN) accumulates the K steps in the same
//   order too, so a batch element gets bit-equal y, s1, s2 in any batch and
//   slot, and two launches on the same inputs agree bit for bit.
//
// The plan (mode, WG, BN, tile count) is chosen in Python
// (exaspim_tpu_torch/ops/nb_conv.py:_plan). The kernels live in
// nb_conv3d_fwd.cuh (blocked_conv3d.cu instantiates them too), the PTX
// helpers and the halo loader in hopper_conv.cuh (shared with dL/dW).
// Registers: -Xptxas -v reports 44-168 per thread over the instances and no
// spills (NVIDIA H100 build, nvcc for sm_90a); chip_smoke.py phase 2 prints
// the report of the build in hand and fails on a spill. Dynamic shared memory per block (Smem<>::BYTES,
// res_smem_bytes): 41-154 KB, and 166 or 220 KB for the RES kernel (one
// block per SM).

#include "nb_conv3d_fwd.cuh"

// C entry point, bound with ctypes; the arguments and their checks are
// conv_entry's (nb_conv3d_fwd.cuh).
extern "C" int nb_conv3d_bf16(const void* xa, const void* xb, int ca, int cb,
                              const void* w, void* out, void* ws1, void* ws2,
                              void* s1, void* s2, int B, int D, int H, int W,
                              int cout, int mode, int bn, int wg, int tiles,
                              int pblocks, int debug, void* stream) {
  return conv_entry(xa, xb, ca, cb, w, out, ws1, ws2, s1, s2, B, D, H, W,
                    cout, mode, bn, wg, tiles, pblocks, debug, stream);
}
