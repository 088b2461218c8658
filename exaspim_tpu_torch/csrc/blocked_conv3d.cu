// 3x3x3 SAME convolution (no bias, one input, no statistics) over
// channels-last bf16 volumes, for Hopper (sm_90a).
//
// Replaces exaspim_tpu/ops/pallas_conv.py:117 _kernel (the Pallas TPU kernel
// behind blocked_conv3d:174). The function is the one-segment,
// statistics-free case of the forward conv of csrc/nb_conv3d.cu, so this
// translation unit instantiates that design (nb_conv3d_fwd.cuh) for its own
// entry point rather than keeping a second kernel for the same function:
// wgmma m64nNk16 with A read from a zero-padded [c8][voxel][8] halo tile in
// shared memory (each tap a shifted view), the taps read MN-major as they lie
// in memory, a cp.async ring, and the persistent resident-weight mode for
// 32 and 64 output channels. Nothing of the TPU's layout comes along: no
// 2 x 2 (y, x) space-to-depth fold into lanes, no 12 tap groups, no packed
// weight matrix. The tile plan is ops/nb_conv.py:_plan's for one segment.
//
// Numerics: bf16 inputs, f32 accumulation over all 27 * Cin products in one
// fixed order, one rounding to bf16; the same bits as nb_conv3d on the same
// inputs and plan.
//
// What bounds it on an H100, and the design's limits: see nb_conv3d.cu.

#include "nb_conv3d_fwd.cuh"

// C entry point, bound with ctypes. Shapes and layouts are validated by the
// Python wrapper (exaspim_tpu_torch/ops/blocked_conv.py): cin and cout
// multiples of 32, 16-byte aligned contiguous tensors. The plan (mode, bn,
// wg, tiles, pblocks) is ops/nb_conv.py:_plan(B, D, H, W, (cin,), cout).
// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int blocked_conv3d_bf16(const void* x, const void* w, void* out,
                                   int B, int D, int H, int W, int cin,
                                   int cout, int mode, int bn, int wg,
                                   int tiles, int pblocks, void* stream) {
  if (cin <= 0 || cout <= 0 || cin % CK || cout % 32 || mode == MODE_PANEL)
    return (int)cudaErrorInvalidValue;
  return conv_entry(x, nullptr, cin, 0, w, out, nullptr, nullptr, nullptr,
                    nullptr, B, D, H, W, cout, mode, bn, wg, tiles, pblocks,
                    0, stream);
}
