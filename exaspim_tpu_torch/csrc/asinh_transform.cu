// Elementwise asinh intensity transform and its quantising inverse.
//
//   forward:  y = log(v + sqrt(v * v + 1)) / norm,  v = (x - offset) / scale
//             x uint16 or f32 -> y f32 (asinh in its log form)
//   inverse:  c = clip(sinh(y * norm) * scale + offset, 0, max_count),
//             sinh(v) = (exp(v) - exp(-v)) / 2; rint(c) -> uint16
//
// The divisions are multiplications by the f32 reciprocals the wrapper
// passes. Every add and multiply is an _rn intrinsic, which the compiler
// never contracts into an FMA, and the file is built without
// --use_fast_math, so the kernels follow the plain PyTorch versions
// (exaspim_tpu_torch/ops/elementwise.py) operation by operation; rintf
// rounds half to even, as torch.round does.
//
// Replaces exaspim_tpu/ops/pallas_ops.py:_elementwise_call (asinh_forward,
// asinh_inverse). The TPU kernels flatten to (rows, 128) lanes, pad the
// rows to a tile multiple and hop uint16 through int32 because Mosaic has
// no direct cast; here a grid-stride loop reads the uint16 directly and
// needs no padding.
//
// What bounds them on an H100: bytes, each element read once and written
// once (6 bytes per element either way; 0.03 ms for a 256^3 block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    asinh_forward_kernel(const T* __restrict__ x, float* __restrict__ y,
                         long long n, float offset, float inv_scale,
                         float inv_norm) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const float v = __fmul_rn(__fsub_rn((float)x[i], offset), inv_scale);
    const float root = sqrtf(__fadd_rn(__fmul_rn(v, v), 1.0f));
    y[i] = __fmul_rn(logf(__fadd_rn(v, root)), inv_norm);
  }
}

__global__ void __launch_bounds__(THREADS)
    asinh_inverse_kernel(const float* __restrict__ y,
                         uint16_t* __restrict__ out, long long n,
                         float offset, float scale, float norm,
                         float max_count) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const float v = __fmul_rn(y[i], norm);
    const float s = __fmul_rn(0.5f, __fsub_rn(expf(v), expf(-v)));
    float c = __fadd_rn(__fmul_rn(s, scale), offset);
    c = fminf(fmaxf(c, 0.0f), max_count);
    out[i] = (uint16_t)(int)rintf(c);
  }
}

unsigned blocks_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  const long long cap = 132LL * 32;  // a few waves of blocks per SM
  if (b > cap) b = cap;
  return (unsigned)(b < 1 ? 1 : b);
}

}  // namespace

// C entry points, bound with ctypes. x, y: n contiguous elements on the
// device. Launch on `stream`, do not synchronise, return the cudaError_t
// of the launch.
extern "C" int asinh_forward_u16(const void* x, void* y, long long n,
                                 float offset, float inv_scale,
                                 float inv_norm, void* stream) {
  asinh_forward_kernel<uint16_t>
      <<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint16_t*>(x), static_cast<float*>(y), n, offset,
          inv_scale, inv_norm);
  return (int)cudaGetLastError();
}

extern "C" int asinh_forward_f32(const void* x, void* y, long long n,
                                 float offset, float inv_scale,
                                 float inv_norm, void* stream) {
  asinh_forward_kernel<float>
      <<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<float*>(y), n, offset,
          inv_scale, inv_norm);
  return (int)cudaGetLastError();
}

extern "C" int asinh_inverse_f32(const void* y, void* out, long long n,
                                 float offset, float scale, float norm,
                                 float max_count, void* stream) {
  asinh_inverse_kernel<<<blocks_for(n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<uint16_t*>(out), n, offset,
      scale, norm, max_count);
  return (int)cudaGetLastError();
}
