// The dynamic shared-memory limit of a kernel, raised once per device.
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) acts on the current
// device, so a process that launches one kernel on several cards has to
// set it on each. Included by hopper_conv.cuh (the conv kernels) and
// byte_histogram.cu; bm4d_match.cu keeps a size per device instead, since
// one of its instances asks for different amounts.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Allow kernel `k` `bytes` of dynamic shared memory on the current device,
// once per device (bit `dev` of `done`, one mask per kernel instance);
// later launches skip cudaFuncSetAttribute. At or under the default 48 KB
// there is nothing to allow.
template <typename K>
cudaError_t allow_smem(K k, size_t bytes, unsigned long long& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) done |= bit;
  return e;
}

}  // namespace
