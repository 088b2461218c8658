// Hopper (sm_90a) building blocks shared by the port's 3x3x3 conv kernels:
// nb_conv3d.cu and blocked_conv3d.cu (through nb_conv3d_fwd.cuh) and
// nb_conv3d_dw.cu. cp.async with zero fill, the wgmma fences, commit and
// wait, no-swizzle shared-memory matrix descriptors, m64nNk16 bf16 wgmma
// with f32 accumulators in registers, and the zero-padded [c8][voxel][8]
// halo loader: a tile of 8 (x) x 8 (y) x Z voxels is staged with one voxel
// of halo on each side, so that every one of the 27 taps reads the tile as
// a view of shared memory shifted by (kz * 10 + ky) * 10 + kx voxels. An
// 8-voxel x run of the halo is 128 contiguous bytes (8 voxels x 8 channels)
// for every tap: one wgmma core matrix, K-major when the voxels are the M
// rows (the forward), MN-major when they are the K rows (dL/dW).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

constexpr int CK = 32;       // channels per chunk (4 groups of 8)
constexpr int HXY = 10;      // halo extent in y and x (8 + 2)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle: start, leading and stride
// byte offsets, all in 16-byte units. K-major: lbo = the next 8 k, sbo =
// the next 8 rows of M (or N). MN-major: lbo = the next 8 k, sbo = the
// next 8 columns of M (or N); a core matrix is 8 k rows of 16 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

template <int N>
struct Acc {
  float d[N / 2];
};

__device__ __forceinline__ void fence_acc(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

#define F4(i) "+f"(c.d[i]), "+f"(c.d[i + 1]), "+f"(c.d[i + 2]), "+f"(c.d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

// D (m64 x N, f32, registers) += A (m64 x k16, shared) * B (k16 x N,
// MN-major, shared). A is K-major (TA = 0) or M-major (TA = 1).
template <int TA = 0>
__device__ __forceinline__ void wgmma_k16(Acc<32>& c, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, 1;\n}\n"
      : F16(0)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}
template <int TA = 0>
__device__ __forceinline__ void wgmma_k16(Acc<64>& c, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : F16(0), F16(16)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}
template <int TA = 0>
__device__ __forceinline__ void wgmma_k16(Acc<128>& c, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, 1;\n}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}
#undef F16
#undef F4

// Zero-padded ZP x 10 x 10 halo of 32 channels c0.. of a segment (cs
// channels, a multiple of 8) around the tile at (x0, y0, z0), as
// [c8][voxel][8] at shared address hb (c8 planes ZP * 100 voxels apart), by
// 16-byte cp.async with zero fill, NT threads.
template <int ZP, int NT>
__device__ __forceinline__ void load_halo(uint32_t hb, const uint16_t* xs,
                                          int cs, int c0, long long bvox,
                                          int x0, int y0, int z0, int D,
                                          int H, int W) {
  constexpr int HV = ZP * HXY * HXY;
  for (int e = threadIdx.x; e < HV * 4; e += NT) {
    const int hv = e >> 2, c8 = e & 3;
    const int z = z0 - 1 + hv / (HXY * HXY);
    const int y = y0 - 1 + (hv / HXY) % HXY;
    const int x = x0 - 1 + hv % HXY;
    const bool ok = c0 + c8 * 8 < cs && z >= 0 && z < D && y >= 0 &&
                    y < H && x >= 0 && x < W;
    const uint16_t* src =
        ok ? xs + (bvox + ((long long)z * H + y) * W + x) * cs + c0 + c8 * 8
           : xs;
    cp_async16(hb + (c8 * HV + hv) * 16, src, ok);
  }
}

}  // namespace
