// What the conv bodies of the stride-1 SAME 3x3x3 convolution kernels share
// (fused_conv.cu, fused_conv_dw.cu: dense NDHWC tensors; phase_conv.cu,
// phase_conv_dw.cu: phase-major tensors that stand for a 2x-upsampled
// volume): the conversions between the input / output types and f32, and
// the two Layout policies that say where a voxel's channel vector lives. A
// body written against a Layout is the same arithmetic over the
// full-resolution grid in either: the phase kernels read and write through
// the depth-to-space index map and touch exactly the 27 true taps per output
// phase.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace segk {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// (B, D, H, W, C) channel-last.
struct DenseLayout {
  __device__ static __forceinline__ int64_t offset(int b, int z, int y, int x, int c,
                                                   int D, int H, int W, int C) {
    return ((((int64_t)b * D + z) * H + y) * W + x) * C + c;
  }
  // The same within one sample, in 32 bits (the caller checks D*H*W*C < 2^31).
  __device__ static __forceinline__ int inner(int z, int y, int x, int c, int H, int W, int C) {
    return ((z * H + y) * W + x) * C + c;
  }
};

// Phase-major (B, D/2, H/2, W/2, 8*C): full-resolution voxel (z, y, x) sits in
// block (z/2, y/2, x/2) at channel ((z&1)*4 + (y&1)*2 + (x&1)) * C + c.
// D, H, W are the full-resolution (even) sizes.
struct PhaseLayout {
  __device__ static __forceinline__ int64_t offset(int b, int z, int y, int x, int c,
                                                   int D, int H, int W, int C) {
    const int ph = ((z & 1) << 2) | ((y & 1) << 1) | (x & 1);
    return ((((int64_t)b * (D >> 1) + (z >> 1)) * (H >> 1) + (y >> 1)) * (W >> 1) +
            (x >> 1)) * (8 * C) + ph * C + c;
  }
  __device__ static __forceinline__ int inner(int z, int y, int x, int c, int H, int W, int C) {
    const int ph = ((z & 1) << 2) | ((y & 1) << 1) | (x & 1);
    return ((((z >> 1) * (H >> 1) + (y >> 1)) * (W >> 1) + (x >> 1)) * 8 + ph) * C + c;
  }
};

}  // namespace segk
