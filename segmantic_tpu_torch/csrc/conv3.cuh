// Shared body of the two stride-1 SAME 3x3x3 convolution kernels
// (fused_conv.cu: dense NDHWC tensors; phase_conv.cu: phase-major tensors
// that stand for a 2x-upsampled volume).
//
// One block computes a (TH x TW) tile of output positions of one (b, d)
// plane for COT output channels. The three input planes d-1, d, d+1 are
// walked one after another; for each plane the (TH+2) x (TW+2) halo tile of
// CC input channels and the 3x3 x CC x COT weight slice are staged in shared
// memory as f32, and every thread accumulates PW consecutive W positions x 4
// output channels in f32 registers (each input row of PW+2 values serves all
// three dx taps). Each (plane, channel chunk) step sums its 9 * CC products
// into a fresh partial that is then added to the total, so no f32 chain is
// longer than 9 * CC terms plus one add per step (a single chain of 27 * C
// terms, 6,912 at C = 256, lost accuracy visibly in the train step's
// gradients). The epilogue applies y = acc * scale + shift, then
// none / relu / prelu, and stores in the output type.
//
// Where each voxel lives is the Layout policy's business, so the phase
// kernel is the same arithmetic over the full-resolution grid: it reads and
// writes through the depth-to-space index map and touches exactly the 27 true
// taps per output phase.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace segk {

constexpr int TH = 8;   // output rows per block
constexpr int TW = 16;  // output columns per block
constexpr int PW = 4;   // consecutive columns per thread
constexpr int CC = 16;  // input channels staged per step

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
};

// Threads: 32 position groups (TH rows x TW/PW column groups) x COT/4 channel
// groups; a warp is one channel group, so its weight reads are broadcasts.
template <typename Tin, typename Tout, typename Layout, int COT>
__global__ void __launch_bounds__(8 * COT)
conv3_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ shift,
             const float* __restrict__ alpha, int relu_mode, Tout* __restrict__ out,
             int D, int H, int W, int C, int CO) {
  __shared__ float xs[CC][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9][CC][COT];

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * COT;
  const int b = blockIdx.z / D;
  const int d = blockIdx.z % D;
  const int tid = threadIdx.x;
  const int pg = tid & 31;
  const int cg = tid >> 5;
  const int ty = pg / (TW / PW);
  const int tx = (pg % (TW / PW)) * PW;

  float acc[PW][4];
#pragma unroll
  for (int j = 0; j < PW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int dz = 0; dz < 3; ++dz) {
    const int z = d + dz - 1;
    if (z < 0 || z >= D) continue;  // uniform over the block: zero padding
    for (int c0 = 0; c0 < C; c0 += CC) {
      const int cn = min(CC, C - c0);
      for (int i = tid; i < CC * (TH + 2) * (TW + 2); i += blockDim.x) {
        const int c = i % CC;
        const int r = i / CC;
        const int xx = r % (TW + 2);
        const int yy = r / (TW + 2);
        const int gy = h0 + yy - 1;
        const int gx = w0 + xx - 1;
        float v = 0.f;
        if (c < cn && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = to_f32(x[Layout::offset(b, z, gy, gx, c0 + c, D, H, W, C)]);
        xs[c][yy][xx] = v;
      }
      for (int i = tid; i < 9 * CC * COT; i += blockDim.x) {
        const int co = i % COT;
        const int r = i / COT;
        const int c = r % CC;
        const int tap = r / CC;
        float v = 0.f;
        if (c < cn && co0 + co < CO)
          v = to_f32(w[((int64_t)(dz * 9 + tap) * C + c0 + c) * CO + co0 + co]);
        ws[tap][c][co] = v;
      }
      __syncthreads();
      float part[PW][4];
#pragma unroll
      for (int j = 0; j < PW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll 2
      for (int c = 0; c < cn; ++c) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float row[PW + 2];
#pragma unroll
          for (int j = 0; j < PW + 2; ++j) row[j] = xs[c][ty + dy][tx + j];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 wv = *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][c][cg * 4]);
#pragma unroll
            for (int j = 0; j < PW; ++j) {
              part[j][0] = fmaf(row[j + dx], wv.x, part[j][0]);
              part[j][1] = fmaf(row[j + dx], wv.y, part[j][1]);
              part[j][2] = fmaf(row[j + dx], wv.z, part[j][2]);
              part[j][3] = fmaf(row[j + dx], wv.w, part[j][3]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
      __syncthreads();
    }
  }

  const float a = relu_mode == 2 ? alpha[0] : 0.f;
  const int gy = h0 + ty;
  if (gy >= H) return;
#pragma unroll
  for (int j = 0; j < PW; ++j) {
    const int gx = w0 + tx + j;
    if (gx >= W) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = co0 + cg * 4 + q;
      if (co >= CO) continue;
      float y = acc[j][q] * scale[co] + shift[co];
      if (relu_mode == 1) {
        y = fmaxf(y, 0.f);
      } else if (relu_mode == 2) {
        y = y >= 0.f ? y : a * y;
      }
      out[Layout::offset(b, d, gy, gx, co, D, H, W, CO)] = from_f32<Tout>(y);
    }
  }
}

template <typename Tin, typename Tout, typename Layout, int COT>
cudaError_t launch_conv3_cot(const void* x, const void* w, const float* scale,
                             const float* shift, const float* alpha, int relu_mode,
                             void* out, int B, int D, int H, int W, int C, int CO,
                             cudaStream_t stream) {
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (CO + COT - 1) / COT, B * D);
  conv3_kernel<Tin, Tout, Layout, COT><<<grid, 8 * COT, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w), scale, shift, alpha,
      relu_mode, static_cast<Tout*>(out), D, H, W, C, CO);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, typename Layout>
cudaError_t launch_conv3_typed(const void* x, const void* w, const float* scale,
                               const float* shift, const float* alpha, int relu_mode,
                               void* out, int B, int D, int H, int W, int C, int CO,
                               cudaStream_t stream) {
  if (CO <= 8)
    return launch_conv3_cot<Tin, Tout, Layout, 8>(x, w, scale, shift, alpha, relu_mode, out,
                                                  B, D, H, W, C, CO, stream);
  if (CO <= 16)
    return launch_conv3_cot<Tin, Tout, Layout, 16>(x, w, scale, shift, alpha, relu_mode, out,
                                                   B, D, H, W, C, CO, stream);
  return launch_conv3_cot<Tin, Tout, Layout, 32>(x, w, scale, shift, alpha, relu_mode, out,
                                                 B, D, H, W, C, CO, stream);
}

// in_bf16: x and w are bf16 (else f32); out_bf16: out is bf16 (else f32).
template <typename Layout>
int launch_conv3(const void* x, const void* w, const float* scale, const float* shift,
                 const float* alpha, int relu_mode, void* out, int B, int D, int H, int W,
                 int C, int CO, int in_bf16, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!in_bf16 && !out_bf16) {
    err = launch_conv3_typed<float, float, Layout>(x, w, scale, shift, alpha, relu_mode, out,
                                                   B, D, H, W, C, CO, s);
  } else if (in_bf16 && out_bf16) {
    err = launch_conv3_typed<__nv_bfloat16, __nv_bfloat16, Layout>(
        x, w, scale, shift, alpha, relu_mode, out, B, D, H, W, C, CO, s);
  } else if (in_bf16 && !out_bf16) {
    err = launch_conv3_typed<__nv_bfloat16, float, Layout>(x, w, scale, shift, alpha,
                                                           relu_mode, out, B, D, H, W, C, CO, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // f32 in, bf16 out: not offered
  }
  return static_cast<int>(err);
}

}  // namespace segk
