// Shared body of the two weight-gradient kernels of the stride-1 SAME
// 3x3x3 convolution (fused_conv_dw.cu: dense NDHWC tensors; phase_conv_dw.cu:
// phase-major tensors that stand for a 2x-upsampled volume).
//
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]
//
// over the 27 taps t, with zero padding at the (full-resolution) border:
// a GEMM of 27*C rows by CO columns whose contraction runs over every
// output position. CUDA blocks run in no order, so the positions are split
// over blocks: a block owns one input-plane offset dz, a chunk of CC input
// channels and a tile of COT output channels, and walks a fixed, strided
// subset ("split") of the (TH x TW) position tiles. Its threads are NPG
// position groups x CC input channels x COT/4 output-channel groups; each
// thread keeps the 9 (dy, dx) taps x 4 output channels of its (ci, co) group
// in f32 registers, and each position group writes its own partial to a
// workspace. A second kernel sums the partials in a fixed order, so the
// result repeats bit for bit from run to run.
//
// Per tile the block stages the (TH+2) x (TW+2) halo of CC input channels
// (plane d + dz - 1) and the TH x TW x COT cotangent tile in shared memory
// as f32; a thread holds one cotangent row (TW x 4 values) in registers and
// streams the three input rows past it, so each shared-memory read of x
// feeds up to 12 FMAs.
#pragma once

#include "conv3.cuh"

namespace segk {

constexpr int DW_TH = 16;       // position-tile rows
constexpr int DW_TW = 8;        // position-tile columns
constexpr int DW_THREADS = 256;
constexpr int DW_TARGET_BLOCKS = 528;  // ~4 blocks per SM of an H100

struct DwPlan {
  int cc, cot, npg;  // channel chunk, output tile, position groups
  int n_ci, n_co;    // chunks along C and CO
  int splits;        // position splits (grid.x)
  long long n_tiles;
};

inline DwPlan dw_plan(int B, int D, int H, int W, int C, int CO) {
  DwPlan p;
  p.cc = C <= 8 ? 8 : 16;
  p.cot = CO <= 8 ? 8 : (CO <= 16 ? 16 : 32);
  p.npg = DW_THREADS / (p.cc * (p.cot / 4));
  p.n_ci = (C + p.cc - 1) / p.cc;
  p.n_co = (CO + p.cot - 1) / p.cot;
  const long long tiles_h = (H + DW_TH - 1) / DW_TH;
  const long long tiles_w = (W + DW_TW - 1) / DW_TW;
  p.n_tiles = (long long)B * D * tiles_h * tiles_w;
  const long long per_split = 3LL * p.n_ci * p.n_co;
  long long s = (DW_TARGET_BLOCKS + per_split - 1) / per_split;
  if (s > p.n_tiles) s = p.n_tiles;
  p.splits = (int)(s < 1 ? 1 : s);
  return p;
}

// f32 workspace floats: one 27*C*CO partial per (split, position group).
inline long long dw_workspace(const DwPlan& p, int C, int CO) {
  return (long long)p.splits * p.npg * 27 * C * CO;
}

template <typename Tin, typename Layout, int CCK, int COTK>
__global__ void __launch_bounds__(DW_THREADS)
conv3_dw_kernel(const Tin* __restrict__ x, const Tin* __restrict__ dy,
                float* __restrict__ ws, int B, int D, int H, int W, int C, int CO,
                int splits) {
  constexpr int OT = CCK * (COTK / 4);
  constexpr int NPG = DW_THREADS / OT;
  __shared__ float xs[CCK][DW_TH + 2][DW_TW + 2];
  __shared__ __align__(16) float gs[DW_TH][DW_TW][COTK];

  const int split = blockIdx.x;
  const int n_ci = (C + CCK - 1) / CCK;
  const int c0 = (blockIdx.y % n_ci) * CCK;
  const int co0 = (blockIdx.y / n_ci) * COTK;
  const int dz = blockIdx.z;  // input plane z = d + dz - 1
  const int tid = threadIdx.x;
  const int ot = tid % OT;
  const int pg = tid / OT;
  const int ci = ot / (COTK / 4);
  const int cg = ot % (COTK / 4);

  float acc[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;

  const int tiles_h = (H + DW_TH - 1) / DW_TH;
  const int tiles_w = (W + DW_TW - 1) / DW_TW;
  const long long n_tiles = (long long)B * D * tiles_h * tiles_w;

  for (long long t = split; t < n_tiles; t += splits) {
    const int tw = (int)(t % tiles_w);
    long long r = t / tiles_w;
    const int th = (int)(r % tiles_h);
    r /= tiles_h;
    const int d = (int)(r % D);
    const int b = (int)(r / D);
    const int z = d + dz - 1;
    if (z < 0 || z >= D) continue;  // uniform over the block: zero padding
    const int h0 = th * DW_TH;
    const int w0 = tw * DW_TW;
    for (int i = tid; i < CCK * (DW_TH + 2) * (DW_TW + 2); i += DW_THREADS) {
      const int c = i % CCK;
      const int rr = i / CCK;
      const int xx = rr % (DW_TW + 2);
      const int yy = rr / (DW_TW + 2);
      const int gy = h0 + yy - 1;
      const int gx = w0 + xx - 1;
      float v = 0.f;
      if (c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(x[Layout::offset(b, z, gy, gx, c0 + c, D, H, W, C)]);
      xs[c][yy][xx] = v;
    }
    for (int i = tid; i < DW_TH * DW_TW * COTK; i += DW_THREADS) {
      const int co = i % COTK;
      const int rr = i / COTK;
      const int xx = rr % DW_TW;
      const int yy = rr / DW_TW;
      const int gy = h0 + yy;
      const int gx = w0 + xx;
      float v = 0.f;
      if (co0 + co < CO && gy < H && gx < W)
        v = to_f32(dy[Layout::offset(b, d, gy, gx, co0 + co, D, H, W, CO)]);
      gs[yy][xx][co] = v;
    }
    __syncthreads();
    const int rows = min(DW_TH, H - h0);
    for (int y = pg; y < rows; y += NPG) {
      float4 g[DW_TW];
#pragma unroll
      for (int j = 0; j < DW_TW; ++j)
        g[j] = *reinterpret_cast<const float4*>(&gs[y][j][cg * 4]);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float row[DW_TW + 2];
#pragma unroll
        for (int j = 0; j < DW_TW + 2; ++j) row[j] = xs[ci][y + ky][j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int j = 0; j < DW_TW; ++j) {
            const float v = row[j + kx];
            acc[ky * 3 + kx][0] = fmaf(v, g[j].x, acc[ky * 3 + kx][0]);
            acc[ky * 3 + kx][1] = fmaf(v, g[j].y, acc[ky * 3 + kx][1]);
            acc[ky * 3 + kx][2] = fmaf(v, g[j].z, acc[ky * 3 + kx][2]);
            acc[ky * 3 + kx][3] = fmaf(v, g[j].w, acc[ky * 3 + kx][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // every (split, pg, tap, ci, co) entry of the workspace is written, zero
  // where the block saw no position
  if (c0 + ci >= C) return;
  float* part = ws + ((long long)split * NPG + pg) * 27LL * C * CO;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int tap = dz * 9 + k;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = co0 + cg * 4 + q;
      if (co < CO) part[((long long)tap * C + c0 + ci) * CO + co] = acc[k][q];
    }
  }
}

namespace {
// out[i] = sum over the partials k = 0 .. parts-1, in that order.
__global__ void dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                 long long n, int parts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < parts; ++k) s += ws[(long long)k * n + i];
  out[i] = s;
}
}  // namespace

template <typename Tin, typename Layout, int CCK, int COTK>
cudaError_t launch_conv3_dw_cfg(const void* x, const void* dy, float* ws, const DwPlan& p,
                                int B, int D, int H, int W, int C, int CO,
                                cudaStream_t stream) {
  const dim3 grid(p.splits, p.n_ci * p.n_co, 3);
  conv3_dw_kernel<Tin, Layout, CCK, COTK><<<grid, DW_THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(dy), ws, B, D, H, W, C, CO,
      p.splits);
  return cudaGetLastError();
}

template <typename Tin, typename Layout>
cudaError_t launch_conv3_dw_typed(const void* x, const void* dy, float* ws, const DwPlan& p,
                                  int B, int D, int H, int W, int C, int CO,
                                  cudaStream_t s) {
#define SEGK_DW_CASE(CCV, COTV)                                                         \
  if (p.cc == CCV && p.cot == COTV)                                                     \
    return launch_conv3_dw_cfg<Tin, Layout, CCV, COTV>(x, dy, ws, p, B, D, H, W, C, CO, s);
  SEGK_DW_CASE(8, 8)
  SEGK_DW_CASE(8, 16)
  SEGK_DW_CASE(8, 32)
  SEGK_DW_CASE(16, 8)
  SEGK_DW_CASE(16, 16)
  SEGK_DW_CASE(16, 32)
#undef SEGK_DW_CASE
  return cudaErrorInvalidValue;
}

// x (B, D, H, W, C) and dy (B, D, H, W, CO) in the Layout, D/H/W full
// resolution; ws holds dw_workspace() floats; out (3, 3, 3, C, CO) f32.
template <typename Layout>
int launch_conv3_dw(const void* x, const void* dy, float* ws, float* out, int B, int D,
                    int H, int W, int C, int CO, int in_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DwPlan p = dw_plan(B, D, H, W, C, CO);
  if (p.n_ci * p.n_co > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = in_bf16
      ? launch_conv3_dw_typed<__nv_bfloat16, Layout>(x, dy, ws, p, B, D, H, W, C, CO, s)
      : launch_conv3_dw_typed<float, Layout>(x, dy, ws, p, B, D, H, W, C, CO, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 27LL * C * CO;
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      ws, out, n, p.splits * p.npg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk
