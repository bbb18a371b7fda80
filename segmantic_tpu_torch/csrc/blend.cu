// Sliding-window Gaussian-blend accumulation, in place:
//   acc[starts[b] + r, c] += logits[b, r, c] * importance[r]   for b = 0 .. B-1
// and, when a weight map is given, wacc[starts[b] + r] += importance[r].
//
// Replaces the Pallas kernel segmantic_tpu/ops/pallas_blend.py::_blend_kernel
// (accumulate_windows_pallas). The TPU runs its grid one step at a time, so
// its read-modify-write per window is race-free even where windows overlap.
// CUDA blocks run in no order, so this kernel is a gather: every element of
// acc that some window covers is read once, takes the windows that cover it
// in the order b = 0 .. B-1, and is written once. Products and sums use
// __fmul_rn / __fadd_rn so nothing contracts to an FMA: the result is
// deterministic and bit-equal to the sequential loop of the plain version.
// There is no alignment contract and no channel padding.
//
// What bounds it on the card: device-memory bytes (acc read and written once
// over the windows' union, each logit and importance value read once; two
// operations per logit). A first version spent its time on instruction count
// instead: a flat 64-bit index taken apart by four divisions per element, the
// starts reloaded from memory for every window, 4-byte accesses, and threads
// over the whole bounding box. What this design does about each:
//  - a block owns a tile of the volume (kRows z planes x blockDim.z rows x
//    blockDim.y voxels) and a thread one channel unit of one voxel in kRows
//    planes; blockIdx and threadIdx give the coordinates, nothing is divided;
//  - with C % 4 == 0 a channel unit is a float4 (16-byte loads and stores of
//    acc and logits; channels and x run fastest, so a warp takes one
//    contiguous run of a row); other channel counts take the scalar route;
//  - the starts come by value in the kernel's arguments (no upload, so the
//    call can be captured in a CUDA graph). One warp tests once which windows
//    touch the block's tile; the block loops over those only, and a block
//    that no window touches returns before it reads acc, so only the union
//    of the windows is visited, not their bounding box;
//  - a thread first settles which of its kRows voxels are covered (integer
//    compares only), then starts their kRows independent loads of acc, and per
//    window kRows loads of logits and of the importance map before the first
//    use. The importance value is read once per voxel and channel unit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWindows = 32;  // windows one launch takes by value
constexpr int kRows = 4;         // z planes a thread owns

struct Windows {
  int n;
  int start[kMaxWindows][3];
};

struct Geometry {
  int R0, R1, R2;  // window extents
  int C, units;    // channels; channel units per voxel (C / V)
  int H, W;        // accumulator extents of axes 1 and 2
  int z0, y0, x0;  // corner of the windows' bounding box
};

template <int V> struct Unit;
template <> struct Unit<4> { using type = float4; };
template <> struct Unit<1> { using type = float; };

__device__ __forceinline__ void add_scaled(float& a, float l, float w) {
  a = __fadd_rn(a, __fmul_rn(l, w));
}
__device__ __forceinline__ void add_scaled(float4& a, const float4& l, float w) {
  add_scaled(a.x, l.x, w);
  add_scaled(a.y, l.y, w);
  add_scaled(a.z, l.z, w);
  add_scaled(a.w, l.w, w);
}

template <int V>
__global__ void __launch_bounds__(256, 3)  // 80 registers: three blocks, 24 warps an SM
blend_kernel(float* __restrict__ acc, const float* __restrict__ logits,
             const float* __restrict__ imp, float* __restrict__ wacc, const Windows win,
             const Geometry g) {
  using unit_t = typename Unit<V>::type;
  __shared__ unsigned s_mask;
  const int tile_x = g.x0 + blockIdx.x * blockDim.y;
  const int tile_y = g.y0 + blockIdx.y * blockDim.z;
  const int z = g.z0 + blockIdx.z * kRows;
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  if (tid < 32) {  // the first warp: one window a lane
    bool hit = false;
    if (tid < win.n) {
      const int sz = win.start[tid][0], sy = win.start[tid][1], sx = win.start[tid][2];
      hit = sz < z + kRows && sz + g.R0 > z && sy < tile_y + (int)blockDim.z &&
            sy + g.R1 > tile_y && sx < tile_x + (int)blockDim.y && sx + g.R2 > tile_x;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (tid == 0) s_mask = m;
  }
  __syncthreads();
  const unsigned mask = s_mask;
  if (mask == 0) return;  // outside the union: acc is not touched

  const int x = tile_x + threadIdx.y, y = tile_y + threadIdx.z;
  bool covered[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) covered[k] = false;
  for (unsigned m = mask; m; m &= m - 1) {
    const int b = __ffs(m) - 1;
    const int rx = x - win.start[b][2], ry = y - win.start[b][1];
    if ((unsigned)rx >= (unsigned)g.R2 || (unsigned)ry >= (unsigned)g.R1) continue;
    const int rz = z - win.start[b][0];
#pragma unroll
    for (int k = 0; k < kRows; ++k) covered[k] |= (unsigned)(rz + k) < (unsigned)g.R0;
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < kRows; ++k) any |= covered[k];
  if (!any) return;

  const int64_t voxel = ((int64_t)z * g.H + y) * g.W + x;  // of the thread's first plane
  const int64_t plane = (int64_t)g.H * g.W;
  const int64_t roi_plane = (int64_t)g.R1 * g.R2;
  const int64_t roi = roi_plane * g.R0;

  for (int u = threadIdx.x; u < g.units; u += blockDim.x) {
    float* a_ptr = acc + voxel * g.C + u * V;
    unit_t a[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (covered[k]) a[k] = *reinterpret_cast<const unit_t*>(a_ptr + k * plane * g.C);
    // the weight map has one value a voxel: the thread of channel unit 0 adds it
    const bool weights = wacc != nullptr && u == 0;
    float wa[kRows];
    if (weights) {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (covered[k]) wa[k] = wacc[voxel + k * plane];
    }
    for (unsigned m = mask; m; m &= m - 1) {
      const int b = __ffs(m) - 1;
      const int rx = x - win.start[b][2], ry = y - win.start[b][1];
      if ((unsigned)rx >= (unsigned)g.R2 || (unsigned)ry >= (unsigned)g.R1) continue;
      const int rz = z - win.start[b][0];
      const int64_t r = ((int64_t)rz * g.R1 + ry) * g.R2 + rx;  // of plane k = 0
      bool in[kRows];
      float w[kRows];
      unit_t l[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        in[k] = (unsigned)(rz + k) < (unsigned)g.R0;
        if (in[k]) {
          const int64_t rk = r + k * roi_plane;
          w[k] = imp[rk];
          l[k] = *reinterpret_cast<const unit_t*>(logits + ((int64_t)b * roi + rk) * g.C + u * V);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!in[k]) continue;
        add_scaled(a[k], l[k], w[k]);
        if (weights) wa[k] = __fadd_rn(wa[k], w[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (!covered[k]) continue;
      *reinterpret_cast<unit_t*>(a_ptr + k * plane * g.C) = a[k];
      if (weights) wacc[voxel + k * plane] = wa[k];
    }
  }
}

}  // namespace

// Resident blocks per SM of the kernel of route `vec` (4 or 1) at `threads`
// threads, as the runtime counts them (registers included); -1 for no route.
extern "C" int segk_blend_blocks_per_sm(int vec, int threads) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (vec == 4)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blend_kernel<4>, threads, 0);
  else if (vec == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blend_kernel<1>, threads, 0);
  return err == cudaSuccess ? blocks : -1;
}

// acc (D, H, W, C) f32; logits (n, R0, R1, R2, C) f32; imp (R0, R1, R2) f32;
// wacc (D, H, W, 1) f32 or null. starts: host array of n x 3 ints, n <= 32.
// vec: floats per access, 4 (C % 4 == 0, acc and logits 16-byte aligned) or 1.
// (bx, tx, ty): the block of threads, channel units x voxels along x x rows
// along y. (z0, y0, x0): the corner of the windows' bounding box; (gz, gy, gx):
// the tiles of (4, ty, tx) voxels that cover it (ops/blend.py::union_tiles).
extern "C" int segk_blend(float* acc, const float* logits, const float* imp, float* wacc,
                          const int* starts, int n, int R0, int R1, int R2, int C, int H, int W,
                          int vec, int bx, int tx, int ty, int z0, int y0, int x0, int gz,
                          int gy, int gx, void* stream) {
  if (n <= 0) return 0;
  const int threads = bx * tx * ty;
  if (n > kMaxWindows || (vec != 4 && vec != 1) || C % vec != 0 || bx < 1 || tx < 1 || ty < 1 ||
      threads < 32 || threads > 256 || gz < 1 || gy < 1 || gx < 1 || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (((uintptr_t)acc | (uintptr_t)logits) & 15)) return (int)cudaErrorInvalidValue;
  Windows win;
  win.n = n;
  for (int b = 0; b < n; ++b)
    for (int a = 0; a < 3; ++a) win.start[b][a] = starts[3 * b + a];
  for (int b = n; b < kMaxWindows; ++b)
    for (int a = 0; a < 3; ++a) win.start[b][a] = 0;
  Geometry g;
  g.R0 = R0;
  g.R1 = R1;
  g.R2 = R2;
  g.C = C;
  g.units = C / vec;
  g.H = H;
  g.W = W;
  g.z0 = z0;
  g.y0 = y0;
  g.x0 = x0;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  const dim3 block((unsigned)bx, (unsigned)tx, (unsigned)ty);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    blend_kernel<4><<<grid, block, 0, s>>>(acc, logits, imp, wacc, win, g);
  else
    blend_kernel<1><<<grid, block, 0, s>>>(acc, logits, imp, wacc, win, g);
  return static_cast<int>(cudaGetLastError());
}
