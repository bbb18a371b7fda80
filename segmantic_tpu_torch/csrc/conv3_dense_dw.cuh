// Hopper body of the dense weight-gradient kernel (fused_conv_dw.cu) for bf16
// NDHWC input with C = CO = 8 (SegResNet's 96^3 x 8) or 16 (the flagship's
// 48^3 x 16, UNETR(pack=False)'s 96^3 x 16), W * C a multiple of 64.
//
// It replaces, with the other bodies, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_dw_kernel (conv3d_packed_dw, line 289)
// at these shapes:
//
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]      (f32)
//
// What bounds it on the card: bytes (48^3 x 16 at batch 8: 28 MB, 0.0169 ms,
// for 12.2 GFLOP of true products). conv3_dw_mma.cuh ran it at 2.7-3.8x its
// bound with N = CO = 8 or 16 and ldmatrix.trans operands. Here both operands
// are 128-byte rows of 64 lanes (u = 64 / C voxels x C) straight from TMA:
//
// - Per (tz, ty) shift and half h of dy's row j (voxels h u / 2 .. h u / 2 +
//   u / 2 - 1, 32 lanes), a GEMM with M = 64 lanes of a window of x, N = the
//   half's 32 lanes, K = positions (rows), both operands MN-major by
//   descriptor. The window of half h starts s_h = h u / 2 - 1 voxels from row
//   j's first (lanes 64 j + s_h C ..: s_0 = -1; s_1 = 1 at C = 16, 3 at C = 8),
//   so it holds the u / 2 + 2 input voxels its half reads: output voxel x_l of
//   the half takes tap tx from window voxel x_l + tx. The u x u / 2 blocks of C
//   x C are window voxel x dy voxel; the three diagonals x'' = x_l + tx are the
//   taps: 3 u / 2 of u^2 / 2 blocks (75% at C = 16, 37.5% at C = 8). TMA fills
//   the lanes outside a line with zeros (the SAME padding along x); the
//   windows' starts are 16-byte aligned.
// - A block walks the bricks blockIdx.x + k gridDim.x: 8 y x 8 z positions of
//   one row j (a k16 step two z planes of 8 y). Its three consumer warpgroups
//   are the three tz, each with six accumulators of 64 x 32 (two halves x three
//   ty), and read one staged brick: per brick the producer warp brings dy's
//   two halves (32 lanes x 8 y x 8 z, 64-byte swizzled) and the two windows
//   (64 lanes x 10 y x 10 z, one plane and one line each side, 128-byte
//   swizzled), four TMA loads of 4-D maps over (W C lanes, H, D, B), into a
//   ring of `stages`; a (tz, ty) shift is a start moved by whole rows, the k
//   groups a z plane apart (SBO = the box's row pitch). A first design (two
//   windows -1 and +1 voxel against dy's whole row, N = 64) multiplied twice
//   the products and ran 1.04-1.10x the tensor-core body at 16 channels.
// - wgmma.mma_async m64n32k16, both operands by descriptor and MN-major: a
//   warpgroup issues the brick's 24 steps straight-line and commits; the
//   wait leaves that group in flight while the next brick's is issued, and
//   a slot is released when all three warpgroups' groups on it have retired.
// - The block's epilogue: after the last brick the warpgroups write their
//   accumulators to shared memory (over the ring), then the 384 consumer
//   threads sum the diagonal blocks in a fixed order into the block's partial
//   of the 27 taps, workspace [blockIdx.x][27][C][CO]; dw_reduce_kernel (or
//   dw_reduce_lanes_kernel) sums the partials in a fixed order. No atomics:
//   a repeated launch is bit-equal.
// Grid and ring depth are the wrapper's plan (ops/fused_conv.py::
// dense_dw_plan); the launcher refuses a plan whose shared-memory sum differs
// from its own (dense_dw_smem_bytes).
#pragma once

#include "conv3_dense.cuh"
#include "conv3_mid_dw.cuh"

namespace segk {

constexpr int DENSE_DW_THREADS = 128 * 3 + 32;  // three consumer warpgroups, a producer warp
constexpr int DENSE_DW_HALF_BYTES = 8 * 8 * 64;  // a half of dy: 8 y x 8 z rows of 64 bytes
constexpr int DENSE_DW_SLOT_BYTES = 2 * DENSE_DW_HALF_BYTES + 2 * DENSE_BOX_BYTES;
constexpr int DENSE_DW_G_PITCH = 33;  // floats a row of a 64 x 32 sum in the epilogue
constexpr int DENSE_DW_G_BYTES = 3 * 3 * 2 * 64 * DENSE_DW_G_PITCH * 4;

// 1024 bytes to align the base, 1024 of barriers, `stages` slots (which the
// epilogue's sums reuse: at least DENSE_DW_G_BYTES). The wrapper's plan
// computes the same sum: the launcher refuses a mismatch.
__host__ __device__ constexpr int dense_dw_smem_bytes(int stages) {
  return 2048 + stages * DENSE_DW_SLOT_BYTES;
}

// D (m64 x n32, f32) += A (m64 x k16) * B (k16 x n32), both by descriptor and
// both MN-major (the transpose bits set).
__device__ __forceinline__ void wgmma_ss_n32_mn(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

struct DenseDwArgs {
  float* part;  // [blockIdx.x][27][C][C]
  int D, H, nrows;
  int nby, nbz, nbricks;
  int stages;
};

template <int C>
__global__ void __launch_bounds__(DENSE_DW_THREADS, 1)
    conv3_dense_dw_kernel(const __grid_constant__ CUtensorMap tmx,
                          const __grid_constant__ CUtensorMap tmdy, const DenseDwArgs a) {
  constexpr int U = 64 / C, UH = U / 2;
  constexpr int X0 = 2 * DENSE_DW_HALF_BYTES;  // the windows after dy's halves
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.stages;

  const uint32_t bars = smem_addr(smem);
  auto bar = [&](int i) { return bars + 8 * i; };  // full [0, S), empty [S, 2S)
  const uint32_t ring0 = bars + 1024;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar(i), 1);
      mbar_init(bar(S + i), 12);  // the twelve warps of the three warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (a.nbricks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (warp == 12) {  // the producer warp: lane 0 issues the copies
    if (lane == 0) {
      for (int k = 0; k < nk; ++k) {
        int b, z0, y0, j;
        dense_origin(blockIdx.x + k * gridDim.x, a.nrows, a.nby, a.nbz, b, z0, y0, j);
        const int s = k % S;
        mbar_wait(bar(S + s), ((k / S) & 1) ^ 1);
        mbar_expect_tx(bar(s), 2 * 64 * 64 + 2 * DENSE_HALO * DENSE_HALO * 128);
        const uint32_t slot = ring0 + s * DENSE_DW_SLOT_BYTES;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tma_load_4d(slot + h * DENSE_DW_HALF_BYTES, &tmdy, bar(s), 64 * j + 32 * h, y0, z0, b);
          tma_load_4d(slot + X0 + h * DENSE_BOX_BYTES, &tmx, bar(s), 64 * j + (h * UH - 1) * C,
                      y0 - 1, z0 - 1, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: tz = wg, accumulators of (half, ty); brick k's
  // group stays in flight while brick k + 1's is issued
  const int wg = warp >> 2, w = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  float acc[2][3][16];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int n = 0; n < 16; ++n) acc[h][i][n] = 0.f;
  int prev = 0;
  for (int k = 0; k < nk; ++k) {
    const int s = k % S;
    mbar_wait(bar(s), (k / S) & 1);
    const uint32_t slot = ring0 + s * DENSE_DW_SLOT_BYTES;
    // B: a half of dy's rows, the k groups (z planes) 8 rows of 64 bytes
    // apart; A: its window's rows at the (tz, ty) shift, the k groups 10 rows
    // of 128 bytes apart
    const uint64_t db0 = desc_b64(slot, 1, 8 * 64 / 16);
    const uint64_t da0 = desc_b128(slot + X0 + wg * DENSE_HALO * 128, 1, DENSE_HALO * 8);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
          wgmma_ss_n32_mn(
              acc[h][ty],
              da0 + ((h * DENSE_BOX_BYTES + (2 * q * DENSE_HALO + ty) * 128) >> 4),
              db0 + ((h * DENSE_DW_HALF_BYTES + 2 * q * 8 * 64) >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // brick k - 1's group has retired: its slot is free
    if (k > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(S + prev));
    }
    prev = s;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 3; ++i) fence_acc(acc[h][i]);

  // every warpgroup's products have retired: the ring holds their sums now
  asm volatile("bar.sync 3, 384;\n" ::: "memory");
  float* gsum = reinterpret_cast<float*>(smem + 1024);  // [tz][ty][h][64][DENSE_DW_G_PITCH]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* row = gsum + (((wg * 3 + ty) * 2 + h) * 64 + 16 * w + g8 + 8 * half) *
                                DENSE_DW_G_PITCH;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          row[8 * jj + 2 * t4] = acc[h][ty][4 * jj + 2 * half];
          row[8 * jj + 2 * t4 + 1] = acc[h][ty][4 * jj + 2 * half + 1];
        }
      }
  asm volatile("bar.sync 3, 384;\n" ::: "memory");
  // the block's 27 taps, a fixed order: tap (tz, ty, tx) sums, over the halves
  // and their voxels x_l, G[tz][ty][h][(x_l + tx) C + ci][x_l C + co]
  float* part = a.part + (long long)blockIdx.x * 27 * C * C;
  for (int e = tid; e < 27 * C * C; e += 384) {
    const int t = e / (C * C), ci = e / C % C, co = e % C;
    const int tx = t % 3;
    const float* g = gsum + (t / 3) * 2 * 64 * DENSE_DW_G_PITCH;
    float v = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int xl = 0; xl < UH; ++xl)
        v += g[(h * 64 + (xl + tx) * C + ci) * DENSE_DW_G_PITCH + xl * C + co];
    part[e] = v;
  }
}

template <int C>
cudaError_t launch_dense_dw_inst(const CUtensorMap& tmx, const CUtensorMap& tmdy,
                                 const DenseDwArgs& a, int grid_x, int smem_bytes,
                                 cudaStream_t stream) {
  auto kernel = conv3_dense_dw_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_x, DENSE_DW_THREADS, smem_bytes, stream>>>(tmx, tmdy, a);
  return cudaGetLastError();
}

// x and dy bf16 (B, D, H, W, C); ws holds grid_x * 27 * C * C floats; out
// (3, 3, 3, C, C) f32. (grid_x, stages, smem_bytes) is the wrapper's plan
// (ops/fused_conv.py::dense_dw_plan): grid_x blocks, then the reduce.
inline int launch_conv3_dense_dw(const void* x, const void* dy, float* ws, float* out, int B,
                                 int D, int H, int W, int C, int CO, int grid_x, int stages,
                                 int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if ((C != 8 && C != 16) || CO != C || (W * C) % 64 || grid_x < 1 || grid_x > 65535 ||
      stages < 2 || stages * DENSE_DW_SLOT_BYTES < DENSE_DW_G_BYTES)
    return invalid;
  DenseDwArgs a;
  a.part = ws;
  a.D = D, a.H = H, a.nrows = W * C / 64;
  a.nby = (H + 7) / 8, a.nbz = (D + 7) / 8;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nrows;
  if (nbricks > 0x7fffffffLL || grid_x > nbricks) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.stages = stages;
  if (smem_bytes != dense_dw_smem_bytes(stages) || smem_bytes > 232448) return invalid;
  CUtensorMap tmx, tmdy;
  if (!encode_lines(&tmx, x, B, D, H, W * C, DENSE_HALO, DENSE_HALO) ||
      !encode_lines(&tmdy, dy, B, D, H, W * C, 8, 8, 32))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = C == 8 ? launch_dense_dw_inst<8>(tmx, tmdy, a, grid_x, smem_bytes, s)
                           : launch_dense_dw_inst<16>(tmx, tmdy, a, grid_x, smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 27LL * C * C;
  if (grid_x < 16) {  // few partials: one thread per element walks them
    dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ws, out, n, grid_x);
  } else {
    dw_reduce_lanes_kernel<<<(unsigned)((n + 31) / 32), 256, 0, s>>>(ws, out, n, grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk
