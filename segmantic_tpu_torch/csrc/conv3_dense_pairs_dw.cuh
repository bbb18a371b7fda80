// Hopper body of the dense weight-gradient kernel (fused_conv_dw_pairs.cu) for
// bf16 NDHWC input with C = CO = 32 and W even: the 24^3 x 32 gradients of
// the flagship UNet, SegResNet and UNETR (and 12^3 / 48^3 x 32 where the rule
// takes them).
//
// It replaces, with the other bodies, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_dw_kernel (conv3d_packed_dw, line 289)
// at these shapes:
//
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]      (f32)
//
// What bounds it on the card: operations (24^3 x 32 at batch 8: 6.1 GFLOP of
// true products against 14 MB). conv3_dw_mma.cuh ran it at 4.9x its bound
// with N = CO = 32 on ldmatrix.trans operands. Here both operands are
// 128-byte rows of 64 lanes (two voxels x 32 channels) straight from TMA, and
// the wgmma is m64n64k16 with both operands MN-major by descriptor:
//
// - K is (position, v): a k16 step is 8 y of one z plane of the brick, at
//   the row's two voxels v = 0 and 1 (the two 8-row groups, SBO apart).
// - Operand A (M = 64): x's lanes from voxel v - 1 of row j, i.e. input
//   voxels v - 1 (o = -1) and v (o = 0). For v = 0 that is the window of
//   lanes 64 j - 32 .. 64 j + 31, for v = 1 row j itself: two 128-byte boxes
//   of 10 y x 10 z rows, a (tz, ty) shift a start moved by whole rows.
// - Operand B (N = 64): dy's lanes from voxel v - 1, i.e. output voxels v - 1
//   (s = 0) and v (s = 1): the boxes of dy's rows at lanes 64 j - 32 and 64
//   j, 8 y x 8 z rows each.
// - The four 32 x 32 blocks (o, s) of an accumulator are the taps tx = o + 2
//   - s: (-1, 1) tap 0 and (0, 1) tap 1 take every output voxel 2 j + v once;
//   (0, 0) tap 2 takes the voxels 2 j + v - 1, which misses only the line's
//   last voxel, whose tap 2 reads the SAME padding past the line, and whose
//   first voxel's -1 is a zero TMA fills in. (-1, 0) is tap 1 again and is
//   never stored: 4/3 of the true products are multiplied.
// - A block walks the bricks blockIdx.x + k gridDim.x (8 y x 8 z positions of
//   one row j); its three consumer warpgroups are the three tz, each with
//   three accumulators of 64 x 64 (ty), and read one staged brick: a
//   warpgroup issues the brick's 24 steps straight-line and commits, the
//   wait leaving that group in flight while the next brick's is issued; one
//   producer warp brings the four boxes into a ring of `stages`.
// - Each tap of the block sits in one thread's registers: the epilogue
//   writes the block's partial of the 27 taps, workspace
//   [blockIdx.x][27][32][32], straight from the accumulators, and
//   dw_reduce_kernel (or dw_reduce_lanes_kernel) sums the partials in a fixed
//   order. No atomics: a repeated launch is bit-equal. What keeps 24^3 x 32
//   at 3.8x its bound is the cost that does not scale with the volume (the
//   launch, the ring's fill, the partials of 110 KB a block and their
//   reduce: ~13 us, probe_dense_rows.py --pairs --variants); summing a
//   cluster's blocks in distributed shared memory before the reduce ran
//   slower on an H100.
// Grid and ring depth are the wrapper's plan (ops/fused_conv.py::
// dense_pairs_plan); the launcher refuses a plan whose shared-memory sum
// differs from its own (dense_pairs_smem_bytes).
#pragma once

#include "conv3_dense.cuh"
#include "conv3_mid_dw.cuh"

namespace segk {

constexpr int DENSE_PAIRS_THREADS = 128 * 3 + 32;  // three consumer warpgroups, a producer warp
constexpr int DENSE_PAIRS_DY_BYTES = 8 * 8 * 128;  // a box of dy: 8 y x 8 z rows
// x's two windows (v = 0, 1), then dy's two boxes
constexpr int DENSE_PAIRS_SLOT_BYTES = 2 * DENSE_BOX_BYTES + 2 * DENSE_PAIRS_DY_BYTES;

// 1024 bytes to align the base, 1024 of barriers, `stages` slots. The
// wrapper's plan computes the same sum: the launcher refuses a mismatch.
__host__ __device__ constexpr int dense_pairs_smem_bytes(int stages) {
  return 2048 + stages * DENSE_PAIRS_SLOT_BYTES;
}

struct DensePairsArgs {
  float* part;  // [blockIdx.x][27][32][32]
  int nrows, nby, nbz, nbricks;
  int stages;
};

__global__ void __launch_bounds__(DENSE_PAIRS_THREADS, 1)
    conv3_dense_pairs_kernel(const __grid_constant__ CUtensorMap tmx,
                             const __grid_constant__ CUtensorMap tmdy, const DensePairsArgs a) {
  constexpr int DY0 = 2 * DENSE_BOX_BYTES;  // dy's boxes after x's windows
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
        mbar_expect_tx(bar(s), 2 * DENSE_HALO * DENSE_HALO * 128 + 2 * DENSE_PAIRS_DY_BYTES);
        const uint32_t slot = ring0 + s * DENSE_PAIRS_SLOT_BYTES;
#pragma unroll
        for (int v = 0; v < 2; ++v) {  // lanes from voxel v - 1 of row j
          tma_load_4d(slot + v * DENSE_BOX_BYTES, &tmx, bar(s), 64 * j + 32 * (v - 1), y0 - 1,
                      z0 - 1, b);
          tma_load_4d(slot + DY0 + v * DENSE_PAIRS_DY_BYTES, &tmdy, bar(s), 64 * j + 32 * (v - 1),
                      y0, z0, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: tz = wg, an accumulator a ty; brick k's group stays
  // in flight while brick k + 1's is issued
  const int wg = warp >> 2, w = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  float acc[3][32];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 32; ++n) acc[i][n] = 0.f;
  int prev = 0;
  for (int k = 0; k < nk; ++k) {
    const int s = k % S;
    mbar_wait(bar(s), (k / S) & 1);
    const uint32_t slot = ring0 + s * DENSE_PAIRS_SLOT_BYTES;
    // B: dy's rows of z plane q, the k groups (v) a box apart; A: the
    // window's rows at the (tz, ty) shift, the k groups (v) a box apart
    const uint64_t db0 = desc_b128(slot + DY0, 1, DENSE_PAIRS_DY_BYTES >> 4);
    const uint64_t da0 = desc_b128(slot + wg * DENSE_HALO * 128, 1, DENSE_BOX_BYTES >> 4);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
        wgmma_ss_n64_mn(acc[ty], da0 + (((q * DENSE_HALO + ty) * 128) >> 4),
                        db0 + ((q * 8 * 128) >> 4));
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
  for (int i = 0; i < 3; ++i) fence_acc(acc[i]);

  // accumulator rows 16 w + g8 + 8 half: o = w / 2 - 1, ci = (16 w + g8 + 8
  // half) % 32; columns 8 jj + 2 t4 (+ 1): s = jj / 4, co = 8 jj % 32 + 2 t4
  float* part = a.part + (long long)blockIdx.x * 27 * 32 * 32;
  const int o = (w >> 1) - 1;
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = (16 * w + g8 + 8 * half) & 31;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int sv = jj >> 2;
        if (o == -1 && sv == 0) continue;  // tap 1 again: never stored
        const int tx = o + 2 - sv, co = (8 * jj + 2 * t4) & 31;
        *reinterpret_cast<float2*>(part + (((wg * 3 + ty) * 3 + tx) * 32 + ci) * 32 + co) =
            make_float2(acc[ty][4 * jj + 2 * half], acc[ty][4 * jj + 2 * half + 1]);
      }
    }
}

// x and dy bf16 (B, D, H, W, 32); ws holds grid_x * 27 * 32 * 32 floats; out
// (3, 3, 3, 32, 32) f32. (grid_x, stages, smem_bytes) is the wrapper's plan
// (ops/fused_conv.py::dense_pairs_plan): grid_x blocks, then the reduce.
inline int launch_conv3_dense_pairs(const void* x, const void* dy, float* ws, float* out, int B,
                                    int D, int H, int W, int C, int CO, int grid_x, int stages,
                                    int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (C != 32 || CO != 32 || W % 2 || grid_x < 1 || grid_x > 65535 || stages < 2)
    return invalid;
  DensePairsArgs a;
  a.part = ws;
  a.nrows = W / 2;
  a.nby = (H + 7) / 8, a.nbz = (D + 7) / 8;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nrows;
  if (nbricks > 0x7fffffffLL || grid_x > nbricks) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.stages = stages;
  if (smem_bytes != dense_pairs_smem_bytes(stages) || smem_bytes > 232448) return invalid;
  CUtensorMap tmx, tmdy;
  if (!encode_lines(&tmx, x, B, D, H, W * C, DENSE_HALO, DENSE_HALO) ||
      !encode_lines(&tmdy, dy, B, D, H, W * C, 8, 8))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      conv3_dense_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3_dense_pairs_kernel<<<grid_x, DENSE_PAIRS_THREADS, smem_bytes, s>>>(tmx, tmdy, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 27LL * 32 * 32;
  if (grid_x < 16) {  // few partials: one thread per element walks them
    dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ws, out, n, grid_x);
  } else {
    dw_reduce_lanes_kernel<<<(unsigned)((n + 31) / 32), 256, 0, s>>>(ws, out, n, grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk
