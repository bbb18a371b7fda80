// Hopper body of the dense stride-1 SAME 3x3x3 convolution (fused_conv.cu)
// for bf16 NDHWC input with C = CO = 8 (SegResNet's 96^3 x 8 convs) or 16
// (the flagship's 48^3 x 16 stage, UNETR(pack=False)'s 96^3 x 16 convs),
// W * C a multiple of 64; forward and input gradient (the same conv with
// flipped, swapped weights).
//
// It replaces, with the other bodies of fused_conv.cu, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_kernel (conv3d_packed_p, line 173) at
// these shapes: out[b, p, co] = act((sum_{t, ci} x[b, p + t - 1, ci] w[t, ci,
// co]) scale[co] + shift[co]).
//
// What bounds it on the card: bytes. 48^3 x 16 at batch 4 moves 28 MB (0.0085
// ms at 3.35 TB/s) for 6.1 GFLOP of true products; 96^3 x 8 at batch 8 113 MB
// for 12.2 GFLOP. conv3_mma.cuh ran these rows at 3.1-4.8x their bound: it
// walks positions with N = CO = 8 or 16, so one ldmatrix of A feeds a single
// m16n8k16, and its 16-byte cp.async staging runs beside the products.
// Here the layout itself gives the tensor cores a wide N:
//
// - A row. The 64 lanes x[b, z, y, u j .. u j + u - 1, :] (u = 64 / C
//   voxels) are one 128-byte row j of the line (b, z, y). The GEMM is M =
//   rows, N = the row's 64 output lanes (u voxels x CO), and per (tz, ty) K =
//   the u + 2 input voxels row j reads: a window of 64 lanes from voxel u j -
//   1 (4 k16 steps; the packed weights hold the three tx diagonals of the
//   window voxel x output voxel blocks, zeros elsewhere) and a tail of the two
//   voxels past it (2 C lanes: 1 k16 step at C = 8, 2 at C = 16), which feed
//   only the row's last two output voxels: m64n(2C)k16 into an accumulator of
//   its own (columns 64 - 2C .. 63, added in the epilogue). 36 n64 and 9 n16
//   (C = 8) or 18 n32 (C = 16) steps a brick, 1.5x the true products at C =
//   16 and 2.6x at C = 8. A first design read the neighbour rows j - 1 and j +
//   1 whole (three 128-byte boxes a brick) for one k16 step each, 36 n64 and
//   18 n16 steps: its staging alone and its wgmma alone each took ~85% of its
//   time (probe_dense_rows.py --variants).
// - Staging. A brick, the M of a wgmma, is 8 y x 8 z of one row j: the 8 M
//   rows of a core-matrix group are 8 consecutive y (consecutive rows of the
//   staged box), the groups the 8 z planes (SBO = the box's 10-row pitch), so
//   any H, D multiple of 8 fills every brick whatever W is. The producer warp
//   brings, per brick, two TMA boxes of 10 y x 10 z rows (4-D maps over (W C
//   lanes, H, D, B)): the window, 64 lanes from lane 64 j - C, 128-byte
//   swizzled, and the tail, 2 C lanes from lane 64 j + 64 - C, swizzled at its
//   32- or 64-byte rows; zero outside the volume (SAME padding, the lanes
//   outside a line and ragged bricks), into a ring of `stages` slots.
// - Operand A by descriptor straight from the slot: a (tz, ty) shift is a
//   start moved by whole rows, a k16 step 32 bytes into the row (both read
//   right with base offset 0, probe_mid_wgmma.py).
// - Operand B: the packed weights (ops/fused_conv.py::pack_weights_dense: 9
//   tiles of 64 N rows x 64 k for the window, then tiles of 2C N rows x 64 k
//   holding the tail steps, K-major and 128-byte swizzled) come once per
//   block by one bulk copy and stay resident (78 / 92 KB).
// - The two consumer warpgroups take their own bricks and turns to issue
//   (conv3_phase.cuh's named barriers), a brick's 54 wgmma straight-line from
//   fence to commit, one commit group; one producer warp keeps the ring full.
// - Epilogue from the accumulator layout: scale and shift of the true channel
//   (n mod CO), none / relu / prelu, bf16 or f32 pairs at the row's lanes; rows
//   past D or H are not stored. No atomics and a fixed summation order: a
//   repeated launch is bit-equal.
// Ring depth and grid are the wrapper's plan (ops/fused_conv.py::
// dense_fwd_plan); the launcher refuses a plan whose shared-memory sum differs
// from its own (dense_fwd_smem_bytes).
#pragma once

#include "conv3_phase.cuh"

namespace segk {

constexpr int DENSE_NWG = 2;                       // consumer warpgroups
constexpr int DENSE_THREADS = 128 * DENSE_NWG + 32;  // and the producer warp
constexpr int DENSE_HALO = 10;                     // a brick's halo: 10 y x 10 z rows a box
constexpr int DENSE_BOX_BYTES = round1024(DENSE_HALO * DENSE_HALO * 128);  // the window
constexpr int DENSE_W_MAIN = 9 * 64 * 128;  // a tile of 64 N rows x 64 k for each (tz, ty)

// the tail's box: 10 x 10 rows of 2 C lanes (4 C bytes)
__host__ __device__ constexpr int dense_tail_bytes(int c) {
  return round1024(DENSE_HALO * DENSE_HALO * 4 * c);
}
__host__ __device__ constexpr int dense_slot_bytes(int c) {
  return DENSE_BOX_BYTES + dense_tail_bytes(c);
}
// the tail's 9 C / 8 k16 steps, 4 to a tile of 2 C N rows x 128 bytes
__host__ __device__ constexpr int dense_w_bytes(int c) {
  return DENSE_W_MAIN + (9 * c / 8 + 3) / 4 * 2 * c * 128;
}
// 1024 bytes to align the base, 1024 of barriers, the resident weights,
// `stages` slots. The wrapper's plan computes the same sum: the launcher
// refuses a mismatch.
__host__ __device__ constexpr int dense_fwd_smem_bytes(int c, int stages) {
  return 2048 + dense_w_bytes(c) + stages * dense_slot_bytes(c);
}

// Shared-memory matrix descriptors, 64- and 32-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_b64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo & 0x3FFF) << 16 |
         (uint64_t)(sbo & 0x3FFF) << 32 | 2ull << 62;
}
__device__ __forceinline__ uint64_t desc_b32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo & 0x3FFF) << 16 |
         (uint64_t)(sbo & 0x3FFF) << 32 | 3ull << 62;
}

// A TMA map of a bf16 tensor seen as (B, D, H) lines of `lanes` values (W C),
// whose box is box_lanes (64, 32 or 16) lanes x bh y x bd z of one sample, one
// row of 128 (64, 32) bytes a (z, y), swizzled at its width; lanes, y or z
// outside the tensor arrive as zeros.
inline bool encode_lines(CUtensorMap* map, const void* base, int B, int D, int H, int lanes,
                         int bh, int bd, int box_lanes = 64) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)lanes, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t line = (cuuint64_t)lanes * 2;
  const cuuint64_t strides[3] = {line, line * H, line * H * D};
  const cuuint32_t box[4] = {(cuuint32_t)box_lanes, (cuuint32_t)bh, (cuuint32_t)bd, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_lanes == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
            : box_lanes == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

struct DenseFwdArgs {
  const float* scale;
  const float* shift;
  const float* alpha;
  void* out;  // (B, D, H, W, CO)
  int relu_mode, out_bf16;
  int D, H, nrows;  // nrows = W C / 64 rows a line
  int nby, nbz, nbricks;
  int stages;
};

// brick -> (b, z0, y0, row j): rows fastest, then y, z, b
__device__ __forceinline__ void dense_origin(int brick, int nrows, int nby, int nbz, int& b,
                                             int& z0, int& y0, int& j) {
  j = brick % nrows;
  brick /= nrows;
  y0 = (brick % nby) * 8;
  brick /= nby;
  z0 = (brick % nbz) * 8;
  b = brick / nbz;
}

template <int C>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    conv3_dense_fwd_kernel(const __grid_constant__ CUtensorMap tm,
                           const __grid_constant__ CUtensorMap tmt,
                           const __nv_bfloat16* __restrict__ wp, const DenseFwdArgs a) {
  constexpr int NWG = DENSE_NWG, BOX = DENSE_BOX_BYTES, SLOT = dense_slot_bytes(C);
  constexpr int NT = 2 * C, TB = 4 * C;  // the tail's N and its rows' bytes
  constexpr int WB = dense_w_bytes(C);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.stages;

  const uint32_t bars = smem_addr(smem);
  auto bar = [&](int i) { return bars + 8 * i; };  // full [0, S), empty [S, 2S), weights 2S
  const uint32_t wsm = bars + 1024;
  const uint32_t wtail = wsm + DENSE_W_MAIN;
  const uint32_t ring0 = wsm + WB;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar(i), 1);
      mbar_init(bar(S + i), 4);  // the four warps of the brick's warpgroup
    }
    mbar_init(bar(2 * S), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (a.nbricks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (warp == 4 * NWG) {  // the producer warp: lane 0 issues the copies
    if (lane == 0) {
      mbar_expect_tx(bar(2 * S), WB);
      bulk_load(wsm, wp, WB, bar(2 * S));
      for (int k = 0; k < nk; ++k) {
        int b, z0, y0, j;
        dense_origin(blockIdx.x + k * gridDim.x, a.nrows, a.nby, a.nbz, b, z0, y0, j);
        const int s = k % S;
        mbar_wait(bar(S + s), ((k / S) & 1) ^ 1);
        mbar_expect_tx(bar(s), DENSE_HALO * DENSE_HALO * (128 + TB));
        const uint32_t slot = ring0 + s * SLOT;
        tma_load_4d(slot, &tm, bar(s), 64 * j - C, y0 - 1, z0 - 1, b);
        tma_load_4d(slot + BOX, &tmt, bar(s), 64 * j + 64 - C, y0 - 1, z0 - 1, b);
      }
    }
    return;
  }

  // a consumer warpgroup: the block's bricks k = wg, wg + 2, ..., issued in
  // turn with the other warpgroup (brick k after brick k - 1)
  const int wg = warp >> 2, w = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  // scale and shift of the column pair 8 j + 2 t4: true channel (8 j + 2 t4) % C
  float sc[2][2], sh[2][2];
#pragma unroll
  for (int jp = 0; jp < 2; ++jp)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int co = (8 * jp + 2 * t4 + k) % C;
      sc[jp][k] = a.scale[co];
      sh[jp][k] = a.shift[co];
    }
  const float slope = a.relu_mode == 2 ? a.alpha[0] : 0.f;
  constexpr uint32_t SBO = DENSE_HALO * 128 / 16;  // the z planes of a box: its 10-row pitch
  const uint64_t db0 = desc_b128(wsm, 1, 64);
  const uint64_t dt0 = desc_b128(wtail, 1, 64);
  const long long line = (long long)a.nrows * 64;  // lanes a line

  float acc[32], acct[NT / 2];
  mbar_wait(bar(2 * S), 0);  // the resident weights
  for (int k = wg; k < nk; k += NWG) {
    const int s = k % S;
    mbar_wait(bar(s), (k / S) & 1);
    turn_wait(wg, k > 0);  // brick k - 1's products are issued
#pragma unroll
    for (int n = 0; n < 32; ++n) acc[n] = 0.f;
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) acct[n] = 0.f;
    const uint32_t slot = ring0 + s * SLOT;
    const uint64_t da0 = desc_b128(slot, 1, SBO);
    // the tail's rows: TB bytes, swizzled at that width, the z planes 10 rows apart
    const uint64_t dta0 = C == 8 ? desc_b32(slot + BOX, 1, DENSE_HALO * TB / 16)
                                 : desc_b64(slot + BOX, 1, DENSE_HALO * TB / 16);
    fence_acc(acc);
    fence_acc(acct);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      // the (tz, ty) shift: rows of the boxes, which start one z and one y early
      const int row = (t / 3) * DENSE_HALO + t % 3;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wgmma_ss_n64(acc, da0 + ((row * 128 + 32 * q) >> 4),
                     db0 + ((t * 64 * 128 + 32 * q) >> 4));
#pragma unroll
      for (int q = 0; q < C / 8; ++q) {  // the tail: its k16 step e = t C / 8 + q
        const int e = t * (C / 8) + q;
        wgmma_ss<NT>(acct, dta0 + ((row * TB + 32 * q) >> 4),
                     dt0 + (((e >> 2) * NT * 128 + (e & 3) * 32) >> 4));
      }
    }
    wgmma_commit();
    turn_pass(wg, k + 1 < nk);  // brick k + 1 may issue
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(acct);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(S + s));

    // the tail's accumulator is columns 64 - 2C .. 63 of the n64 layout
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) acc[32 - NT / 2 + n] += acct[n];
    // epilogue: accumulator (row g8 + 8 half + 16 w, columns 8 j + 2 t4, + 1);
    // row r is (z, y) = (r / 8, r % 8) of the brick, column n output lane n of
    // its row
    int b, z0, y0, j;
    dense_origin(blockIdx.x + k * gridDim.x, a.nrows, a.nby, a.nbz, b, z0, y0, j);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * w + g8 + 8 * half;
      const int gz = z0 + (r >> 3), gy = y0 + (r & 7);
      if (gz >= a.D || gy >= a.H) continue;
      const long long base = (((long long)b * a.D + gz) * a.H + gy) * line + 64 * j + 2 * t4;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int jp = C == 16 ? (jj & 1) : 0;
        const float v0 =
            activate(acc[4 * jj + 2 * half] * sc[jp][0] + sh[jp][0], a.relu_mode, slope);
        const float v1 =
            activate(acc[4 * jj + 2 * half + 1] * sc[jp][1] + sh[jp][1], a.relu_mode, slope);
        if (a.out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + base + 8 * jj) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + 8 * jj) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

template <int C>
cudaError_t launch_dense_fwd_inst(const CUtensorMap& tm, const CUtensorMap& tmt,
                                  const __nv_bfloat16* wp, const DenseFwdArgs& a, int grid_x,
                                  int smem_bytes, cudaStream_t stream) {
  auto kernel = conv3_dense_fwd_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_x, DENSE_THREADS, smem_bytes, stream>>>(tm, tmt, wp, a);
  return cudaGetLastError();
}

// x bf16 (B, D, H, W, C); packed weights (pack_weights_dense); out bf16 or
// f32 (B, D, H, W, CO). (grid_x, stages, smem_bytes) is the wrapper's plan
// (ops/fused_conv.py::dense_fwd_plan); a brick is 8 z x 8 y of one row, a
// slot a warpgroup at least.
inline int launch_conv3_dense_fwd(const void* x, const void* wp, const float* scale,
                                  const float* shift, const float* alpha, int relu_mode,
                                  void* out, int B, int D, int H, int W, int C, int CO,
                                  int out_bf16, int grid_x, int stages, int smem_bytes,
                                  void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if ((C != 8 && C != 16) || CO != C || (W * C) % 64 || stages < DENSE_NWG || stages > 8 ||
      grid_x < 1)
    return invalid;
  DenseFwdArgs a;
  a.scale = scale, a.shift = shift, a.alpha = alpha;
  a.out = out;
  a.relu_mode = relu_mode, a.out_bf16 = out_bf16;
  a.D = D, a.H = H, a.nrows = W * C / 64;
  a.nby = (H + 7) / 8, a.nbz = (D + 7) / 8;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nrows;
  if (nbricks > 0x7fffffffLL || grid_x > nbricks) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.stages = stages;
  if (smem_bytes != dense_fwd_smem_bytes(C, stages) || smem_bytes > 232448) return invalid;
  CUtensorMap tm, tmt;  // the window's map and the tail's
  if (!encode_lines(&tm, x, B, D, H, W * C, DENSE_HALO, DENSE_HALO) ||
      !encode_lines(&tmt, x, B, D, H, W * C, DENSE_HALO, DENSE_HALO, 2 * C))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wp);
  return static_cast<int>(
      C == 8 ? launch_dense_fwd_inst<8>(tm, tmt, w, a, grid_x, smem_bytes, s)
             : launch_dense_fwd_inst<16>(tm, tmt, w, a, grid_x, smem_bytes, s));
}

}  // namespace segk
