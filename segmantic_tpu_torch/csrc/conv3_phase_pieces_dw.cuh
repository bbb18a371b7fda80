// Hopper body of the phase-space weight gradient (phase_conv_dw_pieces.cu) at
// Ci = Co = 8: the flagship's L = 64 (its 96^3 x 8 top stage in phase layout,
// p (B, 48^3, 64)).
//
// It replaces, with the other bodies of phase_conv_dw.cu, the Pallas kernel
// segmantic_tpu/ops/phase_gemm.py::_dw_kernel_folded
// (phase_conv_gemm_dw_folded_p, line 430) together with _unfold_dw: the
// result is the true (3, 3, 3, 8, 8) kernel,
//   dw[t, ci, co] = sum_{b, v} d2s(p)[b, v + t - 1, ci] * d2s(g)[b, v, co]   (f32),
// and no (L, L) block reaches device memory.
//
// What bounds it on the card: bytes (226 MB of p and g at batch 8, 0.068
// ms, for 24.5 GFLOP of true products). conv3_phase_dw.cuh, whose tiles are
// (tz, ty, x piece, co) with N = (a'x, ci) = 16, leaves half of each m64 tile
// padding rows at Co = 8 and issues 36 m64n16k16 a k16 step: it ran L = 64
// slower than conv3_dw_mma.cuh. Here the y pieces go into the rows too:
//
// - Which products. A block voxel u of p holds the input phases a' of the
//   full-resolution voxels 2 u + a'; of g, the output phases a. The pair
//   (a' at u, a at u + e) is tap t = a' + 1 - s per dimension, s = a + 2 e;
//   a piece is one (e, a), s = -1 (e = -1, a = 1), 0, 1 (e = 0) or 2 (e =
//   1, a = 0).
// - Per k16 step (16 brick positions) and pass a'z, operand B is p's 32
//   lanes (a'y, a'x, ci) of a'z (N = 32, a start inside the 128-byte row,
//   MN-major by descriptor), and the warpgroup tz multiplies two tiles whose
//   64 rows are (y piece, x piece, co): warp w holds x piece w, its rows 0-7
//   y piece 2 T and rows 8-15 y piece 2 T + 1 (tile T) of the z piece s_z =
//   a'z + 1 - tz. Column (a'y, a'x) of row (s_y, s_x) is tap ty = a'y + 1 -
//   s_y, tx = a'x + 1 - s_x, or outside 0..2 (7/16 of the products: 1.78x the
//   true count, against 2.7x with padding rows). 12 m64n32k16 a step.
// - Operand A (g) from registers: one ldmatrix.x4.trans a tile, each lane
//   the row address of its position, z / y / x shift and phase (its 8 co).
// - Staging as in conv3_phase_dw.cuh: per brick of td x th x tw block voxels
//   the p brick and the g brick with a one-voxel halo, one TMA load of a 5-D
//   box each, 128-byte swizzled, zero outside the volume, into a ring of
//   `stages`; here one producer warp issues them.
// - A warpgroup issues a k16 step's four wgmma (two passes x two tiles) as
//   one commit group; the next step's fragments load while it runs (two
//   register sets, the brick's steps an even count).
// - Deterministic without atomics: every (a'y, a'x, tap, ci, co) of a block
//   sits in one thread's registers, so each block writes four partials
//   [split][a'y][a'x][27][8][8] and dw_reduce_kernel (or
//   dw_reduce_lanes_kernel) sums the 4 x splits partials in a fixed order; a
//   repeated launch is bit-equal.
// Brick, ring depth and splits are the wrapper's plan (ops/fused_conv.py::
// phase_pieces_plan); the launcher refuses a plan whose shared-memory sum
// differs from its own (phase_pieces_smem_bytes).
#pragma once

#include "conv3_phase_dw.cuh"

namespace segk {

constexpr int PHASE_PIECES_THREADS = 128 * 3 + 32;  // three consumer warpgroups, a producer warp

// One ring slot: the p brick (P rows of 128 bytes), then the g halo rounded
// to the swizzle's period of 1024 bytes.
__host__ __device__ constexpr int phase_pieces_slot_bytes(int td, int th, int tw) {
  return td * th * tw * 128 + round1024((td + 2) * (th + 2) * (tw + 2) * 128);
}

// 1024 bytes to align the base, 1024 of barriers and the halo-row table,
// `stages` slots. The wrapper's plan computes the same sum: the launcher
// refuses a mismatch.
__host__ __device__ constexpr int phase_pieces_smem_bytes(int td, int th, int tw, int stages) {
  return 2048 + stages * phase_pieces_slot_bytes(td, th, tw);
}

struct PhasePiecesArgs {
  float* part;  // [split][a'y][a'x][27][8][8]
  int td, th, tw;
  int nbz, nby, nbx, nbricks;  // over the block grid (D / 2, H / 2, W / 2)
  int stages;
};

__global__ void __launch_bounds__(PHASE_PIECES_THREADS, 1)
    conv3_phase_pieces_kernel(const __grid_constant__ CUtensorMap tmp,
                              const __grid_constant__ CUtensorMap tmg, const PhasePiecesArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HP = a.th + 2, WP = a.tw + 2;
  const int P = a.td * a.th * a.tw;
  const int halo_rows = (a.td + 2) * HP * WP;
  const int p_plane = P * 128;
  const int slot_bytes = phase_pieces_slot_bytes(a.td, a.th, a.tw);
  const int S = a.stages;

  const uint32_t bars = smem_addr(smem);
  auto bar = [&](int i) { return bars + 8 * i; };  // full [0, S), empty [S, 2S)
  int* qtab = reinterpret_cast<int*>(smem + 256);  // brick position -> its g halo row
  const uint32_t ring0 = bars + 1024;
  const int split = blockIdx.x;
  const int nk = (a.nbricks - split + (int)gridDim.x - 1) / (int)gridDim.x;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar(i), 1);
      mbar_init(bar(S + i), 12);  // the twelve warps of the three warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int q = tid; q < P; q += blockDim.x) {
    const int qz = q / (a.th * a.tw), r = q - qz * a.th * a.tw;
    qtab[q] = ((qz + 1) * HP + r / a.tw + 1) * WP + r % a.tw + 1;
  }
  __syncthreads();

  if (warp == 12) {  // the producer warp: lane 0 issues the copies
    if (lane == 0) {
      for (int k = 0; k < nk; ++k) {
        int r = split + k * (int)gridDim.x;
        const int x0 = (r % a.nbx) * a.tw;
        r /= a.nbx;
        const int y0 = (r % a.nby) * a.th;
        r /= a.nby;
        const int z0 = (r % a.nbz) * a.td, b = r / a.nbz;
        const int s = k % S;
        mbar_wait(bar(S + s), ((k / S) & 1) ^ 1);
        mbar_expect_tx(bar(s), (uint32_t)(P + halo_rows) * 128);
        const uint32_t slot = ring0 + s * slot_bytes;
        tma_load_5d(slot, &tmp, bar(s), 0, x0, y0, z0, b);
        tma_load_5d(slot + p_plane, &tmg, bar(s), 0, x0 - 1, y0 - 1, z0 - 1, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, w = warp & 3;  // tz = wg; x piece w
  const int krow = (lane & 7) + ((lane >> 4) << 3);  // ldmatrix.trans: this lane's k row
  const int mem = (lane >> 3) & 1;                   // and its rows' y piece of the pair
  // x piece w: (e_x, a_x) = (0, 0), (0, 1), (-1, 1), (+1, 0), s_x = 0, 1, -1, 2
  const int ex = w == 2 ? -1 : (w == 3 ? 1 : 0);
  const int ax = (w == 1 || w == 2) ? 1 : 0;
  // this lane's halo-row shift and lane offset for (pass a'z, tile T)
  int hoff[2][2], loff[2][2];
#pragma unroll
  for (int apz = 0; apz < 2; ++apz)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int sz = apz + 1 - wg, sy = 2 * t + mem - 1;
      hoff[apz][t] = ((sz >> 1) * HP + (sy >> 1)) * WP + ex;
      loff[apz][t] = ((sz & 1) * 4 + (sy & 1) * 2 + ax) * 8;
    }
  float acc[2][16];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[t][n] = 0.f;

  const int nks = P >> 4;
  uint32_t pbase = ring0, gbase = ring0;
  // the four fragments of a k16 step: (a'z, T) = (i / 2, i % 2)
  auto load = [&](int hr0, uint32_t(&f)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hr = hr0 + hoff[i >> 1][i & 1];
      ldsm_x4_trans(gbase + hr * 128 + (((loff[i >> 1][i & 1] >> 3) ^ (hr & 7)) << 4), f[i][0],
                    f[i][1], f[i][2], f[i][3]);
    }
  };
  // operand B of pass a'z at k16 step ks: p's lanes 32 a'z .. 32 a'z + 31,
  // the step's 16 rows 1024 bytes per 8
  auto issue = [&](int ks, uint32_t(&f)[4][4]) {
#pragma unroll
    for (int t = 0; t < 2; ++t) fence_acc(acc[t]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wgmma_rs_n32_mn(acc[i & 1], f[i], desc_b128(pbase + ks * 2048 + (i >> 1) * 64, 1, 64));
    wgmma_commit();
  };
  uint32_t fa[4][4], fb[4][4];
  for (int k = 0; k < nk; ++k) {
    const int s = k % S;
    mbar_wait(bar(s), (k / S) & 1);
    pbase = ring0 + s * slot_bytes;
    gbase = pbase + p_plane;
    load(qtab[krow], fa);
    for (int ks = 0; ks < nks; ks += 2) {  // fa at even steps, fb at odd
      issue(ks, fa);
      wgmma_wait<1>();  // the step before retired: its fragments (fb) are free
      keep_live(fb);
      load(qtab[16 * (ks + 1) + krow], fb);
      issue(ks + 1, fb);
      wgmma_wait<1>();
      keep_live(fa);
      if (ks + 2 < nks) load(qtab[16 * (ks + 2) + krow], fa);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 2; ++t) fence_acc(acc[t]);
    keep_live(fa);
    keep_live(fb);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(S + s));
  }

  // accumulator (row 16 w + g8 + 8 half: y piece 2 T + half, co g8; columns
  // 8 j + 2 t4, + 1: a'y = j / 2, a'x = j % 2, ci = 2 t4, 2 t4 + 1)
  const int g8 = lane >> 2, t4 = lane & 3;
  const int t0x = 1 - ax - 2 * ex;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int sy = 2 * t + half - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int apy = j >> 1, apx = j & 1;
        const int ty = apy + 1 - sy, tx = apx + t0x;
        if (ty < 0 || ty > 2 || tx < 0 || tx > 2) continue;
        const int tap = (wg * 3 + ty) * 3 + tx;
        float* dst = a.part + ((4LL * split + 2 * apy + apx) * 27 + tap) * 64 + 2 * t4 * 8 + g8;
        dst[0] = acc[t][4 * j + 2 * half];
        dst[8] = acc[t][4 * j + 2 * half + 1];
      }
    }
}

// p and g (B, D/2, H/2, W/2, 64) bf16, phase-major (Ci = Co = 8); D, H, W the
// full-resolution (even) extents; ws holds 4 * splits * 27 * 64 floats; out
// (3, 3, 3, 8, 8) f32. (td, th, tw, splits, stages, smem_bytes) is the
// wrapper's plan (ops/fused_conv.py::phase_pieces_plan).
inline int launch_conv3_phase_pieces(const void* p, const void* g, float* ws, float* out, int B,
                                     int D, int H, int W, int Ci, int Co, int td, int th, int tw,
                                     int splits, int stages, int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const int P = td * th * tw;
  if (Ci != 8 || Co != 8 || D % 2 || H % 2 || W % 2 || td < 1 || th < 1 || tw < 1 ||
      td + 2 > 256 || th + 2 > 256 || tw + 2 > 256 || P % 32 || P > PHASE_DW_MAX_ROWS ||
      stages < 2 || splits < 1 || splits > 65535)
    return invalid;
  PhasePiecesArgs a;
  a.part = ws;
  a.td = td, a.th = th, a.tw = tw;
  const int D2 = D / 2, H2 = H / 2, W2 = W / 2;
  a.nbz = (D2 + td - 1) / td, a.nby = (H2 + th - 1) / th, a.nbx = (W2 + tw - 1) / tw;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  if (nbricks > 0x7fffffffLL || splits > nbricks) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.stages = stages;
  if (smem_bytes != phase_pieces_smem_bytes(td, th, tw, stages) || smem_bytes > 232448)
    return invalid;
  CUtensorMap tmp, tmg;
  if (!encode_ndhwc(&tmp, p, B, D2, H2, W2, 64, td, th, tw) ||
      !encode_ndhwc(&tmg, g, B, D2, H2, W2, 64, td + 2, th + 2, tw + 2))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      conv3_phase_pieces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3_phase_pieces_kernel<<<splits, PHASE_PIECES_THREADS, smem_bytes, s>>>(tmp, tmg, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nout = 27LL * 64;
  const int parts = 4 * splits;  // four partials a split: (a'y, a'x)
  if (parts < 16) {
    dw_reduce_kernel<<<(unsigned)((nout + 255) / 256), 256, 0, s>>>(ws, out, nout, parts);
  } else {
    dw_reduce_lanes_kernel<<<(unsigned)((nout + 31) / 32), 256, 0, s>>>(ws, out, nout, parts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk
