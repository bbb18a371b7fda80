// Mid-channel body of the dense weight-gradient kernel (fused_conv_dw.cu)
// for bf16 input whose C is a multiple of 64 and CO = 64 (a multiple of 64
// below the deep-channel body's CO >= 128): UNETR's 24^3 x 64 and 24^3 x
// 128 -> 64 gradients and the 12^3 x 64 gradients of SegResNet, UNETR and the
// flagship UNet.
//
// It replaces, with the other bodies, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_dw_kernel (conv3d_packed_dw) at these
// shapes.
//
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]      (f32)
//
// is a GEMM per tap with M = 64 input channels, N = 64 output channels and K
// = the positions. At 24^3 x 64 it is bound by operations (24.5 GFLOP against
// 28 MB at batch 8), yet conv3_dw_mma.cuh ran it at 3.8x its bound and
// conv3_dw_wgmma.cuh, whose A fragments come by ldmatrix and wait on their
// own wgmma tap by tap, at 3.5x: both behind cuDNN. Here no operand passes
// through registers:
//
// - One block: NWG consumer warpgroups and a producer warpgroup whose one
//   thread issues the copies. It owns a tap group of NWG x TPW taps (each
//   warpgroup TPW of them; past tap 26 a warpgroup idles), a chunk of 64
//   input channels and a tile of 64 output channels, and walks the bricks
//   split, split + splits, ... of TD x TH x TW positions, TW = 8 or 16.
// - Per brick the producer brings, into a ring of `stages`, the brick's
//   halo of x (64 channels of (TD+2)(TH+2)(TW+2) positions) and its brick of
//   dy (64 channels), each one TMA load of a 5-D box, 128-byte swizzled: one
//   position a 128-byte row, zero outside the volume (the encoder and the
//   loads of conv3_wgmma.cuh).
// - A k16 step is 16 positions of one row of the brick (TW = 16) or 8 of
//   each of two (TW = 8). Operand A (64 ci x 16 positions) is the x halo at
//   the tap's offset read MN-major by descriptor: its rows are the
//   positions' 128-byte rows, the two 8-row groups 1024 bytes (one row) or a
//   halo row apart, and a tap moves the start by whole rows (the swizzle is
//   a function of the address, so any row may start). Operand B (16
//   positions x 64 co) is the dy brick, MN-major by descriptor as
//   conv3_dw_wgmma.cuh reads it.
// - wgmma.mma_async m64n64k16 with both operands in shared memory: a
//   warpgroup issues every (k16 step, tap) of a brick back to back into its
//   TPW accumulators, commits once, and the slot is released when the group
//   has retired. The brick's KS = 8, 12 or 16 k16 steps are a template
//   parameter: with a run-time loop ptxas serialized the wgmma.
// - Deterministic without atomics: with several splits each block writes its
//   partial to a workspace [split][27][C][CO] and dw_reduce_kernel (or
//   dw_reduce_lanes_kernel) sums the splits in a fixed order; a repeated
//   launch is bit-equal.
// Brick, taps a warpgroup, warpgroups, ring depth and splits are the
// wrapper's plan (ops/fused_conv.py::mid_dw_plan); the launcher refuses a plan
// whose shared-memory sum differs from its own (mid_dw_smem_bytes).
#pragma once

#include "conv3_dw_mma.cuh"
#include "conv3_mid.cuh"

namespace segk {

// D (m64 x n64, f32) += A (m64 x k16) * B (k16 x n64), both by descriptor and
// both MN-major (the transpose bits set): A's m and B's n run along the
// 128-byte rows, k across them.
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// One ring slot: the x halo and the dy brick, each rounded to the 128-byte
// swizzle's period of 1024 bytes.
__host__ __device__ constexpr int mid_dw_slot_bytes(int td, int th, int tw) {
  return wgmma_halo_bytes(td, th, tw) + round1024(td * th * tw * 128);
}

// 1024 bytes to align the base, 1024 of barriers, `stages` slots. The
// wrapper's plan computes the same sum: the launcher refuses a mismatch.
__host__ __device__ constexpr int mid_dw_smem_bytes(int td, int th, int tw, int stages) {
  return 2048 + stages * mid_dw_slot_bytes(td, th, tw);
}

struct MidDwArgs {
  float* part;  // [split][27][C][CO]; the result itself with one split
  int D, H, W, C, CO;
  int td, th, tw;
  int nbz, nby, nbx, nbricks;
  int n_tg, n_ci;  // tap groups, chunks of 64 input channels
  int stages;
};

template <int TPW, int NWG, int KS>
__global__ void __launch_bounds__(wgmma_threads(NWG), 1)
    conv3_mid_dw_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmdy, const MidDwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HP = a.th + 2, WP = a.tw + 2;
  const int halo_rows = (a.td + 2) * HP * WP;
  const int P = a.td * a.th * a.tw;
  const int x_bytes = wgmma_halo_bytes(a.td, a.th, a.tw);
  const int slot_bytes = mid_dw_slot_bytes(a.td, a.th, a.tw);
  const int S = a.stages;

  const uint32_t bars = smem_addr(smem);
  auto bar = [&](int i) { return bars + 8 * i; };  // full [0, S), empty [S, 2S)
  const uint32_t ring0 = bars + 1024;

  const int split = blockIdx.x;
  int tile = blockIdx.y;
  const int tg = tile % a.n_tg;
  tile /= a.n_tg;
  const int c0 = (tile % a.n_ci) * 64, co0 = (tile / a.n_ci) * 64;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar(i), 1);
      mbar_init(bar(S + i), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: one thread issues the copies
    if (warp == 4 * NWG && lane == 0) {
      int s = 0, ph = 0;
      for (int brick = split; brick < a.nbricks; brick += gridDim.x) {
        int r = brick;
        const int x0 = (r % a.nbx) * a.tw;
        r /= a.nbx;
        const int y0 = (r % a.nby) * a.th;
        r /= a.nby;
        const int z0 = (r % a.nbz) * a.td, b = r / a.nbz;
        mbar_wait(bar(S + s), ph ^ 1);
        mbar_expect_tx(bar(s), (halo_rows + P) * 128);
        const uint32_t slot = ring0 + s * slot_bytes;
        tma_load_5d(slot, &tmx, bar(s), c0, x0 - 1, y0 - 1, z0 - 1, b);
        tma_load_5d(slot + x_bytes, &tmdy, bar(s), co0, x0, y0, z0, b);
        if (++s == S) s = 0, ph ^= 1;
      }
    }
  } else {  // the consumers: warpgroup wg takes taps tap0 .. tap0 + TPW - 1 (none past 26)
    const int wg = warp >> 2, w = warp & 3;
    const int tap0 = (tg * NWG + wg) * TPW;
    int toff[TPW];  // a tap past 26 repeats tap 26: its products are never stored
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = tap0 + i < 27 ? tap0 + i : 26;
      toff[i] = ((t / 9) * HP + (t / 3) % 3) * WP + t % 3;
    }
    float acc[TPW][32];
#pragma unroll
    for (int i = 0; i < TPW; ++i)
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[i][k] = 0.f;

    // a k16 step: 16 positions of one brick row (tw = 16, the 8-row groups
    // 1024 B apart) or 8 of each of two (tw = 8, a halo row apart)
    const int pair = a.tw == 8, runs = a.tw / 16;
    const uint32_t a_sbo = pair ? WP * 8 : 64;
    int s = 0, ph = 0;
    for (int brick = split; brick < a.nbricks; brick += gridDim.x) {
      mbar_wait(bar(s), ph);
      const uint32_t xs = ring0 + s * slot_bytes, dys = xs + x_bytes;
#pragma unroll
      for (int i = 0; i < TPW; ++i) fence_acc(acc[i]);
      wgmma_fence();
      // straight-line wgmma from the fence to the commit (a loop or a branch
      // between them makes ptxas serialize the wgmma)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // k16 step ks: brick row zy (and zy + 1), x from xq
        const int zy = pair ? 2 * ks : ks / runs, xq = pair ? 0 : (ks - zy * runs) * 16;
        const int hrow = ((zy / a.th) * HP + zy % a.th) * WP + xq;  // the halo row at tap 0
        const uint64_t db = desc_b128(dys + ks * 2048, 1, 64);   // 8-row groups 1024 B apart
#pragma unroll
        for (int i = 0; i < TPW; ++i)
          wgmma_ss_n64_mn(acc[i], desc_b128(xs + (hrow + toff[i]) * 128, 1, a_sbo), db);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < TPW; ++i) fence_acc(acc[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(S + s));
      if (++s == S) s = 0, ph ^= 1;
    }

    // accumulator (row 16 w + g + 8 half: input channel, columns 8 n + 2 t4, + 1)
    float* part = a.part + (int64_t)split * 27 * a.C * a.CO;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int tap = tap0 + i;
      if (tap >= 27) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = c0 + 16 * w + g + 8 * half;
        if (ci >= a.C) continue;
        float* row = part + ((int64_t)tap * a.C + ci) * a.CO;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int co = co0 + 8 * n + 2 * t4;
          if (co >= a.CO) break;  // CO % 8 == 0: the pair is whole
          *reinterpret_cast<float2*>(row + co) =
              make_float2(acc[i][4 * n + 2 * half], acc[i][4 * n + 2 * half + 1]);
        }
      }
    }
  }
}

template <int TPW, int NWG, int KS>
cudaError_t launch_mid_dw_inst(const CUtensorMap& tmx, const CUtensorMap& tmdy,
                               const MidDwArgs& a, dim3 grid, int smem_bytes,
                               cudaStream_t stream) {
  auto kernel = conv3_mid_dw_kernel<TPW, NWG, KS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wgmma_threads(NWG), smem_bytes, stream>>>(tmx, tmdy, a);
  return cudaGetLastError();
}

// x (B, D, H, W, C) and dy (B, D, H, W, CO) bf16; ws holds splits * 27 * C *
// CO floats (unused with one split); out (3, 3, 3, C, CO) f32. (td, th, tw,
// tpw, nwg, splits, stages, smem_bytes) is the wrapper's plan
// (ops/fused_conv.py::mid_dw_plan).
inline int launch_conv3_mid_dw(const void* x, const void* dy, float* ws, float* out, int B,
                               int D, int H, int W, int C, int CO, int td, int th, int tw,
                               int tpw, int nwg, int splits, int stages, int smem_bytes,
                               void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (C < 64 || C % 64 || CO < 64 || CO % 64 || td < 1 || th < 1 || (tw != 8 && tw != 16) ||
      (tw == 8 && th % 2) ||
      td + 2 > 256 || th + 2 > 256 || tw + 2 > 256 || stages < 2 || stages > 4 || splits < 1)
    return invalid;
  MidDwArgs a;
  a.part = splits == 1 ? out : ws;
  a.D = D, a.H = H, a.W = W, a.C = C, a.CO = CO;
  a.td = td, a.th = th, a.tw = tw;
  a.nbz = (D + td - 1) / td, a.nby = (H + th - 1) / th, a.nbx = (W + tw - 1) / tw;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  if (nbricks > 0x7fffffffLL || splits > nbricks || tpw < 1 || nwg < 2 || nwg > 3) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.n_tg = (27 + nwg * tpw - 1) / (nwg * tpw);
  a.n_ci = C / 64;
  a.stages = stages;
  const long long tiles = (long long)a.n_tg * a.n_ci * (CO / 64);
  if (tiles > 65535 || splits > 65535 || smem_bytes != mid_dw_smem_bytes(td, th, tw, stages) ||
      smem_bytes > 232448)
    return invalid;
  CUtensorMap tmx, tmdy;
  if (!encode_ndhwc(&tmx, x, B, D, H, W, C, td + 2, th + 2, tw + 2) ||
      !encode_ndhwc(&tmdy, dy, B, D, H, W, CO, td, th, tw))
    return invalid;
  const dim3 grid(splits, (unsigned)tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const int ks = td * th * tw / 16;  // k16 steps a brick
#define SEGK_MID_DW_CASE(TPW_, NWG_, KS_)                                                  \
  if (tpw == TPW_ && nwg == NWG_ && ks == KS_)                                             \
    err = launch_mid_dw_inst<TPW_, NWG_, KS_>(tmx, tmdy, a, grid, smem_bytes, s);
#define SEGK_MID_DW_SHAPE(TPW_, NWG_) \
  SEGK_MID_DW_CASE(TPW_, NWG_, 8) SEGK_MID_DW_CASE(TPW_, NWG_, 12) SEGK_MID_DW_CASE(TPW_, NWG_, 16)
  SEGK_MID_DW_SHAPE(2, 2)
  SEGK_MID_DW_SHAPE(3, 2)
  SEGK_MID_DW_SHAPE(2, 3)
  SEGK_MID_DW_SHAPE(3, 3)
#undef SEGK_MID_DW_SHAPE
#undef SEGK_MID_DW_CASE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = 27LL * C * CO;
  if (splits < 16) {  // few partials: one thread per element walks them
    dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ws, out, n, splits);
  } else {
    dw_reduce_lanes_kernel<<<(unsigned)((n + 31) / 32), 256, 0, s>>>(ws, out, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk
