// Deep-channel body of the dense weight-gradient kernel (fused_conv_dw.cu)
// for bf16 input with C >= 64 and CO >= 128 (the rule of
// ops/fused_conv.py::dw_body): the flagship UNet's 6^3 stages and UNETR's
// 12^3 convs.
//
// It replaces, with conv3_dw_mma.cuh, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_dw_kernel (conv3d_packed_dw) at these
// shapes.
//
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]      (f32)
//
// is a GEMM with M = 27 * C rows (tap, ci), N = CO and K = the output
// positions. At 64-256 channels it is bound by operations (12^3 x 256 -> 128
// at batch 8: 24.5 GFLOP), and conv3_dw_mma.cuh fed each 512-byte ldmatrix
// to one to four mma.sync. Here, with the helpers of conv3_wgmma.cuh:
//
// - One block: NWG = 2 or 3 consumer warpgroups and a producer warpgroup
//   (one thread of it issues the copies). It owns a tap group of NWG x TPW
//   taps (each warpgroup TPW of them; past tap 26 a warpgroup idles), a chunk
//   of 64 input channels (each warpgroup's m64) and an N tile of NT = 64 or
//   128 output channels (NT x TPW <= 128: accumulators and A fragments fit
//   the launch bound's registers without spills), and walks the bricks
//   split, split + splits, ... of TD x TH x TW positions (K rows, flattened
//   z, y, x, at most 128). Every tap of the block shares each staged brick:
//   a third warpgroup (9 tap groups instead of 14) cuts the bricks' bytes
//   from the L2 by a third, which bound the two-warpgroup body.
// - Per brick the producer brings, into a ring of `stages`, the brick's halo
//   of x (64 channels of (TD+2)(TH+2)(TW+2) positions) and the brick of dy
//   (NT / 64 boxes of 64 channels), each one TMA load of a 5-D box of the
//   NDHWC tensor, 128-byte swizzled; outside the volume both are the TMA's
//   zeros, and the rows of dy past the brick up to a whole k16 step stay
//   zero from the start. Full and empty mbarriers count the ring.
// - Operand A (64 ci x 16 positions) comes from registers by ldmatrix.trans
//   from the x halo at the tap's offset: the 27 tap windows stay address
//   arithmetic on one staged halo, which every tap of the block shares.
// - Operand B (16 positions x NT co) is the dy brick as staged, read
//   MN-major through the descriptor's transpose bit: position rows of 128
//   bytes, 8-row groups 1024 bytes apart, 64-channel blocks a whole brick
//   apart.
// - wgmma.mma_async m64nNTk16 into the tap's accumulators, one commit group
//   per (brick, tap), waited before the next tap's A fragments load; a
//   brick's slot is released once its last group has retired. (Loading the
//   next group's fragments under a running group, as conv3_wgmma.cuh does,
//   released each slot a group later and measured slower here: the ring,
//   not the issue, paces this body.)
// - Deterministic without atomics: with several splits each block writes its
//   partial to a workspace [split][27][C][CO] and conv3_dw_mma.cuh's second
//   kernel sums the splits in a fixed order.
// Brick, N tile, taps a warpgroup, ring depth and splits are the wrapper's
// plan (ops/fused_conv.py::deep_dw_plan); the launcher refuses a plan whose
// shared-memory sum differs from its own (dw_wgmma_smem_bytes).
#pragma once

#include "conv3_dw_mma.cuh"
#include "conv3_wgmma.cuh"

namespace segk {

constexpr int DW_WG_MAX_ROWS = 128;  // K rows of a brick: at most eight k16 steps

__host__ __device__ constexpr int dw_wgmma_rows16(int td, int th, int tw) {
  return (td * th * tw + 15) / 16 * 16;
}

// One ring slot: the x halo (rounded to 1024 bytes), then NT / 64 blocks of
// rows16 dy rows of 128 bytes.
__host__ __device__ constexpr int dw_wgmma_slot_bytes(int nt, int td, int th, int tw) {
  return wgmma_halo_bytes(td, th, tw) + nt / 64 * dw_wgmma_rows16(td, th, tw) * 128;
}

// 1024 bytes to align the base, 1024 of barriers and the K rows' halo table,
// `stages` slots. The wrapper's plan computes the same sum: the launcher
// refuses a mismatch.
inline int dw_wgmma_smem_bytes(int nt, int td, int th, int tw, int stages) {
  return 2048 + stages * dw_wgmma_slot_bytes(nt, td, th, tw);
}

struct WgDwArgs {
  float* part;  // [split][27][C][CO]; the result itself with one split
  int D, H, W, C, CO;
  int td, th, tw;
  int nbz, nby, nbx, nbricks;
  int n_tg, n_ci;  // tap groups, chunks of 64 input channels
  int stages;
};

template <int NT, int TPW, int NWG>
__global__ void __launch_bounds__(wgmma_threads(NWG), 1)
    conv3_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                          const __grid_constant__ CUtensorMap tmdy, const WgDwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HP = a.th + 2, WP = a.tw + 2;
  const int halo_rows = (a.td + 2) * HP * WP;
  const int rows = a.td * a.th * a.tw;
  const int rows16 = dw_wgmma_rows16(a.td, a.th, a.tw);
  const int x_bytes = wgmma_halo_bytes(a.td, a.th, a.tw);
  const int dy_bytes = rows16 * 128;  // one 64-channel block of the dy brick
  const int slot_bytes = x_bytes + NT / 64 * dy_bytes;

  // barriers: full [0, S), empty [S, 2S); then the K rows' halo rows at tap (0, 0, 0)
  const uint32_t bars = smem_addr(smem);
  auto bar = [&](int i) { return bars + 8 * i; };
  int* qtab = reinterpret_cast<int*>(smem + 256);
  const uint32_t ring0 = bars + 1024;

  const int split = blockIdx.x;
  int tile = blockIdx.y;
  const int tg = tile % a.n_tg;
  tile /= a.n_tg;
  const int c0 = (tile % a.n_ci) * 64, co0 = (tile / a.n_ci) * NT;

  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(bar(i), 1);
      mbar_init(bar(a.stages + i), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int q = tid; q < rows16; q += blockDim.x) {
    const int qz = q / (a.th * a.tw), qr = q - qz * a.th * a.tw;
    qtab[q] = q < rows ? (qz * HP + qr / a.tw) * WP + qr % a.tw : 0;  // padding: dy rows are zero
  }
  if (rows16 > rows) {  // the dy rows past the brick: zero once, the TMA never writes them
    const int pad = (rows16 - rows) * 128 / 16;
    for (int i = tid; i < a.stages * (NT / 64) * pad; i += blockDim.x) {
      const int blk = i / pad, k = i - blk * pad;
      unsigned char* p = smem + 1024 + (blk / (NT / 64)) * slot_bytes + x_bytes +
                         (blk % (NT / 64)) * dy_bytes + rows * 128 + k * 16;
      *reinterpret_cast<int4*>(p) = make_int4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by wgmma
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: one thread issues the copies
    producer_registers();
    if (warp == 4 * NWG && lane == 0) {
      int s = 0, ph = 0;
      for (int brick = split; brick < a.nbricks; brick += gridDim.x) {
        int r = brick;
        const int bx = r % a.nbx;
        r /= a.nbx;
        const int by = r % a.nby;
        r /= a.nby;
        const int bz = r % a.nbz, b = r / a.nbz;
        const int z0 = bz * a.td, y0 = by * a.th, x0 = bx * a.tw;
        mbar_wait(bar(a.stages + s), ph ^ 1);
        mbar_expect_tx(bar(s), (halo_rows + NT / 64 * rows) * 128);
        const uint32_t slot = ring0 + s * slot_bytes;
        tma_load_5d(slot, &tmx, bar(s), c0, x0 - 1, y0 - 1, z0 - 1, b);
#pragma unroll
        for (int j = 0; j < NT / 64; ++j)
          tma_load_5d(slot + x_bytes + j * dy_bytes, &tmdy, bar(s), co0 + 64 * j, x0, y0, z0, b);
        if (++s == a.stages) s = 0, ph ^= 1;
      }
    }
  } else {  // the consumers, to the end: the roles never reconverge (setmaxnreg)
    consumer_registers<NWG>();
    // a consumer warpgroup: taps tap0 .. tap0 + TPW - 1 (none past 26), ci c0 + 16 w + (0..15)
    const int wg = warp >> 2, w = warp & 3;
    const int tap0 = (tg * NWG + wg) * TPW;
    const int krow = (lane & 7) + ((lane >> 4) << 3);  // ldmatrix.trans: this lane's K row
    const int cpiece = 2 * w + ((lane >> 3) & 1);      // and its 16-byte piece of channels
    const int ksteps = rows16 >> 4;
    float acc[TPW][NT / 2];
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[j][i] = 0.f;

    // per brick: each of the warpgroup's taps one commit group, waited before
    // the next tap's A fragments overwrite its registers; the slot is released
    // once the last group has retired
    int s = 0, ph = 0;
    for (int brick = split; brick < a.nbricks; brick += gridDim.x) {
      mbar_wait(bar(s), ph);
      const uint32_t xs = ring0 + s * slot_bytes;
      const uint32_t dys = xs + x_bytes;
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int tap = tap0 + j;
        if (tap >= 27) break;  // uniform across the warpgroup
        const int toff = ((tap / 9) * HP + (tap / 3) % 3) * WP + tap % 3;
        uint32_t af[DW_WG_MAX_ROWS / 16][4];
#pragma unroll
        for (int ks = 0; ks < DW_WG_MAX_ROWS / 16; ++ks) {
          if (ks < ksteps) {
            const int p = qtab[ks * 16 + krow] + toff;
            ldsm_x4_trans(xs + p * 128 + ((cpiece ^ (p & 7)) << 4), af[ks][0], af[ks][1],
                          af[ks][2], af[ks][3]);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DW_WG_MAX_ROWS / 16; ++ks) {
          if (ks < ksteps)  // MN-major: 8-row groups 1024 B apart, 64-channel blocks dy_bytes
            wgmma_rs_nt<NT, 1>(acc[j], af[ks], desc_b128(dys + ks * 2048, dy_bytes >> 4, 64));
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(a.stages + s));
      if (++s == a.stages) s = 0, ph ^= 1;
    }

    // accumulator (row g + 8 * half, columns 8 i + 2 t, + 1) of each n8 piece
    float* part = a.part + (int64_t)split * 27 * a.C * a.CO;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int tap = tap0 + j;
      if (tap >= 27) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = c0 + 16 * w + g + 8 * half;
        if (ci >= a.C) continue;
        float* row = part + ((int64_t)tap * a.C + ci) * a.CO;
#pragma unroll
        for (int i = 0; i < NT / 8; ++i) {
          const int co = co0 + 8 * i + 2 * t;
          if (co >= a.CO) break;  // CO % 8 == 0: the pair is whole
          *reinterpret_cast<float2*>(row + co) =
              make_float2(acc[j][4 * i + 2 * half], acc[j][4 * i + 2 * half + 1]);
        }
      }
    }
  }
}

template <int NT, int TPW, int NWG>
cudaError_t launch_dw_wgmma_inst(const CUtensorMap& tmx, const CUtensorMap& tmdy,
                                 const WgDwArgs& a, dim3 grid, int smem_bytes,
                                 cudaStream_t stream) {
  auto kernel = conv3_dw_wgmma_kernel<NT, TPW, NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wgmma_threads(NWG), smem_bytes, stream>>>(tmx, tmdy, a);
  return cudaGetLastError();
}

// x (B, D, H, W, C) and dy (B, D, H, W, CO) bf16; ws holds splits * 27 * C *
// CO floats (unused with one split); out (3, 3, 3, C, CO) f32. (td, th, tw,
// nt, tpw, splits, stages, smem_bytes) is the wrapper's plan
// (ops/fused_conv.py::deep_dw_plan).
inline int launch_conv3_dw_wgmma(const void* x, const void* dy, float* ws, float* out, int B,
                                 int D, int H, int W, int C, int CO, int td, int th, int tw,
                                 int nt, int tpw, int nwg, int splits, int stages,
                                 int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (C < 8 || C % 8 || CO < 8 || CO % 8 || td < 1 || th < 1 || tw < 1 || td > 254 ||
      th > 254 || tw > 254 || td * th * tw > DW_WG_MAX_ROWS || stages < 2 || splits < 1)
    return invalid;
  WgDwArgs a;
  a.part = splits == 1 ? out : ws;
  a.D = D, a.H = H, a.W = W, a.C = C, a.CO = CO;
  a.td = td, a.th = th, a.tw = tw;
  a.nbz = (D + td - 1) / td, a.nby = (H + th - 1) / th, a.nbx = (W + tw - 1) / tw;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  if (nbricks > 0x7fffffffLL || splits > nbricks || tpw < 1) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  if (nwg < 2 || nwg > 3) return invalid;
  a.n_tg = (27 + nwg * tpw - 1) / (nwg * tpw);
  a.n_ci = (C + 63) / 64;
  a.stages = stages;
  const long long tiles = (long long)a.n_tg * a.n_ci * ((CO + nt - 1) / nt);
  if (tiles > 65535 || smem_bytes != dw_wgmma_smem_bytes(nt, td, th, tw, stages) ||
      smem_bytes > 232448)
    return invalid;
  CUtensorMap tmx, tmdy;
  if (!encode_ndhwc(&tmx, x, B, D, H, W, C, td + 2, th + 2, tw + 2) ||
      !encode_ndhwc(&tmdy, dy, B, D, H, W, CO, td, th, tw))
    return invalid;
  const dim3 grid(splits, (unsigned)tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SEGK_DW_WGMMA_CASE(NT_, TPW_, NWG_)                                               \
  if (nt == NT_ && tpw == TPW_ && nwg == NWG_)                                            \
    err = launch_dw_wgmma_inst<NT_, TPW_, NWG_>(tmx, tmdy, a, grid, smem_bytes, s);
  SEGK_DW_WGMMA_CASE(64, 1, 2)
  SEGK_DW_WGMMA_CASE(64, 2, 2)
  SEGK_DW_WGMMA_CASE(128, 1, 2)
  SEGK_DW_WGMMA_CASE(64, 1, 3)
  SEGK_DW_WGMMA_CASE(128, 1, 3)
#undef SEGK_DW_WGMMA_CASE
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
