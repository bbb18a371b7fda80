// Few-channel body of the two weight-gradient kernels of the stride-1 SAME
// 3x3x3 convolution, for bf16 input with C = 1..7 input channels and any CO
// (fused_conv_dw.cu: dense NDHWC; phase_conv_dw.cu: phase-major tensors
// standing for a 2x-upsampled volume). The tensor-core body of
// conv3_dw_mma.cuh takes C % 8 == 0 only: it stages 16-byte channel vectors.
//
// It replaces the same Pallas kernels as the other bodies:
// segmantic_tpu/ops/pallas_conv.py::_dw_kernel (conv3d_packed_dw) in the dense
// layout; segmantic_tpu/ops/phase_gemm.py::_dw_kernel_folded and ::_dw_kernel
// (phase_conv_gemm_dw_folded_p, phase_conv_gemm_dw_p) with _unfold_dw in the
// phase layout. On the path: the weight gradient of SegResNet's and UNETR's
// 3^3 input layer, one image channel to 8 or 16, at 8 x 96^3.
//
//   dw[t * C + c, co] = sum_{b, p} x[b, p + t - 1, c] * dy[b, p, co]     (f32)
//
// is a GEMM with M = 27 * C (tap, channel) rows, padded to a multiple of 32,
// N = CO in tiles of NT = 8 or 16 (grid.y) and K = every output position.
//
// What bounds it on the card: bytes, nearly all of them dy's (226 MB at 8 x
// 96^3 x 1 -> 16, x 14 MB) for only 27 * C * CO outputs. What the design does
// about it:
//
// - The A operand is x: staged by planes along W exactly as in the few-channel
//   conv (conv3_fewc.cuh; 16-byte pieces of a dense row or of a row of block
//   voxels, a rolling window of three planes in a ring of six with two mirror
//   slots) and built from shared memory tap by tap: a lane holds two rows
//   (tap, channel) of every m16 tile and four positions of every k16 step,
//   whose offsets it computes once. B is dy, one plane tile a step, staged
//   CO-contiguous by 16-byte cp.async (value by value where CO % 8 != 0) into
//   a ring of four and fed to mma.sync by ldmatrix.trans; rows of 32 bytes
//   (NT = 16) swap their two 16-byte halves every fourth row, so the eight rows
//   one ldmatrix phase reads fall on distinct banks without padding (the ring
//   of 512-position planes fits twice on a multiprocessor). x and dy leave device
//   memory once each: there is no dz grid axis; a plane step's 256 or 512
//   positions are 16 or 32 k16 steps, two or four a warp.
// - One persistent grid of about two blocks a multiprocessor (one where C > 2,
//   whose accumulators need the registers) walks the items (sample, tile
//   column, segment of planes): the positions are split over the blocks. Each
//   warp sums its own positions for all M rows; at the end the eight warps'
//   sums are added in warp order in shared memory and the block writes one
//   partial to the workspace [split][27 * C][CO]. dw_reduce_kernel sums the
//   splits in a fixed order, so a repeated launch is bit-equal; with one
//   split the block writes the result itself.
// - The launch geometry is ops/fused_conv.py::fewc_dw_plan; the launcher
//   refuses a plan whose shared-memory sum differs from its own.
#pragma once

#include "conv3_dw_mma.cuh"
#include "conv3_fewc.cuh"

namespace segk {

// Blocks a multiprocessor the weight-gradient body is compiled for.
__host__ __device__ constexpr int fewc_dw_blocks(int c) { return c <= 2 ? 2 : 1; }

// Stage the NT-channel tile from co0 of cotangent plane p (sample b, tile
// column (ty, tx)) into slot, rows in the plane step's order, zero outside
// the volume and beyond CO.
// Bytes of one staged dy row, and the 16-byte unit where piece pc of row r lies.
template <int NT>
__host__ __device__ constexpr int fewc_dy_pitch() { return NT * 2; }
template <int NT>
__device__ __forceinline__ int fewc_dy_unit(int r, int pc) {
  return NT == 16 ? pc ^ (r >> 2 & 1) : pc;
}

template <typename Layout, int NT>
__device__ void fewc_stage_dy(const FewcArgs& a, unsigned char* slot, const int* rowtab,
                              const int* rowout, int b, int p, int ty, int tx, int co0) {
  constexpr bool PHASE = std::is_same<Layout, PhaseLayout>::value;
  constexpr int PB = fewc_dy_pitch<NT>();
  constexpr int PIECES = NT / 8;
  const __nv_bfloat16* gs = a.dy + (int64_t)b * a.D * a.H * a.W * a.CO;
  const int zb = PHASE ? 2 * p : p, yb = ty * a.th, xb = tx * a.tw;
  if (a.vec_dy) {
    // the plane's origin; a tile inside the volume skips the rows' checks
    const __nv_bfloat16* origin = gs + Layout::inner(zb, yb, xb, co0, a.H, a.W, a.CO);
    const bool interior = yb + a.th <= a.H && xb + a.tw <= a.W;
    for (int i = threadIdx.x; i < a.rows * PIECES; i += blockDim.x) {
      const int r = i / PIECES, pc = i - r * PIECES;
      bool ok = co0 + 8 * pc < a.CO;
      if (!interior) {
        const int at = rowtab[r];
        ok = ok && yb + (at >> 10 & 1023) < a.H && xb + (at >> 20) < a.W;
      }
      const __nv_bfloat16* src = ok ? origin + rowout[r] + 8 * pc : a.dy;
      cp_async16(smem_addr(slot + r * PB + 16 * fewc_dy_unit<NT>(r, pc)), src, ok ? 16 : 0);
    }
    return;
  }
  const uint16_t* gv = reinterpret_cast<const uint16_t*>(gs);
  for (int i = threadIdx.x; i < a.rows * NT; i += blockDim.x) {
    const int r = i / NT, n = i - r * NT;
    const int at = rowtab[r];
    const int z = zb + (at & 1023), y = yb + (at >> 10 & 1023), x = xb + (at >> 20);
    const int co = co0 + n;
    const bool ok = z < a.D && y < a.H && x < a.W && co < a.CO;
    *reinterpret_cast<uint16_t*>(slot + r * PB + 16 * fewc_dy_unit<NT>(r, n >> 3) + 2 * (n & 7)) =
        ok ? gv[Layout::inner(z, y, x, co, a.H, a.W, a.CO)] : uint16_t(0);
  }
}

template <typename Layout, int C, int NT>
__global__ void __launch_bounds__(FEWC_THREADS, fewc_dw_blocks(C))
conv3_fewc_dw_kernel(const FewcArgs a) {
  constexpr bool PHASE = std::is_same<Layout, PhaseLayout>::value;
  constexpr int MROWS = fewc_mrows(C);
  constexpr int MT = MROWS / 16;
  constexpr int PB = fewc_dy_pitch<NT>();
  constexpr int NF = NT / 8;

  extern __shared__ __align__(128) unsigned char smem[];
  int* rowin = reinterpret_cast<int*>(smem);
  int* rowtab = rowin + FEWC_MAX_ROWS;
  int* rowout = rowtab + FEWC_MAX_ROWS;
  unsigned char* xs = smem + fewc_table_bytes();
  const int plane_bytes = a.sp * 2;
  unsigned char* dys = xs + (FEWC_SLOTS + 2) * plane_bytes;
  const int DY_SLOT = a.rows * PB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int co0 = blockIdx.y * NT;

  fewc_tables<Layout, C>(a, rowin, rowtab, rowout);

  // A offsets of this lane: row (m16 tile mt, half h) = tap * C + c, column q =
  // the step's position 2 tq + (q & 1) + 8 (q >> 1), from the step's rowin[0].
  // Dense: the 16 positions run along W (C values apart); phase: two block
  // voxels (8 C values apart) x 8 phases, the column's phase 2 tq + (q & 1).
  int aoff[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = mt * 16 + g + 8 * h;
        const int k = 2 * tq + (q & 1) + 8 * (q >> 1);
        aoff[mt][h][q] = PHASE ? (q >> 1) * 8 * C + fewc_koff<PHASE, C>(m, k & 7, a.rp, a.sp)
                               : k * C + fewc_koff<PHASE, C>(m, 0, a.rp, a.sp);
      }
  const int boff = (lane & 15) * PB + 16 * fewc_dy_unit<NT>(lane & 15, lane >> 4);

  FewcLoader ld;
  ld.init(a);
  auto issue = [&]() {
    if (ld.id < a.nitems) {
      const int slot = ld.q % FEWC_SLOTS;
      fewc_stage_x<Layout, C>(a, xs + slot * plane_bytes,
                              slot < 2 ? xs + (FEWC_SLOTS + slot) * plane_bytes : nullptr,
                              ld.it.b, ld.it.p0 - 1 + ld.e, ld.it.ty, ld.it.tx);
      if (ld.e >= 2)
        fewc_stage_dy<Layout, NT>(a, dys + (ld.q % FEWC_DY_SLOTS) * DY_SLOT, rowtab, rowout,
                                  ld.it.b, ld.it.p0 + ld.e - 2, ld.it.ty, ld.it.tx, co0);
      ld.advance(a);
    }
    cp_async_commit();
    ++ld.q;
  };
  __syncthreads();  // the tables, before the first staging of dy reads them
  while (ld.q < FEWC_SLOTS) issue();

  float acc[MT][NF][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;

  int s = 0;  // stream index of the window's first plane
  for (int id = blockIdx.x; id < a.nitems; id += gridDim.x) {
    const int n_planes = fewc_item(a, id).n;
    for (int j = 0; j < n_planes; ++j, ++s) {
      cp_async_wait_upto(ld.q - s - 3);  // the window and its dy plane have landed
      __syncthreads();                   // for everyone; the slots of entry s are free
      while (ld.q <= s + FEWC_SLOTS - 1) issue();

      const uint16_t* win =
          reinterpret_cast<const uint16_t*>(xs + (s % FEWC_SLOTS) * plane_bytes);
      const uint32_t sb = smem_addr(dys + ((s + 2) % FEWC_DY_SLOTS) * DY_SLOT) + boff;
#pragma unroll 2
      for (int t = warp; t < a.rows / 16; t += 8) {  // this warp's k16 steps of the plane
        const uint16_t* r0 = win + rowin[t * 16];
        uint32_t bf[NF][2];
        if constexpr (NT == 8) {
          ldsm_x2_trans(sb + t * 16 * PB, bf[0][0], bf[0][1]);
        } else {
          ldsm_x4_trans(sb + t * 16 * PB, bf[0][0], bf[0][1], bf[1][0], bf[1][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t af[4];
          af[0] = r0[aoff[mt][0][0]] | uint32_t(r0[aoff[mt][0][1]]) << 16;
          af[1] = r0[aoff[mt][1][0]] | uint32_t(r0[aoff[mt][1][1]]) << 16;
          af[2] = r0[aoff[mt][0][2]] | uint32_t(r0[aoff[mt][0][3]]) << 16;
          af[3] = r0[aoff[mt][1][2]] | uint32_t(r0[aoff[mt][1][3]]) << 16;
#pragma unroll
          for (int n = 0; n < NF; ++n) mma_bf16(acc[mt][n], af, bf[n]);
        }
      }
    }
    s += 2;  // the item's two halo planes
  }
  cp_async_wait<0>();
  __syncthreads();  // the dy ring is free: it holds the warps' sum

  // accumulator (row g + 8 * half, columns 2 * tq, 2 * tq + 1) of each m16n8 tile,
  // added warp after warp
  float* red = reinterpret_cast<float*>(dys);  // [MROWS][NT]
  for (int w = 0; w < 8; ++w) {
    if (warp == w) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float* e = red + (mt * 16 + g + 8 * (q >> 1)) * NT + n * 8 + 2 * tq + (q & 1);
            *e = w == 0 ? acc[mt][n][q] : *e + acc[mt][n][q];
          }
    }
    __syncthreads();
  }
  float* part = static_cast<float*>(a.out) + (int64_t)blockIdx.x * 27 * C * a.CO;
  for (int i = tid; i < 27 * C * NT; i += blockDim.x) {
    const int m = i / NT, n = i - m * NT;
    if (co0 + n < a.CO) part[m * a.CO + co0 + n] = red[m * NT + n];
  }
}

template <typename Layout, int C, int NT>
cudaError_t launch_fewc_dw_inst(const FewcArgs& a, int splits, int n_tiles, int smem_bytes,
                                cudaStream_t stream) {
  auto kernel = conv3_fewc_dw_kernel<Layout, C, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(splits, n_tiles), FEWC_THREADS, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// x (B, D, H, W, C) and dy (B, D, H, W, CO) bf16 in the Layout, D/H/W full
// resolution; ws holds splits * 27 * C * CO floats (unused with one split);
// out (3, 3, 3, C, CO) f32. (th, tw, seg, nt, splits, smem_bytes) is the
// wrapper's plan (ops/fused_conv.py::fewc_dw_plan); vec_x, vec_dy: the 16-byte
// staging applies to x, to dy.
template <typename Layout>
int launch_conv3_dw_fewc(const void* x, const void* dy, float* ws, float* out, int B, int D,
                         int H, int W, int C, int CO, int th, int tw, int seg, int nt,
                         int splits, int smem_bytes, int vec_x, int vec_dy, void* stream) {
  constexpr bool PHASE = std::is_same<Layout, PhaseLayout>::value;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  FewcArgs a;
  if (!fewc_geometry<Layout>(a, B, D, H, W, C, CO, th, tw, seg)) return invalid;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wp = nullptr;
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.scale = a.shift = a.alpha = nullptr;
  a.out = splits == 1 ? out : ws;
  a.relu_mode = 0;
  a.out_bf16 = 0;
  a.vec_x = vec_x;
  a.vec_dy = vec_dy && CO % 8 == 0;
  const int n_tiles = (CO + nt - 1) / nt;
  if (splits < 1 || splits > a.nitems || n_tiles > 65535 ||
      smem_bytes != fewc_dw_smem_bytes(PHASE, C, nt, th, tw))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SEGK_FEWC_DW_CASE(C_, NT_)                                                         \
  if (C == C_ && nt == NT_)                                                                \
    err = launch_fewc_dw_inst<Layout, C_, NT_>(a, splits, n_tiles, smem_bytes, s);
  SEGK_FEWC_DW_CASE(1, 8)
  SEGK_FEWC_DW_CASE(1, 16)
  SEGK_FEWC_DW_CASE(2, 8)
  SEGK_FEWC_DW_CASE(2, 16)
  SEGK_FEWC_DW_CASE(3, 8)
  SEGK_FEWC_DW_CASE(3, 16)
  SEGK_FEWC_DW_CASE(4, 8)
  SEGK_FEWC_DW_CASE(4, 16)
  SEGK_FEWC_DW_CASE(5, 8)
  SEGK_FEWC_DW_CASE(5, 16)
  SEGK_FEWC_DW_CASE(6, 8)
  SEGK_FEWC_DW_CASE(6, 16)
  SEGK_FEWC_DW_CASE(7, 8)
  SEGK_FEWC_DW_CASE(7, 16)
#undef SEGK_FEWC_DW_CASE
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
