// Few-channel body of the two stride-1 SAME 3x3x3 convolution kernels for
// bf16 input with C = 1..7 input channels and any CO (fused_conv.cu: dense
// NDHWC; phase_conv.cu: phase-major tensors standing for a 2x-upsampled
// volume). It computes what conv3_mma.cuh computes, y = act(conv(x) * scale +
// shift) with f32 accumulation, for the channel counts that body cannot take:
// a 16-byte cp.async carries no channel vector when C < 8. The f32 kernels
// take the f32 body of conv3_f32.cuh.
//
// It replaces the same Pallas kernels as the other bodies:
// segmantic_tpu/ops/pallas_conv.py::_kernel (conv3d_packed_p) in the dense
// layout, segmantic_tpu/ops/phase_gemm.py::_fwd_kernel_folded and
// ::_fwd_kernel (phase_conv_gemm_folded_p, phase_conv_gemm_p) in the phase
// layout. On the path it runs the 3^3 input layer of SegResNet and UNETR, one
// image channel to 8 or 16 (8 x 96^3 at training), and the input gradient of
// any conv to fewer than 8 channels.
//
// What bounds it on the card: bytes. At 8 x 96^3 x 1 -> 16 it reads 14 MB and
// writes 226 MB for 3.06 G multiply-adds; on CUDA cores the f32 FMA rate alone
// (0.091 ms) sits above the byte bound (0.072 ms), on the tensor cores it is
// far below. What the design does about it:
//
// - An implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 -> f32):
//   M = output positions, K = 27 * C (tap, channel) rows padded with zero
//   weight rows to a multiple of 16 (C = 1: 32, two k16 steps), N = CO in
//   tiles of NT = 8 or 16 (grid.y), masked at the store.
// - The input is staged by planes along W: 16-byte cp.async pieces of a row of
//   the NDHWC tensor (8 voxels at C = 1; zero fill at the border and beyond),
//   or of a row of block voxels of the phase-major tensor (the 8 phases of one
//   voxel at C = 1). No channel vector is padded to 8. Where a dense row of
//   W * C values is not 16-byte aligned the plane is staged value by value.
// - A block walks a column of plane tiles along D with a rolling window of
//   three staged planes in a ring of six (three ahead in flight): each input
//   plane leaves device memory once per column, and a plane's two neighbours
//   are the window's other slots. Two mirror slots repeat the ring's first
//   two, so the window is always three consecutive slots and every address of
//   a tap is the slot base plus a constant of the lane.
// - The A fragments are built from shared memory tap by tap: each lane holds
//   two rows (output positions) of every m16 tile and four K columns of every
//   k16 step, whose offsets in the window it computes once (in the phase
//   layout a lane's rows share one output phase, so the offsets depend on the
//   lane only). The packed weights, 27 * C x NT (1 KB at C = 1, CO = 16), are
//   resident in shared memory and, at C <= 2, their B fragments in registers.
// - The epilogue applies acc * scale + shift and none / relu / prelu in f32
//   and stores from the registers: the four lanes of a quad hold one row's
//   channels, at NT = 16 in bf16 one shuffle gives each lane four neighbouring
//   ones (8 bytes), and a warp's 8 rows of one store are 8 consecutive voxels
//   along W (dense) or the 8 phases of one block voxel (phase), one
//   contiguous run of the output either way. Staging the output through
//   shared memory cost more time than the stores (H100, measured).
// - A plane step is 256 or 512 output positions (the plan's choice: 512
//   halves the steps' barriers and waits where the extents fill it). One
//   persistent grid of three blocks a multiprocessor at C <= 2 (two above)
//   walks the items (sample, tile column, segment of planes);
//   ops/fused_conv.py::fewc_plan picks the tile, the step and the segment
//   length, and the launcher refuses a plan whose shared-memory sum differs
//   from its own.
#pragma once

#include <type_traits>

#include "conv3_mma.cuh"

namespace segk {

constexpr int FEWC_THREADS = 256;   // eight warps
constexpr int FEWC_MAX_ROWS = 512;  // output positions of one plane step: 256 or 512
constexpr int FEWC_SLOTS = 6;       // staged input planes: 3 in the window, 3 ahead
constexpr int FEWC_DY_SLOTS = 4;    // staged dy planes (weight gradient): 1 in use, 3 ahead

// K rows of the conv (27 * C padded to whole k16 steps); M rows of the weight
// gradient (27 * C padded to whole pairs of m16 tiles).
__host__ __device__ constexpr int fewc_krows(int c) { return (27 * c + 15) / 16 * 16; }
__host__ __device__ constexpr int fewc_mrows(int c) { return (27 * c + 31) / 32 * 32; }

// n rounded up to the next value that leaves rem modulo mod.
__host__ __device__ constexpr int fewc_round(int n, int mod, int rem) {
  return n + ((rem - n % mod) % mod + mod) % mod;
}

// Elements of one staged row: a dense row holds the tile's TW voxels, one
// before and one after inside two extra 16-byte pieces; a phase row holds
// TW/2 + 2 block voxels of 8 * C values. Pitched at 16 mod 32 elements, so the
// three rows of a tap group fall on different banks.
__host__ __device__ inline int fewc_row_pitch(bool phase, int c, int tw) {
  return fewc_round(phase ? (tw / 2 + 2) * 8 * c : tw * c + 16, 32, 16);
}

// Elements of one staged plane (one full-resolution plane dense, one plane of
// block voxels, two full-resolution planes, phase), pitched at 32 mod 64.
__host__ __device__ inline int fewc_plane_pitch(bool phase, int c, int th, int tw) {
  const int rows = phase ? th / 2 + 2 : th + 2;
  return fewc_round(rows * fewc_row_pitch(phase, c, tw), 64, 32);
}

__host__ __device__ constexpr int fewc_table_bytes() { return 3 * FEWC_MAX_ROWS * 4; }

// Blocks a multiprocessor the conv body is compiled for: its K offsets take
// the registers from C = 3 on.
__host__ __device__ constexpr int fewc_conv_blocks(int c) { return c <= 2 ? 3 : 2; }

// The wrapper's plan computes the same sums: the launchers refuse a mismatch.
inline int fewc_smem_bytes(bool phase, int c, int nt, int th, int tw) {
  return fewc_table_bytes() + fewc_krows(c) * mma_pitch(nt) +
         (FEWC_SLOTS + 2) * fewc_plane_pitch(phase, c, th, tw) * 2;
}
inline int fewc_dw_smem_bytes(bool phase, int c, int nt, int th, int tw) {
  const int rows = phase ? 2 * th * tw : th * tw;
  return fewc_table_bytes() + (FEWC_SLOTS + 2) * fewc_plane_pitch(phase, c, th, tw) * 2 +
         FEWC_DY_SLOTS * rows * nt * 2;  // dy rows unpadded (fewc_dy_pitch)
}

struct FewcArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wp;  // conv: packed weights [N tile][K row][NT]
  const __nv_bfloat16* dy;  // weight gradient: the output cotangent
  const float* scale;
  const float* shift;
  const float* alpha;
  void* out;  // conv: the output; weight gradient: [split][27 * C][CO] partials or the result
  int relu_mode, out_bf16;
  int D, H, W, C, CO;  // full-resolution extents
  int th, tw;          // plane tile in full-resolution positions
  int rows;            // output positions of a plane step: th * tw dense, 2 * th * tw phase
  int seg;             // planes an item walks
  int planes;          // D dense, D / 2 phase
  int nty, ntx, nseg, nitems;
  int rp, sp;          // staged row and plane pitch, elements
  int vec_x, vec_dy;   // the 16-byte staging applies
};

// One item: sample b, planes p0 .. p0 + n - 1 of tile column (ty, tx).
struct FewcItem {
  int b, p0, n, ty, tx;
};

__device__ __forceinline__ FewcItem fewc_item(const FewcArgs& a, int id) {
  FewcItem it;
  it.tx = id % a.ntx;
  id /= a.ntx;
  it.ty = id % a.nty;
  id /= a.nty;
  const int sg = id % a.nseg;
  it.b = id / a.nseg;
  it.p0 = sg * a.seg;
  it.n = min(a.seg, a.planes - it.p0);
  return it;
}

// Per row of a plane step: rowin, the element offset in a staged plane of its
// tap (0, 0, 0) input (dense), or of its block voxel (phase: the phase sits in
// the lane's K offsets); rowtab, its full-resolution offset (z, y, x) from the
// step's origin packed z | y << 10 | x << 20; rowout, the element offset of its
// CO-channel vector from the origin's (the layout's address is linear in an
// offset from an even origin). Dense rows run along W (ry, rx); phase rows are
// block voxel x 8 phases.
template <typename Layout, int C>
__device__ void fewc_tables(const FewcArgs& a, int* rowin, int* rowtab, int* rowout) {
  constexpr bool PHASE = std::is_same<Layout, PhaseLayout>::value;
  for (int r = threadIdx.x; r < a.rows; r += blockDim.x) {
    int rz = 0, ry, rx;
    if constexpr (PHASE) {
      const int vw = a.tw >> 1, v = r >> 3, ph = r & 7;
      const int vy = v / vw, vx = v - vy * vw;
      rowin[r] = vy * a.rp + vx * 8 * C;
      rz = ph >> 2, ry = 2 * vy + (ph >> 1 & 1), rx = 2 * vx + (ph & 1);
    } else {
      ry = r / a.tw, rx = r - ry * a.tw;
      rowin[r] = ry * a.rp + 8 - C + rx * C;
    }
    rowtab[r] = rz | ry << 10 | rx << 20;
    rowout[r] = Layout::inner(rz, ry, rx, 0, a.H, a.W, a.CO);
  }
}

// Element offset, from a row's rowin in the window's first plane, of K column
// k = tap * C + c for an output of phase ph (phase layout; ignored dense). The
// padding columns point at the centre tap: finite, and times a zero weight.
template <bool PHASE, int C>
__device__ __forceinline__ int fewc_koff(int k, int ph, int rp, int sp) {
  if (k >= 27 * C) k = 13 * C;
  const int t = k / C, c = k - t * C;
  const int dz = t / 9, dy = t / 3 % 3, dx = t % 3;
  if constexpr (!PHASE) {
    return dz * sp + dy * rp + dx * C + c;
  } else {
    // full-resolution offsets from the output voxel's block corner, -1 .. 2
    const int uz = (ph >> 2) + dz - 1, uy = (ph >> 1 & 1) + dy - 1, ux = (ph & 1) + dx - 1;
    return ((uz >> 1) + 1) * sp + ((uy >> 1) + 1) * rp + ((ux >> 1) + 1) * 8 * C +
           ((uz & 1) * 4 + (uy & 1) * 2 + (ux & 1)) * C + c;
  }
}

// Stage input plane p (zero outside 0 .. planes - 1) of sample b for tile
// column (ty, tx) into slot, and into mirror where it is not null.
template <typename Layout, int C>
__device__ void fewc_stage_x(const FewcArgs& a, unsigned char* slot, unsigned char* mirror,
                             int b, int p, int ty, int tx) {
  constexpr bool PHASE = std::is_same<Layout, PhaseLayout>::value;
  const __nv_bfloat16* xs = a.x + (int64_t)b * a.D * a.H * a.W * C;
  const int rows = PHASE ? (a.th >> 1) + 2 : a.th + 2;
  if (a.vec_x) {
    if constexpr (PHASE) {
      const int H2 = a.H >> 1, W2 = a.W >> 1, vox = (a.tw >> 1) + 2;
      const int by0 = ty * (a.th >> 1) - 1, bx0 = tx * (a.tw >> 1) - 1;
      const bool zin = (unsigned)p < (unsigned)(a.D >> 1);
      for (int i = threadIdx.x; i < rows * vox * C; i += blockDim.x) {
        const int yy = i / (vox * C), r = i - yy * vox * C, vx = r / C, pc = r - vx * C;
        const int by = by0 + yy, bx = bx0 + vx;
        const bool ok = zin && (unsigned)by < (unsigned)H2 && (unsigned)bx < (unsigned)W2;
        const __nv_bfloat16* src = ok ? xs + ((p * H2 + by) * W2 + bx) * 8 * C + 8 * pc : a.x;
        const int dst = (yy * a.rp + vx * 8 * C + 8 * pc) * 2;
        cp_async16(smem_addr(slot + dst), src, ok ? 16 : 0);
        if (mirror) cp_async16(smem_addr(mirror + dst), src, ok ? 16 : 0);
      }
    } else {
      const int npc = a.tw * C / 8 + 2, wc = a.W * C;
      const int y0 = ty * a.th - 1, e0 = tx * a.tw * C - 8;
      const bool zin = (unsigned)p < (unsigned)a.D;
      for (int i = threadIdx.x; i < rows * npc; i += blockDim.x) {
        const int yy = i / npc, pc = i - yy * npc, y = y0 + yy, e = e0 + 8 * pc;
        const bool ok = zin && (unsigned)y < (unsigned)a.H && e >= 0 && e + 8 <= wc;
        const __nv_bfloat16* src = ok ? xs + (p * a.H + y) * wc + e : a.x;
        const int dst = (yy * a.rp + 8 * pc) * 2;
        cp_async16(smem_addr(slot + dst), src, ok ? 16 : 0);
        if (mirror) cp_async16(smem_addr(mirror + dst), src, ok ? 16 : 0);
      }
    }
    return;
  }
  // value by value: a dense row whose W * C values are no whole 16-byte pieces,
  // or a base that is not 16-byte aligned
  const uint16_t* xv = reinterpret_cast<const uint16_t*>(xs);
  uint16_t* s16 = reinterpret_cast<uint16_t*>(slot);
  uint16_t* m16 = reinterpret_cast<uint16_t*>(mirror);
  if constexpr (PHASE) {
    const int vox = (a.tw >> 1) + 2, by0 = ty * (a.th >> 1) - 1, bx0 = tx * (a.tw >> 1) - 1;
    for (int i = threadIdx.x; i < rows * vox * 8 * C; i += blockDim.x) {
      const int yy = i / (vox * 8 * C), r = i - yy * vox * 8 * C;
      const int vx = r / (8 * C), r2 = r - vx * 8 * C, ph = r2 / C, c = r2 - ph * C;
      const int z = 2 * p + (ph >> 2), y = 2 * (by0 + yy) + (ph >> 1 & 1),
                x = 2 * (bx0 + vx) + (ph & 1);
      const bool ok =
          (unsigned)z < (unsigned)a.D && (unsigned)y < (unsigned)a.H && (unsigned)x < (unsigned)a.W;
      const uint16_t v = ok ? xv[Layout::inner(z, y, x, c, a.H, a.W, C)] : uint16_t(0);
      const int idx = yy * a.rp + vx * 8 * C + ph * C + c;
      s16[idx] = v;
      if (m16) m16[idx] = v;
    }
  } else {
    const int per_row = (a.tw + 2) * C, y0 = ty * a.th - 1, x0 = tx * a.tw - 1;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int yy = i / per_row, r = i - yy * per_row, pos = r / C, c = r - pos * C;
      const int y = y0 + yy, x = x0 + pos;
      const bool ok =
          (unsigned)p < (unsigned)a.D && (unsigned)y < (unsigned)a.H && (unsigned)x < (unsigned)a.W;
      const uint16_t v = ok ? xv[Layout::inner(p, y, x, c, a.H, a.W, C)] : uint16_t(0);
      const int idx = yy * a.rp + 8 - C + pos * C + c;
      s16[idx] = v;
      if (m16) m16[idx] = v;
    }
  }
}

__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  if (pending >= 3) {
    cp_async_wait<3>();
  } else if (pending == 2) {
    cp_async_wait<2>();
  } else if (pending == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// The loads of one block in stream order: for each of its items the input
// planes p0 - 1 .. p0 + n, entry e staging plane p0 - 1 + e into ring slot
// q % FEWC_SLOTS (q: the stream index) and, with dy, the cotangent plane
// p0 + e - 2 into dy slot q % FEWC_DY_SLOTS. Every entry is one cp.async group,
// empty past the end, so the waits count groups.
struct FewcLoader {
  int id, e, q;
  FewcItem it;
  __device__ void init(const FewcArgs& a) {
    id = blockIdx.x;
    e = 0;
    q = 0;
    if (id < a.nitems) it = fewc_item(a, id);
  }
  __device__ __forceinline__ void advance(const FewcArgs& a) {
    if (++e == it.n + 2) {
      e = 0;
      id += gridDim.x;
      if (id < a.nitems) it = fewc_item(a, id);
    }
  }
};

template <typename Layout, int C, int NT>
__global__ void __launch_bounds__(FEWC_THREADS, fewc_conv_blocks(C))
conv3_fewc_kernel(const FewcArgs a) {
  constexpr bool PHASE = std::is_same<Layout, PhaseLayout>::value;
  constexpr int KROWS = fewc_krows(C);
  constexpr int KSTEPS = KROWS / 16;
  constexpr int PB = mma_pitch(NT);
  constexpr int NF = NT / 8;
  constexpr int WPIECES = NT / 8;
  constexpr bool BREG = KSTEPS * NF <= 8;  // the weights' B fragments live in registers

  extern __shared__ __align__(128) unsigned char smem[];
  int* rowin = reinterpret_cast<int*>(smem);
  int* rowtab = rowin + FEWC_MAX_ROWS;
  int* rowout = rowtab + FEWC_MAX_ROWS;
  unsigned char* wsm = smem + fewc_table_bytes();
  unsigned char* xs = wsm + KROWS * PB;
  const int plane_bytes = a.sp * 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int co0 = blockIdx.y * NT;
  const bool whole = a.CO % NT == 0;  // every column of every N tile is a channel

  fewc_tables<Layout, C>(a, rowin, rowtab, rowout);
  {
    const __nv_bfloat16* wt = a.wp + (size_t)blockIdx.y * KROWS * NT;
    for (int i = tid; i < KROWS * WPIECES; i += blockDim.x) {
      const int krow = i / WPIECES, piece = i - krow * WPIECES;
      cp_async16(smem_addr(wsm + krow * PB + piece * 16), wt + krow * NT + piece * 8, 16);
    }
    cp_async_commit();
  }

  // this lane's K columns of every k16 step: 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9
  int koff[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      koff[ks][q] = fewc_koff<PHASE, C>(ks * 16 + 2 * tq + (q & 1) + (q >> 1) * 8, g, a.rp, a.sp);

  float sc[NF][2], sh[NF][2];
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int co = co0 + n * 8 + 2 * tq + q;
      sc[n][q] = co < a.CO ? a.scale[co] : 0.f;
      sh[n][q] = co < a.CO ? a.shift[co] : 0.f;
    }
  // the activation as one select: y >= 0 ? y : y * neg (+ 0: no negative zero)
  const float neg = a.relu_mode == 2 ? a.alpha[0] : a.relu_mode == 1 ? 0.f : 1.f;
  const uint32_t sw = smem_addr(wsm) + (lane & 15) * PB + (NT == 8 ? 0 : (lane >> 4) * 16);
  uint32_t breg[BREG ? KSTEPS : 1][NF][2];

  FewcLoader ld;
  ld.init(a);
  auto issue = [&]() {
    if (ld.id < a.nitems) {
      const int slot = ld.q % FEWC_SLOTS;
      fewc_stage_x<Layout, C>(a, xs + slot * plane_bytes,
                              slot < 2 ? xs + (FEWC_SLOTS + slot) * plane_bytes : nullptr,
                              ld.it.b, ld.it.p0 - 1 + ld.e, ld.it.ty, ld.it.tx);
      ld.advance(a);
    }
    cp_async_commit();
    ++ld.q;
  };
  __syncthreads();  // the tables, before the first staging reads them
  while (ld.q < FEWC_SLOTS) issue();

  const int64_t out_sample = (int64_t)a.D * a.H * a.W * a.CO;
  int s = 0;  // stream index of the window's first plane
  for (int id = blockIdx.x; id < a.nitems; id += gridDim.x) {
    const FewcItem it = fewc_item(a, id);
    const int yb = it.ty * a.th, xb = it.tx * a.tw;
    void* sample_out = static_cast<unsigned char*>(a.out) +
                       it.b * out_sample * (a.out_bf16 ? 2 : 4);
    for (int j = 0; j < it.n; ++j, ++s) {
      cp_async_wait_upto(ld.q - s - 3);  // the window's three planes have landed
      __syncthreads();                   // for everyone; the slot of plane s - 1 is free
      while (ld.q <= s + FEWC_SLOTS - 1) issue();

      if constexpr (BREG) {
        if (s == 0) {
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) {
            if constexpr (NT == 8) {
              ldsm_x2_trans(sw + ks * 16 * PB, breg[ks][0][0], breg[ks][0][1]);
            } else {
              ldsm_x4_trans(sw + ks * 16 * PB, breg[ks][0][0], breg[ks][0][1], breg[ks][1][0],
                            breg[ks][1][1]);
            }
          }
        }
      }
      const uint16_t* win =
          reinterpret_cast<const uint16_t*>(xs + (s % FEWC_SLOTS) * plane_bytes);
      const int zb = PHASE ? 2 * (it.p0 + j) : it.p0 + j;
      // the step's output origin; a tile inside the volume skips the rows' checks
      const int64_t origin = Layout::inner(zb, yb, xb, co0, a.H, a.W, a.CO);
      const bool interior = yb + a.th <= a.H && xb + a.tw <= a.W;
      for (int r32 = warp * 32; r32 < a.rows; r32 += 8 * 32) {  // this warp's 32 rows
        int rin[2];
#pragma unroll
        for (int jm = 0; jm < 2; ++jm) rin[jm] = rowin[r32 + jm * 16 + g];

        float acc[2][NF][4];
#pragma unroll
        for (int jm = 0; jm < 2; ++jm)
#pragma unroll
          for (int n = 0; n < NF; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[jm][n][q] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          uint32_t bt[NF][2];
          if constexpr (BREG) {
#pragma unroll
            for (int n = 0; n < NF; ++n) bt[n][0] = breg[ks][n][0], bt[n][1] = breg[ks][n][1];
          } else if constexpr (NT == 8) {
            ldsm_x2_trans(sw + ks * 16 * PB, bt[0][0], bt[0][1]);
          } else {
            ldsm_x4_trans(sw + ks * 16 * PB, bt[0][0], bt[0][1], bt[1][0], bt[1][1]);
          }
#pragma unroll
          for (int jm = 0; jm < 2; ++jm) {
            const uint16_t* r0 = win + rin[jm];  // row g; row g + 8 lies 8 voxels on
            const uint16_t* r8 = r0 + 8 * C;
            uint32_t af[4];
            af[0] = r0[koff[ks][0]] | uint32_t(r0[koff[ks][1]]) << 16;
            af[1] = r8[koff[ks][0]] | uint32_t(r8[koff[ks][1]]) << 16;
            af[2] = r0[koff[ks][2]] | uint32_t(r0[koff[ks][3]]) << 16;
            af[3] = r8[koff[ks][2]] | uint32_t(r8[koff[ks][3]]) << 16;
#pragma unroll
            for (int n = 0; n < NF; ++n) mma_bf16(acc[jm][n], af, bt[n]);
          }
        }

        // epilogue: row g + 8 half of m16 tile jm holds columns n * 8 + 2 tq + {0, 1};
        // row g + 8 lies 8 channel vectors after row g
#pragma unroll
        for (int jm = 0; jm < 2; ++jm) {
          const int row_g = rowout[r32 + jm * 16 + g];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            bool inside = interior;
            if (!interior) {
              const int at = rowtab[r32 + jm * 16 + g + 8 * half];
              inside = yb + (at >> 10 & 1023) < a.H && xb + (at >> 20) < a.W;
            }
            const int64_t at_out = origin + row_g + half * 8 * a.CO;
            float v[NF][2];
#pragma unroll
            for (int n = 0; n < NF; ++n)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const float y = acc[jm][n][2 * half + q] * sc[n][q] + sh[n][q];
                v[n][q] = a.relu_mode == 0 || y >= 0.f ? y : fmaf(y, neg, 0.f);
              }
            if (a.out_bf16) {
              __nv_bfloat16* o = static_cast<__nv_bfloat16*>(sample_out) + at_out;
              uint32_t pr[NF];
#pragma unroll
              for (int n = 0; n < NF; ++n) {
                const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[n][0], v[n][1]);
                pr[n] = *reinterpret_cast<const uint32_t*>(&h2);
              }
              if constexpr (NF == 2) {
                // lanes tq, tq ^ 1 swap halves: even lanes store columns 2 tq .. 2 tq + 3,
                // odd lanes 8 + 2 tq - 2 .. 8 + 2 tq + 1
                const uint32_t got = __shfl_xor_sync(0xffffffffu, (tq & 1) ? pr[0] : pr[1], 1);
                if (inside && whole) {
                  const int col = (tq & 1) ? 8 + 2 * tq - 2 : 2 * tq;
                  *reinterpret_cast<uint2*>(o + col) =
                      (tq & 1) ? make_uint2(got, pr[1]) : make_uint2(pr[0], got);
                }
              } else if (inside && whole) {
                *reinterpret_cast<uint32_t*>(o + 2 * tq) = pr[0];
              }
              if (inside && !whole) {
#pragma unroll
                for (int n = 0; n < NF; ++n)
#pragma unroll
                  for (int q = 0; q < 2; ++q)
                    if (co0 + n * 8 + 2 * tq + q < a.CO)
                      o[n * 8 + 2 * tq + q] = __float2bfloat16(v[n][q]);
              }
            } else if (inside) {
              float* o = static_cast<float*>(sample_out) + at_out;
#pragma unroll
              for (int n = 0; n < NF; ++n) {
                if (whole) {
                  *reinterpret_cast<float2*>(o + n * 8 + 2 * tq) = make_float2(v[n][0], v[n][1]);
                } else {
#pragma unroll
                  for (int q = 0; q < 2; ++q)
                    if (co0 + n * 8 + 2 * tq + q < a.CO) o[n * 8 + 2 * tq + q] = v[n][q];
                }
              }
            }
          }
        }
      }
    }
    s += 2;  // the item's two halo planes
  }
  cp_async_wait<0>();
}

// The geometry both few-channel launchers derive from the plan, checked;
// returns false for a plan the kernels do not take.
template <typename Layout>
bool fewc_geometry(FewcArgs& a, int B, int D, int H, int W, int C, int CO, int th, int tw,
                   int seg) {
  constexpr bool PHASE = std::is_same<Layout, PhaseLayout>::value;
  if (C < 1 || C > 7 || CO < 1 || th < 1 || tw < 1 || seg < 1) return false;
  const int rows = PHASE ? 2 * th * tw : th * tw;
  if (rows != 256 && rows != 512) return false;
  if (PHASE ? th % 2 || tw % 4 || D % 2 || H % 2 || W % 2 : tw % 16 != 0) return false;
  a.D = D, a.H = H, a.W = W, a.C = C, a.CO = CO;
  a.th = th, a.tw = tw, a.rows = rows, a.seg = seg;
  a.planes = PHASE ? D / 2 : D;
  a.nty = (H + th - 1) / th;
  a.ntx = (W + tw - 1) / tw;
  a.nseg = (a.planes + seg - 1) / seg;
  const long long nitems = (long long)B * a.nty * a.ntx * a.nseg;
  const long long sample = (long long)D * H * W * (C > CO ? C : CO);  // 32-bit offsets inside
  if (nitems < 1 || nitems > 0x7fffffffLL || sample > 0x7fffffffLL) return false;
  a.nitems = static_cast<int>(nitems);
  a.rp = fewc_row_pitch(PHASE, C, tw);
  a.sp = fewc_plane_pitch(PHASE, C, th, tw);
  return true;
}

template <typename Layout, int C, int NT>
cudaError_t launch_fewc_inst(const FewcArgs& a, int grid_x, int n_tiles, int smem_bytes,
                             cudaStream_t stream) {
  auto kernel = conv3_fewc_kernel<Layout, C, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, n_tiles), FEWC_THREADS, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// x, packed weights ([N tile][fewc_krows(C)][nt], ops/fused_conv.py::pack_weights)
// bf16; out bf16 or f32. (th, tw, seg, nt, grid_x, smem_bytes) is the wrapper's
// plan (ops/fused_conv.py::fewc_plan); vec: the input's rows are whole 16-byte
// pieces from a 16-byte aligned base.
template <typename Layout>
int launch_conv3_fewc(const void* x, const void* wp, const float* scale, const float* shift,
                      const float* alpha, int relu_mode, void* out, int B, int D, int H, int W,
                      int C, int CO, int out_bf16, int th, int tw, int seg, int nt, int grid_x,
                      int smem_bytes, int vec, void* stream) {
  constexpr bool PHASE = std::is_same<Layout, PhaseLayout>::value;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  FewcArgs a;
  if (!fewc_geometry<Layout>(a, B, D, H, W, C, CO, th, tw, seg)) return invalid;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.dy = nullptr;
  a.scale = scale;
  a.shift = shift;
  a.alpha = alpha;
  a.out = out;
  a.relu_mode = relu_mode;
  a.out_bf16 = out_bf16;
  a.vec_x = vec;
  a.vec_dy = 0;
  const int n_tiles = (CO + nt - 1) / nt;
  if (grid_x < 1 || grid_x > a.nitems || n_tiles > 65535 ||
      smem_bytes != fewc_smem_bytes(PHASE, C, nt, th, tw))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEGK_FEWC_CASE(C_, NT_)                                                           \
  if (C == C_ && nt == NT_)                                                               \
    return static_cast<int>(                                                              \
        launch_fewc_inst<Layout, C_, NT_>(a, grid_x, n_tiles, smem_bytes, s));
  SEGK_FEWC_CASE(1, 8)
  SEGK_FEWC_CASE(1, 16)
  SEGK_FEWC_CASE(2, 8)
  SEGK_FEWC_CASE(2, 16)
  SEGK_FEWC_CASE(3, 8)
  SEGK_FEWC_CASE(3, 16)
  SEGK_FEWC_CASE(4, 8)
  SEGK_FEWC_CASE(4, 16)
  SEGK_FEWC_CASE(5, 8)
  SEGK_FEWC_CASE(5, 16)
  SEGK_FEWC_CASE(6, 8)
  SEGK_FEWC_CASE(6, 16)
  SEGK_FEWC_CASE(7, 8)
  SEGK_FEWC_CASE(7, 16)
#undef SEGK_FEWC_CASE
  return invalid;
}

}  // namespace segk
