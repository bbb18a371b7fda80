// Tensor-core body of the two weight-gradient kernels of the stride-1 SAME
// 3x3x3 convolution for bf16 input with C % 8 == 0 and CO % 8 == 0
// (fused_conv_dw.cu: dense NDHWC; phase_conv_dw.cu: phase-major tensors
// standing for a 2x-upsampled volume). f32 input, and bf16 with any other
// channel count, take the f32 body of conv3_f32_dw.cuh: the f32 train step
// is judged against f64 and TF32 would break that.
//
// It replaces the same Pallas kernels as that body:
// segmantic_tpu/ops/pallas_conv.py::_dw_kernel (conv3d_packed_dw) for the
// dense layout; segmantic_tpu/ops/phase_gemm.py::_dw_kernel_folded and
// ::_dw_kernel (phase_conv_gemm_dw_folded_p, phase_conv_gemm_dw_p) together
// with _unfold_dw for the phase layout.
//
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]      (f32)
//
// is a GEMM with M = 27 * C rows (tap, ci), N = CO columns and K = every
// output position. Both tensors are channel-last, so a staged row is one
// position's channel vector, K-major for A and for B alike:
// ldmatrix.x4.trans hands mma.sync.m16n8k16 its A fragment (16 ci x 16
// positions) and its B fragment (16 positions x 8 co) from rows stored
// [position][channel]. One row address per lane makes a tap's window of x
// plain address arithmetic on one staged halo brick, in either layout.
//
// What bounds it on the card: at the top stages (C <= 16) device memory by
// the count of bytes, and in this design shared-memory traffic (every (tap,
// k16 step) is one 512-byte ldmatrix feeding one to four mma); at C = 32 the
// two balance; the deep stages (6^3, 12^3) have so few positions that launch,
// staging and the second pass decide. Staging a brick takes about as long as
// multiplying it and the two overlap only partly inside one block, so several
// blocks on a multiprocessor matter more than a deeper ring (a third stage
// that cost a resident block made the top shapes slower on an H100).
// What the design does about it:
//
// - A block owns all 27 taps of a chunk of CK input channels x a tile of NT
//   output channels (grid.y) and walks the bricks split, split + splits, ...
//   of TD x TH x TW output positions (grid.x = splits). Per brick it stages
//   the (TD+2)(TH+2)(TW+2) halo of x and the brick of dy once, as bf16, by
//   16-byte zero-filling cp.async into a ring: SAME padding, ragged edges and
//   channel padding cost nothing, and x leaves device memory once, not three
//   times. A position outside the volume has a zero dy row, so its x values
//   need no mask. The Layout policy is all the two kernels differ in.
// - Warps split the taps, not the positions: every warp reads the same B
//   fragments of a k16 step and no sum crosses warps. Nine warps of three
//   taps (one (dz, dy) row); at CK = 8, which has no m16 of its own, two taps
//   share one m16 (lanes 8-15 and 24-31 address the next tap's window) and
//   seven warps own two pairs each; the 28th half is never written.
// - The k16 step's 16 positions are the brick's positions flattened (z, y, x);
//   a table maps each to its halo row, so small extents (6^3) still fill the
//   k16 steps. Brick, CK, NT, splits and ring depth are the wrapper's plan
//   (ops/fused_conv.py::dw_plan); the launcher refuses a plan whose
//   shared-memory sum differs from its own.
// - Deterministic without atomics: each block writes its partial to a
//   workspace [split][27][C][CO] and a second kernel sums the splits in a
//   fixed order; with one split the block writes the result itself and the
//   second launch is skipped. A repeated launch is bit-equal.
#pragma once

#include "conv3_mma.cuh"

namespace segk {

namespace {
// out[i] = sum over the partials k = 0 .. parts-1, in that order: the second
// launch of every weight-gradient body that splits its positions.
__global__ void dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                 long long n, int parts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < parts; ++k) s += ws[(long long)k * n + i];
  out[i] = s;
}
}  // namespace

struct DwMmaArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dy;
  float* part;            // [split][27][C][CO]; the result itself with one split
  int D, H, W, C, CO;     // full-resolution extents
  int td, th, tw;         // brick of output positions
  int nbz, nby, nbx, nbricks;
  int nchunks;            // 1: the cursor's chunk dimension is not used here
  int n_ci, stages;
};

// Warps of a block: 9 x 3 taps, or 7 x 2 tap pairs at CK = 8.
__host__ __device__ constexpr int dw_mma_warps(int ck) { return ck == 8 ? 7 : 9; }

// K rows of a brick: its positions rounded up to whole k16 steps.
__host__ __device__ constexpr int dw_mma_rows16(int td, int th, int tw) {
  return (td * th * tw + 15) / 16 * 16;
}

// Index tables at the head of shared memory: 32 tap offsets (128 bytes), the
// (z, y, x) of every halo position, and per K row its (z, y, x) and the byte
// offset of its halo row.
__host__ __device__ constexpr int dw_mma_table_bytes(int td, int th, int tw) {
  return 128 +
         (((td + 2) * (th + 2) * (tw + 2) + 2 * dw_mma_rows16(td, th, tw)) * 4 + 15) / 16 * 16;
}

// The wrapper's plan computes the same sum: the launcher refuses a mismatch.
inline int dw_mma_smem_bytes(int ck, int nt, int td, int th, int tw, int stages) {
  const int a_bytes = (td + 2) * (th + 2) * (tw + 2) * mma_pitch(ck);
  const int b_bytes = dw_mma_rows16(td, th, tw) * mma_pitch(nt);
  return dw_mma_table_bytes(td, th, tw) + stages * (a_bytes + b_bytes);
}

template <typename Layout, int CK, int NT>
__global__ void __launch_bounds__(dw_mma_warps(CK) * 32)
conv3_dw_mma_kernel(const DwMmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PA = mma_pitch(CK);  // bytes per staged x position
  constexpr int PB = mma_pitch(NT);  // bytes per staged dy position
  constexpr int APIECES = CK / 8;    // 16-byte pieces per position
  constexpr int BPIECES = NT / 8;
  constexpr int MT = CK == 8 ? 1 : CK / 16;  // m16 tiles per tap (CK = 8: per tap pair)
  constexpr int NF = NT / 8;                 // n8 fragments
  constexpr int TPW = CK == 8 ? 2 : 3;       // taps (CK = 8: tap pairs) a warp owns

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HP = a.th + 2, WP = a.tw + 2;
  const int hp = (a.td + 2) * HP * WP;
  const int rows = a.td * a.th * a.tw;
  const int rows16 = dw_mma_rows16(a.td, a.th, a.tw);
  const int ksteps = rows16 >> 4;
  const int a_bytes = hp * PA;
  const int stage_bytes = a_bytes + rows16 * PB;

  int* tapoff = reinterpret_cast<int*>(smem);
  int* postab = tapoff + 32;     // halo position -> z | y << 10 | x << 20 in the brick
  int* rowtab = postab + hp;     // K row -> the same of its output position, -1: padding
  int* arow = rowtab + rows16;   // K row -> byte offset of its halo row at tap (0, 0, 0)
  unsigned char* ring = smem + dw_mma_table_bytes(a.td, a.th, a.tw);

  const int split = blockIdx.x;
  const int c0 = ((int)blockIdx.y % a.n_ci) * CK;
  const int co0 = ((int)blockIdx.y / a.n_ci) * NT;

  if (tid < 32) {  // byte offset of tap t's window in the halo (past 26: tap 26 again)
    const int t = min(tid, 26);
    tapoff[tid] = (((t / 9) * HP + (t / 3) % 3) * WP + t % 3) * PA;
  }
  for (int i = tid; i < hp; i += blockDim.x) {
    const int pz = i / (HP * WP);
    const int r = i - pz * HP * WP;
    postab[i] = pz | (r / WP) << 10 | (r % WP) << 20;
  }
  for (int i = tid; i < rows16; i += blockDim.x) {
    const int pz = i / (a.th * a.tw);
    const int r = i - pz * a.th * a.tw;
    const int py = r / a.tw, px = r % a.tw;
    rowtab[i] = i < rows ? pz | py << 10 | px << 20 : -1;
    arow[i] = i < rows ? ((pz * HP + py) * WP + px) * PA : 0;  // padding: dy row is zero
  }
  __syncthreads();

  // ldmatrix.x4.trans row of this lane: matrices 0, 1 hold positions 0-7 of the
  // k16 step, 2, 3 positions 8-15; matrices 1, 3 the upper 8 rows of the m16
  // (the next 8 channels, or at CK = 8 the next tap's window)
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int upper = (lane >> 3) & 1;
  int aoff[TPW];
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    if constexpr (CK == 8) {
      aoff[j] = tapoff[2 * (warp * TPW + j) + upper];
    } else {
      aoff[j] = tapoff[warp * TPW + j] + upper * 16;
    }
  }
  const int boff = (lane & 15) * PB + (NT == 8 ? 0 : (lane >> 4) * 16);

  const int nsteps = (a.nbricks - split + (int)gridDim.x - 1) / (int)gridDim.x;
  const int64_t in_sample = (int64_t)a.D * a.H * a.W * a.C;
  const int64_t out_sample = (int64_t)a.D * a.H * a.W * a.CO;
  StepCursor load;  // the brick being staged runs stages - 1 ahead of the one multiplied
  load.init(split, gridDim.x, a);
  int load_slot = 0, work_slot = 0;

  auto stage_step = [&](int step) {
    if (step < nsteps) {
      const int z0 = load.bz * a.td, y0 = load.by * a.th, x0 = load.bx * a.tw;
      const __nv_bfloat16* xs = a.x + load.b * in_sample;
      const __nv_bfloat16* gs = a.dy + load.b * out_sample;
      const uint32_t dst_a = smem_addr(ring + load_slot * stage_bytes);
      for (int i = tid; i < hp * APIECES; i += blockDim.x) {
        const int pos = i / APIECES, piece = i % APIECES;
        const int at = postab[pos];
        const int gz = z0 - 1 + (at & 1023), gy = y0 - 1 + (at >> 10 & 1023),
                  gx = x0 - 1 + (at >> 20);
        const int c = c0 + piece * 8;
        const bool ok = (unsigned)gz < (unsigned)a.D && (unsigned)gy < (unsigned)a.H &&
                        (unsigned)gx < (unsigned)a.W && c < a.C;
        const __nv_bfloat16* src = ok ? xs + Layout::inner(gz, gy, gx, c, a.H, a.W, a.C) : a.x;
        cp_async16(dst_a + pos * PA + piece * 16, src, ok ? 16 : 0);
      }
      const uint32_t dst_b = dst_a + a_bytes;
      for (int i = tid; i < rows16 * BPIECES; i += blockDim.x) {
        const int row = i / BPIECES, piece = i % BPIECES;
        const int at = rowtab[row];
        const int gz = z0 + (at & 1023), gy = y0 + (at >> 10 & 1023), gx = x0 + (at >> 20 & 1023);
        const int co = co0 + piece * 8;
        const bool ok = at >= 0 && gz < a.D && gy < a.H && gx < a.W && co < a.CO;
        const __nv_bfloat16* src =
            ok ? gs + Layout::inner(gz, gy, gx, co, a.H, a.W, a.CO) : a.dy;
        cp_async16(dst_b + row * PB + piece * 16, src, ok ? 16 : 0);
      }
      load.advance(a);
      load_slot = load_slot + 1 == a.stages ? 0 : load_slot + 1;
    }
    cp_async_commit();  // one group per step, empty past the end: the waits count groups
  };

  for (int s = 0; s < a.stages - 1; ++s) stage_step(s);

  float acc[TPW][MT][NF][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][m][n][q] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    if (a.stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step's data landed for everyone; slot (step - 1) is free
    stage_step(step + a.stages - 1);

    const uint32_t sa = smem_addr(ring + work_slot * stage_bytes);
    const uint32_t sb = sa + a_bytes + boff;
    work_slot = work_slot + 1 == a.stages ? 0 : work_slot + 1;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t ar = sa + arow[ks * 16 + krow];
      uint32_t bf[NF][2];
      if constexpr (NT == 8) {
        ldsm_x2_trans(sb + ks * 16 * PB, bf[0][0], bf[0][1]);
      } else {
#pragma unroll
        for (int n = 0; n < NF; n += 2)
          ldsm_x4_trans(sb + ks * 16 * PB + n * 16, bf[n][0], bf[n][1], bf[n + 1][0],
                        bf[n + 1][1]);
      }
#pragma unroll
      for (int j = 0; j < TPW; ++j)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t af[4];
          ldsm_x4_trans(ar + aoff[j] + m * 32, af[0], af[1], af[2], af[3]);
#pragma unroll
          for (int n = 0; n < NF; ++n) mma_bf16(acc[j][m][n], af, bf[n]);
        }
    }
  }
  cp_async_wait<0>();

  // accumulator (row g + 8 * half, columns 2 * tq, 2 * tq + 1) of each m16n8 tile
  float* part = a.part + (int64_t)split * 27 * a.C * a.CO;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int tap, ci;
        if constexpr (CK == 8) {
          tap = 2 * (warp * TPW + j) + half;
          ci = c0 + g;
        } else {
          tap = warp * TPW + j;
          ci = c0 + m * 16 + g + 8 * half;
        }
        if (tap >= 27 || ci >= a.C) continue;
        float* row = part + ((int64_t)tap * a.C + ci) * a.CO;
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          const int co = co0 + n * 8 + 2 * tq;
          if (co < a.CO)  // CO % 8 == 0: co + 1 < CO as well, and the pair is 8-byte aligned
            *reinterpret_cast<float2*>(row + co) =
                make_float2(acc[j][m][n][2 * half], acc[j][m][n][2 * half + 1]);
        }
      }
}

namespace {
// out[i] = sum over the partials: 8 lanes of parts per element, each summing
// k = lane, lane + 8, ... in that order, then the 8 lane sums in order.
__global__ void dw_reduce_lanes_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                       long long n, int parts) {
  __shared__ float sums[8][32];
  const int e = threadIdx.x & 31, pl = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + e;
  float s = 0.f;
  if (i < n)
    for (int k = pl; k < parts; k += 8) s += ws[(long long)k * n + i];
  sums[pl][e] = s;
  __syncthreads();
  if (pl == 0 && i < n) {
    float t = sums[0][e];
#pragma unroll
    for (int k = 1; k < 8; ++k) t += sums[k][e];
    out[i] = t;
  }
}
}  // namespace

template <typename Layout, int CK, int NT>
cudaError_t launch_dw_mma_inst(const DwMmaArgs& a, int splits, int n_tiles, int smem_bytes,
                               cudaStream_t stream) {
  auto kernel = conv3_dw_mma_kernel<Layout, CK, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(splits, n_tiles), dw_mma_warps(CK) * 32, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// x (B, D, H, W, C) and dy (B, D, H, W, CO) bf16 in the Layout, D/H/W full
// resolution; ws holds splits * 27 * C * CO floats (unused with one split);
// out (3, 3, 3, C, CO) f32. (td, th, tw, ck, nt, splits, stages, smem_bytes) is
// the wrapper's plan (ops/fused_conv.py::dw_plan).
template <typename Layout>
int launch_conv3_dw_mma(const void* x, const void* dy, float* ws, float* out, int B, int D,
                        int H, int W, int C, int CO, int td, int th, int tw, int ck, int nt,
                        int splits, int stages, int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (C < 8 || C % 8 || CO < 8 || CO % 8 || td < 1 || th < 1 || tw < 1 || td > 512 ||
      th > 512 || tw > 512 || stages < 2 || stages > 3 || splits < 1)
    return invalid;
  DwMmaArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.part = splits == 1 ? out : ws;
  a.D = D, a.H = H, a.W = W, a.C = C, a.CO = CO;
  a.td = td, a.th = th, a.tw = tw;
  a.nbz = (D + td - 1) / td, a.nby = (H + th - 1) / th, a.nbx = (W + tw - 1) / tw;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  const long long sample = (long long)D * H * W * (C > CO ? C : CO);  // 32-bit offsets inside
  if (nbricks > 0x7fffffffLL || sample > 0x7fffffffLL || splits > nbricks) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.nchunks = 1;
  a.n_ci = (C + ck - 1) / ck;
  a.stages = stages;
  const long long n_tiles = (long long)a.n_ci * ((CO + nt - 1) / nt);
  if (n_tiles > 65535 || smem_bytes != dw_mma_smem_bytes(ck, nt, td, th, tw, stages))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SEGK_DW_MMA_CASE(CK_, NT_)                                                        \
  if (ck == CK_ && nt == NT_)                                                             \
    err = launch_dw_mma_inst<Layout, CK_, NT_>(a, splits, (int)n_tiles, smem_bytes, s);
  SEGK_DW_MMA_CASE(8, 8)
  SEGK_DW_MMA_CASE(8, 16)
  SEGK_DW_MMA_CASE(8, 32)
  SEGK_DW_MMA_CASE(16, 8)
  SEGK_DW_MMA_CASE(16, 16)
  SEGK_DW_MMA_CASE(16, 32)
  SEGK_DW_MMA_CASE(32, 8)
  SEGK_DW_MMA_CASE(32, 16)
  SEGK_DW_MMA_CASE(32, 32)
#undef SEGK_DW_MMA_CASE
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
