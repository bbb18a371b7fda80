// Tensor-core body of the two stride-1 SAME 3x3x3 convolution kernels for
// bf16 input (fused_conv.cu: dense NDHWC; phase_conv.cu: phase-major tensors
// standing for a 2x-upsampled volume). The f32 kernels take the f32 body of
// conv3_f32.cuh: TF32 would cost them their 1e-6 agreement with the CPU.
//
// The conv is an implicit GEMM: M = output positions, N = output channels,
// K = 27 taps x C input channels, f32 accumulation. Instruction: bf16
// mma.sync.aligned.m16n8k16 with both operands fetched from shared memory by
// ldmatrix. ldmatrix takes one row address per lane, so the 27 tap-shifted
// windows of one staged halo brick are plain address arithmetic in either
// layout, and no operand needs a descriptor-conformant tile; at 8-32 channels
// the work is bound by bytes or sits within 1.5x of the ridge, so the full
// wgmma rate is not what these shapes lack.
//
// One block of `warps` warps owns an N tile of NT output channels (grid.y) and
// walks bricks of TD x TH x TW output positions (grid.x, persistent: brick =
// blockIdx.x, += gridDim.x). For each (brick, channel chunk of CK) step the
// (TD+2)(TH+2)(TW+2) halo brick is staged once as bf16 by 16-byte cp.async
// (zero-fill form: SAME padding, ragged edges and channel padding cost
// nothing), into a ring of `stages` buffers, so the next step loads while this
// one multiplies -- across bricks too. The Layout policy gives the address of
// a voxel's channel vector; that is all the two kernels differ in. The packed
// weights (ops/fused_conv.py::pack_weights: [N tile][chunk][K row][NT], zero
// padded) stay resident in shared memory for the whole block where they fit,
// else their chunk rides the ring with the input's. Shared-memory rows are
// pitched at an odd number of 16-byte units so the 8 rows of one ldmatrix
// phase fall on distinct banks.
//
// Every warp multiplies 32 rows (two m16 tiles) by the NT columns. M rows are
// the brick's positions flattened (z, y, x); the brick shape is a run-time
// choice of the wrapper's plan, so small extents (12^3, 6^3) still fill >= 75%
// of the rows. C = 8 has no k16 of its own: two taps share one k16 step (the
// upper half of the lanes addresses the next tap's window) and the packed
// weights carry a zero 28th tap. The epilogue applies scale, shift and
// none / relu / prelu on the accumulators, passes them through the warp's
// shared-memory rows and stores whole channel vectors in 16-byte pieces at
// the mapped address (scalar stores where CO makes them unaligned).
//
// At the byte-bound shapes the kernel is bound by its instruction count and
// by ldmatrix traffic, not by device memory: so the (z, y, x) of every
// halo position and M row sit in small shared tables, bricks are walked by
// carries (StepCursor) and offsets inside a sample are 32-bit -- no division
// and no 64-bit product per staged piece -- and the k16 loop is unrolled.
#pragma once

#include "conv3.cuh"

namespace segk {

struct MmaArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wp;  // packed weights
  const float* scale;
  const float* shift;
  const float* alpha;
  void* out;
  int relu_mode, out_bf16;
  int D, H, W, C, CO;        // full-resolution extents
  int td, th, tw;            // brick of output positions
  int nbz, nby, nbx, nbricks;
  int nchunks, stages, resident;
};

// Bytes between consecutive rows of n bf16 values: an odd count of 16-byte
// units (8 values: the rows are contiguous, which is conflict-free already).
__host__ __device__ constexpr int mma_pitch(int n) { return n == 8 ? 16 : 2 * n + 16; }

__host__ __device__ constexpr int mma_ksteps(int ck) { return ck == 8 ? 14 : 27 * (ck / 16); }

// Index tables at the head of shared memory: 28 tap offsets (128 bytes), the
// (z, y, x) of every halo position and of every M row, packed in one int each.
__host__ __device__ constexpr int mma_table_bytes(int td, int th, int tw, int warps) {
  return 128 + (((td + 2) * (th + 2) * (tw + 2) + warps * 32) * 4 + 15) / 16 * 16;
}

// The wrapper's plan computes the same sum: the launcher refuses a mismatch.
inline int mma_smem_bytes(int ck, int nt, int td, int th, int tw, int warps, int nchunks,
                          int stages, int resident, int out_bf16) {
  const int a_bytes = (td + 2) * (th + 2) * (tw + 2) * mma_pitch(ck);
  const int w_bytes = mma_ksteps(ck) * 16 * mma_pitch(nt);
  const int o_bytes = warps * 32 * (nt * (out_bf16 ? 2 : 4) + 16);
  return mma_table_bytes(td, th, tw, warps) + stages * (a_bytes + (resident ? 0 : w_bytes)) +
         (resident ? nchunks * w_bytes : 0) + o_bytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float activate(float y, int relu_mode, float a) {
  if (relu_mode == 1) return fmaxf(y, 0.f);
  if (relu_mode == 2) return y >= 0.f ? y : a * y;
  return y;
}

// Walks the (brick, chunk) steps of one block: bricks first, first + stride,
// ... in the mixed radix (b, bz, by, bx), by carries instead of divisions (the
// kernel is bound by its instruction count at the byte-bound shapes).
struct StepCursor {
  int bx, by, bz, b, chunk;
  int sx, sy, sz, sb;
  template <typename Args>  // nbx, nby, nbz, nchunks: MmaArgs, or the dw body's DwMmaArgs
  __device__ void init(int first, int stride, const Args& a) {
    bx = first % a.nbx, first /= a.nbx;
    by = first % a.nby, first /= a.nby;
    bz = first % a.nbz, b = first / a.nbz;
    sx = stride % a.nbx, stride /= a.nbx;
    sy = stride % a.nby, stride /= a.nby;
    sz = stride % a.nbz, sb = stride / a.nbz;
    chunk = 0;
  }
  template <typename Args>
  __device__ __forceinline__ void advance(const Args& a) {
    if (++chunk < a.nchunks) return;
    chunk = 0;
    bx += sx;
    int carry = bx >= a.nbx;
    bx -= carry ? a.nbx : 0;
    by += sy + carry;
    carry = by >= a.nby;
    by -= carry ? a.nby : 0;
    bz += sz + carry;
    carry = bz >= a.nbz;
    bz -= carry ? a.nbz : 0;
    b += sb + carry;
  }
};

template <typename Layout, int CK, int NT>
__global__ void __launch_bounds__(256) conv3_mma_kernel(const MmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PA = mma_pitch(CK);    // bytes per staged position
  constexpr int PB = mma_pitch(NT);    // bytes per packed-weight K row
  constexpr int KSTEPS = mma_ksteps(CK);
  constexpr int KROWS = KSTEPS * 16;
  constexpr int APIECES = CK / 8;      // 16-byte pieces per position
  constexpr int WPIECES = NT / 8;
  constexpr int NF = NT / 8;           // n8 fragments per warp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HP = a.th + 2, WP = a.tw + 2;
  const int hp = (a.td + 2) * HP * WP;
  const int rows = a.td * a.th * a.tw;
  const int a_bytes = hp * PA;
  const int w_bytes = KROWS * PB;
  const int stage_bytes = a_bytes + (a.resident ? 0 : w_bytes);
  const int esize = a.out_bf16 ? 2 : 4;
  const int PO = NT * esize + 16;

  int* tapoff = reinterpret_cast<int*>(smem);
  int* postab = tapoff + 32;    // halo position -> z | y << 10 | x << 20 in the brick
  int* rowtab = postab + hp;    // M row -> the same of its output position, -1: padding
  unsigned char* ring = smem + mma_table_bytes(a.td, a.th, a.tw, blockDim.x >> 5);
  unsigned char* wres = ring + a.stages * stage_bytes;
  unsigned char* my_out = wres + (a.resident ? a.nchunks * w_bytes : 0) + warp * 32 * PO;

  const int ntile = blockIdx.y;
  const int co0 = ntile * NT;
  const __nv_bfloat16* wtile = a.wp + (size_t)ntile * a.nchunks * KROWS * NT;

  if (tid < 28) {  // byte offset of tap t's window in the brick (28: the zero tap)
    const int t = min(tid, 26);
    tapoff[tid] = (((t / 9) * HP + (t / 3) % 3) * WP + t % 3) * PA;
  }
  for (int i = tid; i < hp; i += blockDim.x) {
    const int pz = i / (HP * WP);
    const int r = i - pz * HP * WP;
    postab[i] = pz | (r / WP) << 10 | (r % WP) << 20;
  }
  {
    const int dz = tid / (a.th * a.tw);
    const int r = tid - dz * a.th * a.tw;
    rowtab[tid] = tid < rows ? dz | (r / a.tw) << 10 | (r % a.tw) << 20 : -1;
  }
  __syncthreads();
  if (a.resident) {
    for (int i = tid; i < a.nchunks * KROWS * WPIECES; i += blockDim.x) {
      const int krow = i / WPIECES, piece = i % WPIECES;
      cp_async16(smem_addr(wres + krow * PB + piece * 16), wtile + (size_t)krow * NT + piece * 8,
                 16);
    }
  }

  // this lane's row of each of the warp's two m16 tiles, as a brick offset
  int abase[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int at = max(rowtab[(warp * 2 + j) * 16 + (lane & 15)], 0);  // padding: row 0
    abase[j] = (((at & 1023) * HP + (at >> 10 & 1023)) * WP + (at >> 20)) * PA +
               (CK == 8 ? 0 : (lane >> 4) * 16);
  }
  const int boff = (lane & 15) * PB + (NT == 8 ? 0 : (lane >> 4) * 16);

  // epilogue vectors of this thread's columns: n * 8 + 2 * (lane & 3) + {0, 1}
  float sc[NF][2], sh[NF][2];
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int co = co0 + n * 8 + 2 * (lane & 3) + q;
      sc[n][q] = co < a.CO ? a.scale[co] : 0.f;
      sh[n][q] = co < a.CO ? a.shift[co] : 0.f;
    }
  const float slope = a.relu_mode == 2 ? a.alpha[0] : 0.f;

  const int my_bricks = (a.nbricks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nsteps = my_bricks * a.nchunks;

  const int64_t in_sample = (int64_t)a.D * a.H * a.W * a.C;
  const int64_t out_sample = (int64_t)a.D * a.H * a.W * a.CO;
  StepCursor load, work;  // the step being staged runs stages - 1 ahead of the one multiplied
  load.init(blockIdx.x, gridDim.x, a);
  work = load;
  int load_slot = 0, work_slot = 0;

  auto stage_step = [&](int step) {
    if (step < nsteps) {
      const int z0 = load.bz * a.td - 1, y0 = load.by * a.th - 1, x0 = load.bx * a.tw - 1;
      const __nv_bfloat16* sample = a.x + load.b * in_sample;
      const int chunk = load.chunk;
      const int c0 = chunk * CK;
      const uint32_t dst_a = smem_addr(ring + load_slot * stage_bytes);
      for (int i = tid; i < hp * APIECES; i += blockDim.x) {
        const int pos = i / APIECES, piece = i % APIECES;
        const int at = postab[pos];
        const int gz = z0 + (at & 1023), gy = y0 + (at >> 10 & 1023), gx = x0 + (at >> 20);
        const int c = c0 + piece * 8;
        const bool ok = (unsigned)gz < (unsigned)a.D && (unsigned)gy < (unsigned)a.H &&
                        (unsigned)gx < (unsigned)a.W && c < a.C;
        const __nv_bfloat16* src =
            ok ? sample + Layout::inner(gz, gy, gx, c, a.H, a.W, a.C) : a.x;
        cp_async16(dst_a + pos * PA + piece * 16, src, ok ? 16 : 0);
      }
      if (!a.resident) {
        const uint32_t dst_w = dst_a + a_bytes;
        const __nv_bfloat16* src_w = wtile + (size_t)chunk * KROWS * NT;
        for (int i = tid; i < KROWS * WPIECES; i += blockDim.x) {
          const int krow = i / WPIECES, piece = i % WPIECES;
          cp_async16(dst_w + krow * PB + piece * 16, src_w + (size_t)krow * NT + piece * 8, 16);
        }
      }
      load.advance(a);
      load_slot = load_slot + 1 == a.stages ? 0 : load_slot + 1;
    }
    cp_async_commit();  // one group per step, empty past the end: the waits count groups
  };

  for (int s = 0; s < a.stages - 1; ++s) stage_step(s);

  float acc[2][NF][4];
  for (int step = 0; step < nsteps; ++step) {
    if (a.stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step's data landed for everyone; slot (step - 1) is free
    stage_step(step + a.stages - 1);

    const int chunk = work.chunk;
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][n][q] = 0.f;
    }
    const uint32_t sa = smem_addr(ring + work_slot * stage_bytes);
    work_slot = work_slot + 1 == a.stages ? 0 : work_slot + 1;
    const uint32_t sw = (a.resident ? smem_addr(wres + chunk * w_bytes) : sa + a_bytes) + boff;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      int toff;
      if constexpr (CK == 8) {  // lanes 0-15 address tap 2 ks, lanes 16-31 tap 2 ks + 1
        toff = tapoff[2 * ks + (lane >> 4)];
      } else {
        toff = tapoff[ks / (CK / 16)] + (ks % (CK / 16)) * 32;
      }
      uint32_t bf[NF][2];
      if constexpr (NT == 8) {
        ldsm_x2_trans(sw + ks * 16 * PB, bf[0][0], bf[0][1]);
      } else {
#pragma unroll
        for (int n = 0; n < NF; n += 2)
          ldsm_x4_trans(sw + ks * 16 * PB + n * 16, bf[n][0], bf[n][1], bf[n + 1][0],
                        bf[n + 1][1]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t af[4];
        ldsm_x4(sa + abase[j] + toff, af);
#pragma unroll
        for (int n = 0; n < NF; ++n) mma_bf16(acc[j][n], af, bf[n]);
      }
    }

    const int z0 = work.bz * a.td, y0 = work.by * a.th, x0 = work.bx * a.tw;
    unsigned char* sample_out =
        static_cast<unsigned char*>(a.out) + work.b * out_sample * esize;
    work.advance(a);
    if (chunk != a.nchunks - 1) continue;

    // epilogue: accumulators -> this warp's shared rows -> whole channel vectors
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = j * 16 + (lane >> 2) + 8 * half;
          const int col = n * 8 + 2 * (lane & 3);
          const float y0v = activate(acc[j][n][2 * half] * sc[n][0] + sh[n][0], a.relu_mode, slope);
          const float y1v =
              activate(acc[j][n][2 * half + 1] * sc[n][1] + sh[n][1], a.relu_mode, slope);
          unsigned char* dst = my_out + row * PO + col * esize;
          if (a.out_bf16) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0v, y1v);
          } else {
            *reinterpret_cast<float2*>(dst) = make_float2(y0v, y1v);
          }
        }
    __syncwarp();
    const bool vec_ok = (a.CO * esize) % 16 == 0;
    const int per_row = vec_ok ? NT * esize / 16 : NT;  // pieces or single values
    const int per_piece = vec_ok ? 16 / esize : 1;      // channels in one
    for (int i = lane; i < 32 * per_row; i += 32) {
      const int row = i / per_row, piece = i % per_row;
      const int at = rowtab[warp * 32 + row];
      if (at < 0) break;  // rows ascend with i: only padding rows follow
      const int gz = z0 + (at & 1023), gy = y0 + (at >> 10 & 1023), gx = x0 + (at >> 20);
      const int co = co0 + piece * per_piece;
      if (gz >= a.D || gy >= a.H || gx >= a.W || co >= a.CO) continue;
      const unsigned char* src = my_out + row * PO + piece * per_piece * esize;
      unsigned char* dst = sample_out + Layout::inner(gz, gy, gx, co, a.H, a.W, a.CO) * esize;
      if (vec_ok) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else if (a.out_bf16) {
        *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
      } else {
        *reinterpret_cast<float*>(dst) = *reinterpret_cast<const float*>(src);
      }
    }
    __syncwarp();  // the rows are free for the next brick
  }
  cp_async_wait<0>();
}

template <typename Layout, int CK, int NT>
cudaError_t launch_mma_inst(const MmaArgs& a, int warps, int grid_x, int n_tiles,
                            int smem_bytes, cudaStream_t stream) {
  auto kernel = conv3_mma_kernel<Layout, CK, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, n_tiles), warps * 32, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// x, packed weights bf16; out bf16 or f32. (td, th, tw, warps, nt, ck, stages,
// resident, grid_x, smem_bytes) is the wrapper's plan (ops/fused_conv.py).
template <typename Layout>
int launch_conv3_mma(const void* x, const void* wp, const float* scale, const float* shift,
                     const float* alpha, int relu_mode, void* out, int B, int D, int H, int W,
                     int C, int CO, int out_bf16, int td, int th, int tw, int warps, int nt,
                     int ck, int stages, int resident, int grid_x, int smem_bytes,
                     void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (C % 8 || td < 1 || th < 1 || tw < 1 || td * th * tw > warps * 32 || warps < 1 ||
      warps > 8 || stages < 2 || stages > 3 || grid_x < 1)
    return invalid;
  if ((ck == 8) != (C == 8) || (ck != 8 && ck != 16 && ck != 32)) return invalid;
  MmaArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.scale = scale;
  a.shift = shift;
  a.alpha = alpha;
  a.out = out;
  a.relu_mode = relu_mode;
  a.out_bf16 = out_bf16;
  a.D = D, a.H = H, a.W = W, a.C = C, a.CO = CO;
  a.td = td, a.th = th, a.tw = tw;
  a.nbz = (D + td - 1) / td, a.nby = (H + th - 1) / th, a.nbx = (W + tw - 1) / tw;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  const long long sample = (long long)D * H * W * (C > CO ? C : CO);  // 32-bit offsets inside
  if (nbricks > 0x7fffffffLL || sample > 0x7fffffffLL) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.nchunks = (C + ck - 1) / ck;
  a.stages = stages;
  a.resident = resident;
  const int n_tiles = (CO + nt - 1) / nt;
  if (n_tiles > 65535 ||
      smem_bytes != mma_smem_bytes(ck, nt, td, th, tw, warps, a.nchunks, stages, resident, out_bf16))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEGK_MMA_CASE(CK_, NT_)                                                          \
  if (ck == CK_ && nt == NT_)                                                            \
    return static_cast<int>(                                                             \
        launch_mma_inst<Layout, CK_, NT_>(a, warps, grid_x, n_tiles, smem_bytes, s));
  SEGK_MMA_CASE(8, 8)
  SEGK_MMA_CASE(8, 16)
  SEGK_MMA_CASE(8, 32)
  SEGK_MMA_CASE(16, 8)
  SEGK_MMA_CASE(16, 16)
  SEGK_MMA_CASE(16, 32)
  SEGK_MMA_CASE(32, 8)
  SEGK_MMA_CASE(32, 16)
  SEGK_MMA_CASE(32, 32)
#undef SEGK_MMA_CASE
  return invalid;
}

}  // namespace segk
