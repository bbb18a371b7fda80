// Hopper body of the phase-space stride-1 SAME 3x3x3 convolution
// (phase_conv.cu) for bf16 input with Ci = Co = 8 (L = 64 lanes, the
// flagship's top decoder stage, 96^3 x 8) or Ci = Co = 16 (L = 128: the
// flagship's 48^3 x 16 stage and packed UNETR's 96^3 x 16 stage); forward and
// input gradient (the same conv with flipped, swapped weights).
//
// It replaces, with the other bodies of phase_conv.cu, the Pallas kernels
// segmantic_tpu/ops/phase_gemm.py::_fwd_kernel_folded (phase_conv_gemm_folded_p,
// L = 64, line 266) and ::_fwd_kernel (phase_conv_gemm_p, L >= 128, line 327).
// The result is the phase-major tensor of conv3_SAME(d2s(p), w) with the
// fused_conv epilogue (scale, shift, none / relu / prelu).
//
// What bounds it on the card: bytes. At L = 64 and batch 4, p and the output
// are 113 MB (0.034 ms at 3.35 TB/s) against 12.2 GFLOP of true products
// (0.012 ms at 989 TFLOP/s); at L = 128, 28 MB against 6.1 GFLOP. Once the
// products are expanded so that the tensor cores see dense tiles (below:
// 3.56x at L = 64, 1.78x at L = 128) both sit near the ridge. conv3_mma.cuh
// ran these rows at 3.4-4.7x their bound: it walks the full-resolution grid
// with N = Co = 8 or 16, so every ldmatrix of A feeds one m16n8k16 (0.25
// bytes of shared memory a multiply-add at N = 8), and its 16-byte cp.async
// staging through the depth-to-space map ran beside the products. Here:
//
// - Block space. A block voxel u of p holds the input phases a' of the
//   full-resolution voxels 2u + a'. Output phase a (per axis) at tap t reads
//   2u + a + t - 1 = 2(u + e) + a': per axis four (shift e, input phase a')
//   pairs serve both output phases, P0 = (-1, 1), P1 = (0, 0), P2 = (0, 1),
//   P3 = (+1, 0); output phase 0 reads P0-P2, phase 1 P1-P3, tap t = 2e + a'
//   - a + 1. So the GEMM is M = block voxels, K = (pair, ci), N = (output
//   phases, co) = 64: at L = 64 all 8 output phases; at L = 128 the 4 (ay,
//   ax) phases of the block's output z phase az = blockIdx.y and the 3 z pairs
//   az reads (1.78x the true products: the weights of all 8 phases, 256 KB,
//   fit no block).
// - Operand A by descriptor, straight from the staged brick: a k16 step is 32
//   bytes of each M row's 128-byte row, K-major and 128-byte swizzled as the
//   TMA wrote it. A brick, the M of a wgmma, is 8 x 8 block voxels of one z
//   plane (8 rows of 8 consecutive x, the rows of a line 128 bytes apart and
//   the lines the halo's row pitch apart: SBO), so a pair's shift is a start
//   moved by whole rows and its input phase a start 32 bytes into the row
//   (both read right on an H100 with base offset 0, probe_mid_wgmma.py). At L
//   = 128 a pair's 16 ci are those 32 bytes; at L = 64 a k16 step is the two
//   input phases a'x = 0, 1 of one (a'z, a'y) at one shift, whole at ex = 0
//   and half structural zeros at ex = -1 and +1 (48 k16 steps for 32: 3.56x
//   the true products). A from registers (ldmatrix, wgmma's RS form) ran at
//   ~80 cycles a m64n64k16 a multiprocessor with two warpgroups; both
//   operands by descriptor at ~30 (probe_mid_wgmma.py, probe_phase_fwd.py).
// - Staging: the producer warp brings each brick's halo in block space by
//   one TMA load of a 5-D box a 64-lane plane, 128-byte swizzled, zero
//   outside the volume (SAME padding and ragged edges), into a ring of
//   `stages` slots: 128-byte rows, the rate probe_mid_wgmma.py measured at
//   33.7 bytes a cycle a multiprocessor. At L = 64 the one plane with a z
//   halo of one plane each side; at L = 128 each of the two planes (a'z = 0,
//   1) only along the z shifts the block's az reads (one side or none: 1.5
//   planes of halo for 4).
// - Operand B: the packed weights (ops/fused_conv.py::pack_weights_phase:
//   per 64 k a tile of N rows x 128 bytes, K-major and 128-byte swizzled, the
//   structural zeros where a pair's tap does not exist for an output phase)
//   come once per block by one bulk copy and stay resident (96 KB).
// - wgmma.mma_async m64n64k16, both operands by descriptor, f32 in
//   registers: a brick's 48 k16 steps, straight-line from fence to commit,
//   one commit group.
// - Warpgroups: each of the two consumer warpgroups takes its own bricks
//   (bricks wg, wg + 2, ... of the block's walk over bricks blockIdx.x + k
//   gridDim.x), and they take turns to issue (brick k's wgmma after brick k -
//   1's, two named barriers), so the tensor cores run one warpgroup's
//   products while the other waits for its slot and runs its epilogue;
//   issued together, they ended their bricks together and their epilogues
//   and stores left the tensor cores idle (probe_phase_fwd.py --variants).
//   One producer warp (lane 0 issues the copies) keeps the ring full in
//   brick order. What bounds it now is shared memory: A and B are 4 KB a
//   m64n64k16, 128 bytes a cycle at the tensor cores' 32 cycles, and a
//   brick's wgmma alone ran at ~35 cycles each on an H100.
// - Epilogue from the accumulator layout: scale and shift of the true
//   channel (tiled over the phases), none / relu / prelu, bf16 or f32 pairs
//   at the voxel's lane offset. No atomics and a fixed summation order: a
//   repeated launch is bit-equal.
// Ring depth and grid are the wrapper's plan (ops/fused_conv.py::
// phase_fwd_plan); the launcher refuses a plan whose shared-memory sum
// differs from its own (phase_fwd_smem_bytes).
#pragma once

#include "conv3_mid.cuh"

namespace segk {

constexpr int PHASE_FWD_N = 64;       // a wgmma's N: 8 phases x 8 co, or 4 phases x 16 co
constexpr int PHASE_FWD_KSTEPS = 48;  // k16 steps a brick: 16 (z, y) pairs x 3 x shifts (L = 64)
                                      // or 3 x 16 pairs (L = 128)
constexpr int PHASE_FWD_W_BYTES = PHASE_FWD_KSTEPS / 4 * PHASE_FWD_N * 128;  // 96 KB
constexpr int PHASE_FWD_NWG = 2;  // consumer warpgroups
constexpr int PHASE_FWD_HP = 10, PHASE_FWD_WP = 10;  // a brick's halo: 10 x 10 rows a z plane

// the consumer warpgroups, then the producer warp
constexpr int PHASE_FWD_THREADS = 128 * PHASE_FWD_NWG + 32;
// blocks along N: L = 128 splits N by the output z phase az
__host__ __device__ constexpr int phase_fwd_groups(int ci) { return ci == 8 ? 1 : 2; }
// z planes of a 64-lane plane's staged box: L = 64 three (the brick's and
// one each side); L = 128 one (plane 0 at az = 0, plane 1 at az = 1) or two
// (the other): a halo plane on the side az reads from it
__host__ __device__ constexpr int phase_fwd_depth(int ci, int plane, int az) {
  return ci == 8 ? 3 : (plane != az ? 2 : 1);
}
__host__ __device__ constexpr int phase_fwd_plane_bytes(int ci, int plane, int az) {
  return round1024(phase_fwd_depth(ci, plane, az) * PHASE_FWD_HP * PHASE_FWD_WP * 128);
}
// one ring slot: the planes of the halo brick, each rounded to the swizzle's period
__host__ __device__ constexpr int phase_fwd_slot_bytes(int ci) {
  return ci == 8 ? phase_fwd_plane_bytes(8, 0, 0)
                 : phase_fwd_plane_bytes(16, 0, 0) + phase_fwd_plane_bytes(16, 1, 0);
}
// k16 step st: L = 64 st = (pz * 4 + py) * 3 + ex + 1, the input phases
// (a'z, a'y, a'x = 0 and 1) of pairs (pz, py) at x shift ex; L = 128 st =
// ((pz - az) * 4 + py) * 4 + px, the 16 ci of pair (pz, py, px). A per-axis
// pair p is shift e = ((p + 1) >> 1) - 1 and input phase a' = 1 - (p & 1).
// A's start in a slot, bytes: its plane, its row (the brick's first voxel at
// the shift, in a box that starts zs z planes from the brick) and its 32
// bytes in the row.
__host__ __device__ constexpr int phase_fwd_a_offset(int ci, int st, int az) {
  int pz = 0, py = 0, ex = 0, unit = 0;  // unit: the step's 32 bytes among the voxel's L / 16
  if (ci == 8) {
    pz = st / 12, py = st / 3 % 4, ex = st % 3 - 1;
    unit = (1 - (pz & 1)) * 2 + 1 - (py & 1);
  } else {
    const int px = st & 3;
    pz = st / 16 + az, py = st / 4 % 4, ex = ((px + 1) >> 1) - 1;
    unit = ((1 - (pz & 1)) * 2 + 1 - (py & 1)) * 2 + 1 - (px & 1);
  }
  const int ez = ((pz + 1) >> 1) - 1, ey = ((py + 1) >> 1) - 1;
  const int plane = unit >> 2;
  const int zs = ci == 8 ? -1 : (plane == 1 && az == 0 ? -1 : 0);  // the box's first z
  return (plane ? phase_fwd_plane_bytes(ci, 0, az) : 0) +
         (((ez - zs) * PHASE_FWD_HP + 1 + ey) * PHASE_FWD_WP + 1 + ex) * 128 + (unit & 3) * 32;
}
// 1024 bytes to align the base, 1024 of barriers, the resident weights,
// `stages` slots. The wrapper's plan computes the same sum: the launcher
// refuses a mismatch.
__host__ __device__ constexpr int phase_fwd_smem_bytes(int ci, int stages) {
  return 2048 + PHASE_FWD_W_BYTES + stages * phase_fwd_slot_bytes(ci);
}

struct PhaseFwdArgs {
  const float* scale;
  const float* shift;
  const float* alpha;
  void* out;  // (B, D2, H2, W2, 8 Co) phase-major
  int relu_mode, out_bf16;
  int D2, H2, W2;  // the block grid
  int nby, nbx, nbricks;
  int stages;
};

// the two consumer warpgroups take turns to issue: named barrier 1 + wg is
// warpgroup wg's turn (the other's 128 threads arrive, its own sync); each a
// predicated instruction, no branch (a branch between a wgmma and its wait
// serializes them)
__device__ __forceinline__ void turn_wait(int wg, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p bar.sync %0, 256;\n}\n" ::"r"(1 + wg),
               "r"((int)on)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p bar.arrive %0, 256;\n}\n" ::"r"(2 - wg),
               "r"((int)on)
               : "memory");
}

template <int CI>
__global__ void __launch_bounds__(PHASE_FWD_THREADS, 1)
    conv3_phase_fwd_kernel(const __grid_constant__ CUtensorMap tm0,
                           const __grid_constant__ CUtensorMap tm1,
                           const __nv_bfloat16* __restrict__ wp, const PhaseFwdArgs a) {
  constexpr int CO = CI;
  constexpr int NPL = CI / 8;  // 64-lane planes of p
  constexpr int HP = PHASE_FWD_HP, WP = PHASE_FWD_WP, NWG = PHASE_FWD_NWG;
  constexpr int SLOT = phase_fwd_slot_bytes(CI);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.stages;
  const int az = blockIdx.y;  // L = 128: the output z phase of the block's N

  const uint32_t bars = smem_addr(smem);
  auto bar = [&](int i) { return bars + 8 * i; };  // full [0, S), empty [S, 2S), weights 2S
  const uint32_t wsm = bars + 1024;
  const uint32_t ring0 = wsm + PHASE_FWD_W_BYTES;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar(i), 1);
      mbar_init(bar(S + i), 4);  // the four warps of the brick's warpgroup
    }
    mbar_init(bar(2 * S), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // brick k of the block's walk: blockIdx.x + k gridDim.x, 1 x 8 x 8 block
  // voxels at (b, z0, y0, x0)
  auto origin = [&](int brick, int& b, int& z0, int& y0, int& x0) {
    x0 = (brick % a.nbx) * 8;
    brick /= a.nbx;
    y0 = (brick % a.nby) * 8;
    brick /= a.nby;
    z0 = brick % a.D2;
    b = brick / a.D2;
  };
  const int nk = (a.nbricks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (warp == 4 * NWG) {  // the producer warp: lane 0 issues the copies
    if (lane == 0) {
      mbar_expect_tx(bar(2 * S), PHASE_FWD_W_BYTES);
      bulk_load(wsm, reinterpret_cast<const unsigned char*>(wp) + (size_t)az * PHASE_FWD_W_BYTES,
                PHASE_FWD_W_BYTES, bar(2 * S));
      uint32_t tx = 0;
#pragma unroll
      for (int c = 0; c < NPL; ++c) tx += phase_fwd_depth(CI, c, az) * HP * WP * 128;
      for (int k = 0; k < nk; ++k) {
        int b, z0, y0, x0;
        origin(blockIdx.x + k * gridDim.x, b, z0, y0, x0);
        const int s = k % S;
        mbar_wait(bar(S + s), ((k / S) & 1) ^ 1);
        mbar_expect_tx(bar(s), tx);
        const uint32_t slot = ring0 + s * SLOT;
        if (CI == 8) {
          tma_load_5d(slot, &tm0, bar(s), 0, x0 - 1, y0 - 1, z0 - 1, b);
        } else {  // tm0: boxes of one z plane, tm1: two
          tma_load_5d(slot, az == 0 ? &tm0 : &tm1, bar(s), 0, x0 - 1, y0 - 1, z0, b);
          tma_load_5d(slot + phase_fwd_plane_bytes(CI, 0, az), az == 0 ? &tm1 : &tm0,
                      bar(s), 64, x0 - 1, y0 - 1, z0 - (az == 0 ? 1 : 0), b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: the block's bricks k = wg, wg + 2, ..., issued in
  // turn with the other warpgroup (brick k after brick k - 1), so that the
  // tensor cores run one warpgroup's products while the other waits for its
  // slot and runs its epilogue
  const int wg = warp >> 2, w = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  // scale and shift of the column pair 8 j + 2 t4: true channel (8 j + 2 t4) % CO
  float sc[2][2], sh[2][2];
#pragma unroll
  for (int jp = 0; jp < 2; ++jp)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int co = (8 * jp + 2 * t4 + k) % CO;
      sc[jp][k] = a.scale[co];
      sh[jp][k] = a.shift[co];
    }
  const float slope = a.relu_mode == 2 ? a.alpha[0] : 0.f;
  constexpr uint32_t SBO = WP * 128 / 16;  // the lines of a slab: the halo's row pitch
  const uint64_t db0 = desc_b128(wsm, 1, 64);

  float acc[PHASE_FWD_N / 2];
  mbar_wait(bar(2 * S), 0);  // the resident weights
  for (int k = wg; k < nk; k += NWG) {
    const int s = k % S;
    mbar_wait(bar(s), (k / S) & 1);
    turn_wait(wg, k > 0);  // brick k - 1's products are issued
#pragma unroll
    for (int n = 0; n < PHASE_FWD_N / 2; ++n) acc[n] = 0.f;
    // the descriptors of step st: the slot's and the weights' start moved by
    // constants (16-byte units in the start field)
    const uint64_t da0 = desc_b128(ring0 + s * SLOT, 1, SBO);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < PHASE_FWD_KSTEPS; ++st) {
      const int off = az ? phase_fwd_a_offset(CI, st, 1) : phase_fwd_a_offset(CI, st, 0);
      const uint64_t db = db0 + (((st >> 2) * PHASE_FWD_N * 128 + (st & 3) * 32) >> 4);
      wgmma_ss_n64(acc, da0 + (off >> 4), db);
    }
    wgmma_commit();
    turn_pass(wg, k + 1 < nk);  // brick k + 1 may issue
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(S + s));

    // epilogue: accumulator (row g8 + 8 half, columns 8 j + 2 t4, + 1) of
    // each n8 piece; row r is voxel (y, x) = (r / 8, r % 8) of the brick;
    // column n is output lane n (L = 64) or 64 az + n
    int b, z0, y0, x0;
    origin(blockIdx.x + k * gridDim.x, b, z0, y0, x0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * w + g8 + 8 * half;
      const int gy = y0 + (r >> 3), gx = x0 + (r & 7);
      if (gy >= a.H2 || gx >= a.W2) continue;
      const long long base =
          ((((long long)b * a.D2 + z0) * a.H2 + gy) * a.W2 + gx) * (8 * CO) + az * 64 + 2 * t4;
#pragma unroll
      for (int j = 0; j < PHASE_FWD_N / 8; ++j) {
        const int jp = CO == 16 ? (j & 1) : 0;
        const float v0 =
            activate(acc[4 * j + 2 * half] * sc[jp][0] + sh[jp][0], a.relu_mode, slope);
        const float v1 =
            activate(acc[4 * j + 2 * half + 1] * sc[jp][1] + sh[jp][1], a.relu_mode, slope);
        if (a.out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + base + 8 * j) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + 8 * j) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

template <int CI>
cudaError_t launch_phase_fwd_inst(const CUtensorMap& tm0, const CUtensorMap& tm1,
                                  const __nv_bfloat16* wp, const PhaseFwdArgs& a, dim3 grid,
                                  int smem_bytes, cudaStream_t stream) {
  auto kernel = conv3_phase_fwd_kernel<CI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, PHASE_FWD_THREADS, smem_bytes, stream>>>(tm0, tm1, wp, a);
  return cudaGetLastError();
}

// p bf16 (B, D/2, H/2, W/2, 8 C) phase-major with D, H, W the full-resolution
// (even) extents; packed weights (pack_weights_phase); out bf16 or f32
// (B, D/2, H/2, W/2, 8 CO). (grid_x, stages, smem_bytes) is the wrapper's
// plan (ops/fused_conv.py::phase_fwd_plan); a brick is 1 x 8 x 8 block
// voxels, a slot a warpgroup at least.
inline int launch_conv3_phase_fwd(const void* p, const void* wp, const float* scale,
                                  const float* shift, const float* alpha, int relu_mode,
                                  void* out, int B, int D, int H, int W, int C, int CO,
                                  int out_bf16, int grid_x, int stages, int smem_bytes,
                                  void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if ((C != 8 && C != 16) || CO != C || D % 2 || H % 2 || W % 2 || stages < PHASE_FWD_NWG ||
      stages > 8 || grid_x < 1)
    return invalid;
  PhaseFwdArgs a;
  a.scale = scale, a.shift = shift, a.alpha = alpha;
  a.out = out;
  a.relu_mode = relu_mode, a.out_bf16 = out_bf16;
  a.D2 = D / 2, a.H2 = H / 2, a.W2 = W / 2;
  a.nby = (a.H2 + 7) / 8, a.nbx = (a.W2 + 7) / 8;
  const long long nbricks = (long long)B * a.D2 * a.nby * a.nbx;
  if (nbricks > 0x7fffffffLL || grid_x > nbricks) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.stages = stages;
  if (smem_bytes != phase_fwd_smem_bytes(C, stages) || smem_bytes > 232448) return invalid;
  // C = 8: one map, boxes of 3 z planes; C = 16: boxes of 1 and 2
  CUtensorMap tm0, tm1;
  if (!encode_ndhwc(&tm0, p, B, a.D2, a.H2, a.W2, 8 * C, C == 8 ? 3 : 1, PHASE_FWD_HP,
                    PHASE_FWD_WP) ||
      !encode_ndhwc(&tm1, p, B, a.D2, a.H2, a.W2, 8 * C, 2, PHASE_FWD_HP, PHASE_FWD_WP))
    return invalid;
  const dim3 grid(grid_x, phase_fwd_groups(C));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wp);
  return static_cast<int>(C == 8 ? launch_phase_fwd_inst<8>(tm0, tm1, w, a, grid, smem_bytes, s)
                                 : launch_phase_fwd_inst<16>(tm0, tm1, w, a, grid, smem_bytes, s));
}

}  // namespace segk
