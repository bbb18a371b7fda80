// Hopper body of the phase-space weight gradient (phase_conv_dw.cu) for bf16
// input with Ci in {8, 16, 32, 64} and Co = 8 or a multiple of 16; the rule
// (fused_conv.dw_body) gives it Ci >= 16: packed UNETR's four phase dw rows
// and the flagship's L = 128 (at L = 64, Ci = Co = 8, half of each m64 tile
// is padding rows and the tensor-core body stays faster).
//
// It replaces, with the other bodies of phase_conv_dw.cu, the Pallas kernels
// segmantic_tpu/ops/phase_gemm.py::_dw_kernel_folded and ::_dw_kernel
// (phase_conv_gemm_dw_folded_p, L = 64; phase_conv_gemm_dw_p, L >= 128)
// together with _unfold_dw: the result is the true (3, 3, 3, Ci, Co) kernel,
//   dw[t, ci, co] = sum_{b, v} d2s(p)[b, v + t - 1, ci] * d2s(g)[b, v, co]   (f32),
// and no (L, L) block reaches device memory.
//
// What bounds it on the card: at Ci = Co = 16 (p 48^3 x 128 at batch 8) the
// 453 MB of p and g take 0.135 ms and the true products 0.099 ms at peak, so
// both bytes and the tensor cores' rate matter. conv3_dw_mma.cuh ran these
// rows at 3.0-3.7x their bound: its ldmatrix of A per (tap, k16 step) made
// shared memory the pace, and its 16-byte cp.async staging through the
// depth-to-space map competed with the products for the memory pipeline.
// Here the tensors are read as they lie, in block space, by TMA, and every
// operand of the tensor cores is reused. What is left bounds it next: the
// staging of the g halo (3.3x the g brick at 2 x 6 x 8 bricks), about as long
// as the products on an H100 at p 48^3 x 128, and at Ci = 64 the re-staging
// by each of its six groups of tiles:
//
// - Staging. One block walks the bricks split, split + splits, ... of TD x
//   TH x TW block voxels. Per brick thread 0 brings, stages - 1 bricks ahead
//   of its warps, into a ring of `stages`, the brick of p (every 64-lane
//   chunk of its 8 Ci lanes a plane of 128-byte rows, no halo) and the brick
//   of g with a one-voxel halo (8 Co lanes, likewise), each one TMA load of
//   a 5-D box, 128-byte swizzled, zero outside the volume (encode_ndhwc).
// - Which products. A block voxel u of p holds the input phases a' = (a'z,
//   a'y, a'x) of full-resolution voxels 2u + a'; of g, the output phases a.
//   The pair (input phase a' at u, output phase a at u + e) has the tap
//   t = a' - a - 2 e + 1 per dimension, so for a given a' and tap the output
//   side is one (shift e, phase a) per dimension: (a + 2 e) = a' + 1 - t.
//   K is (block position, a'z, a'y): a k16 step is 16 brick positions in
//   (z, y, x) order, and each of four passes (a'z, a'y) takes as operand B
//   the run of p lanes (a'x, ci) of that (a'z, a'y), 2 Ci lanes contiguous
//   in a staged row (N = 2 Ci; a start inside the 128-byte row at Ci = 8 and
//   16, two chunks LBO apart at Ci = 64). The accumulator rows are (tz, ty,
//   x piece, co): z and y are summed over both input phases into the tap's
//   own accumulator, so the 7/8 structural zeros of the expanded kernel are
//   never multiplied and only x is kept in the lanes: a warp's x piece is
//   one of (e_x, a_x) = (0, 0), (0, 1), (-1, 1), (+1, 0), and its columns
//   a'x give tx = a'x + 1 - a_x - 2 e_x, half of them outside 0..2 for the
//   last two pieces (the only products wasted: 4/3 of the true count).
// - Operand A (g) from registers: each warp loads its 16 rows (co) x 16
//   positions with one ldmatrix.x4.trans from the staged g at the piece's
//   halo shift and lane offset (any shift, any phase: one row address a
//   lane), so one staged brick of g serves all 27 taps.
// - Tiles: a tile is (co chunk of 16, tz, ty) with the four warps' x pieces
//   as its 64 rows (Co = 8: rows 8-15 repeat 0-7 and are never stored); a
//   warpgroup takes TPW tiles, a block NWG warpgroups' worth (grid.y groups
//   of tiles). At N = 16, 32 and 64 a block is three warpgroups of three,
//   a group the 9 tiles of one co chunk (tz = warpgroup, ty = tile): a
//   warp's z piece is then fixed for a'z, and the six (pass a'y, tile)
//   products take only four y pieces, so a'z is one commit group of six
//   wgmma on four fragments. At N = 128 (Ci = 64) a warpgroup takes one tile
//   (three would not fit the registers) and a commit group is one pass
//   (past the last tile a warpgroup multiplies tile 0 again and stores
//   nothing). Either way two register sets: the next group's fragments load
//   while the current group runs (wait leaving one group in flight).
// - wgmma.mma_async m64nNk16, B MN-major by descriptor (the rows of a k16
//   step are consecutive 128-byte rows: SBO 1024 bytes), f32 in registers.
// - No producer warps: thread 0 issues the copies (a block of 13 warps would
//   put four on one quarter of the multiprocessor and cap a thread at 128
//   registers; 12 warps leave it 168, room for N = 64's 96 accumulators and
//   two sets of fragments). Its wait for a slot is a wait for every warp's
//   release of the brick before; on an H100 this cost 3-5% where the
//   registers were not short.
// - Deterministic without atomics: each block writes its partials to a
//   workspace [split][a'x][27][Ci][Co] (the two x pieces that reach one tap
//   are the two a'x) and dw_reduce_kernel (or dw_reduce_lanes_kernel) sums
//   the 2 x splits partials in a fixed order; a repeated launch is
//   bit-equal.
// Brick, tiles a warpgroup, warpgroups, ring depth and splits are the
// wrapper's plan (ops/fused_conv.py::phase_dw_plan); the launcher refuses a
// plan whose shared-memory sum differs from its own (phase_dw_smem_bytes).
#pragma once

#include "conv3_dw_mma.cuh"
#include "conv3_mid.cuh"

namespace segk {

// Brick positions at most: their halo rows sit in a table in the barrier block.
constexpr int PHASE_DW_MAX_ROWS = 192;

// NWG warpgroups, every warp a consumer; thread 0 issues the copies too.
__host__ __device__ constexpr int phase_dw_threads(int nwg) { return 128 * nwg; }

// D (m64 x n16, f32) += A (m64 x k16, registers) * B (k16 x n16, MN-major descriptor)
__device__ __forceinline__ void wgmma_rs_n16_mn(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n32, f32) += A (m64 x k16, registers) * B (k16 x n32, MN-major descriptor)
__device__ __forceinline__ void wgmma_rs_n32_mn(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "N = 2 Ci of 8, 16, 32, 64");
  if constexpr (N == 16) {
    wgmma_rs_n16_mn(d, a, db);
  } else if constexpr (N == 32) {
    wgmma_rs_n32_mn(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64<1>(d, a, db);
  } else {
    wgmma_rs_n128<1>(d, a, db);
  }
}

// One ring slot: Ci / 8 planes of the p brick (P rows of 128 bytes), Co / 8
// planes of the g halo, each rounded to the swizzle's period of 1024 bytes.
__host__ __device__ constexpr int phase_dw_slot_bytes(int ci, int co, int td, int th, int tw) {
  return ci / 8 * td * th * tw * 128 + co / 8 * round1024((td + 2) * (th + 2) * (tw + 2) * 128);
}

// 1024 bytes to align the base, 1024 of barriers and the halo-row table,
// `stages` slots. The wrapper's plan computes the same sum: the launcher
// refuses a mismatch.
__host__ __device__ constexpr int phase_dw_smem_bytes(int ci, int co, int td, int th, int tw,
                                                      int stages) {
  return 2048 + stages * phase_dw_slot_bytes(ci, co, td, th, tw);
}

struct PhaseDwArgs {
  float* part;  // [split][a'x][27][Ci][Co]
  int Ci, Co;   // true channels
  int td, th, tw;
  int nbz, nby, nbx, nbricks;  // over the block grid (D / 2, H / 2, W / 2)
  int ntiles;                  // 9 x co chunks of 16
  int stages;
};

template <int N, int TPW, int NWG>
__global__ void __launch_bounds__(phase_dw_threads(NWG), 1)
    conv3_phase_dw_kernel(const __grid_constant__ CUtensorMap tmp,
                          const __grid_constant__ CUtensorMap tmg, const PhaseDwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HP = a.th + 2, WP = a.tw + 2;
  const int P = a.td * a.th * a.tw;
  const int halo_rows = (a.td + 2) * HP * WP;
  const int nck_p = a.Ci >> 3, nck_g = a.Co >> 3;  // 64-lane chunks of 8 Ci / 8 Co lanes
  const int p_plane = P * 128;
  const int g_plane = round1024(halo_rows * 128);
  const int slot_bytes = nck_p * p_plane + nck_g * g_plane;
  const int S = a.stages;

  const uint32_t bars = smem_addr(smem);
  auto bar = [&](int i) { return bars + 8 * i; };  // full [0, S), empty [S, 2S)
  int* qtab = reinterpret_cast<int*>(smem + 256);  // brick position -> its g halo row
  const uint32_t ring0 = bars + 1024;
  const int split = blockIdx.x, group = blockIdx.y;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar(i), 1);
      mbar_init(bar(S + i), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int q = tid; q < P; q += blockDim.x) {
    const int qz = q / (a.th * a.tw), r = q - qz * a.th * a.tw;
    qtab[q] = ((qz + 1) * HP + r / a.tw + 1) * WP + r % a.tw + 1;
  }
  __syncthreads();

  // thread 0 also issues the copies: the brick S - 1 ahead of the one its
  // warps start, into the slot the warps left last (a wait for every warp's
  // release of the brick before)
  const uint32_t tx_bytes = (uint32_t)(nck_p * P + nck_g * halo_rows) * 128;
  int p_next = split, p_s = 0, p_ph = 0;
  auto produce = [&]() {
    if (p_next >= a.nbricks) return;
    int r = p_next;
    const int x0 = (r % a.nbx) * a.tw;
    r /= a.nbx;
    const int y0 = (r % a.nby) * a.th;
    r /= a.nby;
    const int z0 = (r % a.nbz) * a.td, b = r / a.nbz;
    mbar_wait(bar(S + p_s), p_ph ^ 1);
    mbar_expect_tx(bar(p_s), tx_bytes);
    const uint32_t slot = ring0 + p_s * slot_bytes;
    for (int c = 0; c < nck_p; ++c)
      tma_load_5d(slot + c * p_plane, &tmp, bar(p_s), 64 * c, x0, y0, z0, b);
    for (int c = 0; c < nck_g; ++c)
      tma_load_5d(slot + nck_p * p_plane + c * g_plane, &tmg, bar(p_s), 64 * c, x0 - 1, y0 - 1,
                  z0 - 1, b);
    if (++p_s == S) p_s = 0, p_ph ^= 1;
    p_next += gridDim.x;
  };
  if (tid == 0)
    for (int k = 0; k < S - 1; ++k) produce();

  {  // every warp multiplies
    const int wg = warp >> 2, w = warp & 3;
    const int krow = (lane & 7) + ((lane >> 4) << 3);  // ldmatrix.trans: this lane's k row
    const int cohi = a.Co >= 16 ? 8 * ((lane >> 3) & 1) : 0;  // and its 8 of the 16 co
    // the warp's x piece (e_x, a_x): (0, 0), (0, 1), (-1, 1), (+1, 0); tx = a'x + t0x
    const int ex = w == 2 ? -1 : (w == 3 ? 1 : 0);
    const int ax = (w == 1 || w == 2) ? 1 : 0;
    const int t0x = 1 - ax - 2 * ex;
    int tz[TPW], ty[TPW], co0[TPW];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      int t = (group * NWG + wg) * TPW + i;
      if (t >= a.ntiles) t = 0;  // multiplied again, never stored
      co0[i] = t / 9 * 16;
      tz[i] = t % 9 / 3;
      ty[i] = t % 3;
    }
    float acc[TPW][N / 2];
#pragma unroll
    for (int i = 0; i < TPW; ++i)
#pragma unroll
      for (int k = 0; k < N / 2; ++k) acc[i][k] = 0.f;

    const int HPWP = HP * WP;
    const int nks = P >> 4;
    uint32_t pbase = ring0, gbase = ring0;
    // operand B of pass (a'z, a'y) at k16 step ks: the run (a'x, ci) of p,
    // MN-major, the step's rows 1024 B per 8, the second 64-lane chunk (Ci =
    // 64) a plane on
    auto desc = [&](int ks, int apz, int apy) {
      constexpr int CI = N / 2;
      const int l0 = (apz * 4 + apy * 2) * CI;  // the run's first lane
      return desc_b128(pbase + (l0 >> 6) * p_plane + ks * 2048 + (l0 & 63) * 2, p_plane >> 4,
                       64);
    };
    // operand A: the 16 co x 16 positions of g at the piece (shift, phase)
    // whose halo row is hr and lane lo, by one ldmatrix.x4.trans
    auto ldsm = [&](int hr, int lo, uint32_t(&f)[4]) {
      ldsm_x4_trans(gbase + (lo >> 6) * g_plane + hr * 128 + ((((lo & 63) >> 3) ^ (hr & 7)) << 4),
                    f[0], f[1], f[2], f[3]);
    };

    if constexpr (TPW == 3 && NWG == 3) {
      // tz = wg, ty = i (a group: the 9 tiles of co chunk co0): per a'z the
      // warp's z piece is fixed and the three tiles of both passes a'y take
      // four y pieces, s = a'y + 1 - ty = -1 .. 2 (fragment s + 1), so one
      // commit group is a'z's two passes (6 wgmma) on four fragments
      int zoff[2], zlo[2];
#pragma unroll
      for (int apz = 0; apz < 2; ++apz) {
        const int sz = apz + 1 - wg;
        zoff[apz] = (sz >> 1) * HPWP + ex;
        zlo[apz] = ((sz & 1) * 4 + ax) * a.Co + co0[0] + cohi;
      }
      auto load = [&](int hr0, int apz, uint32_t(&f)[4][4]) {
#pragma unroll
        for (int k = 0; k < 4; ++k)  // s = k - 1: e_y = s >> 1, a_y = s & 1
          ldsm(hr0 + zoff[apz] + (k == 0 ? -WP : (k == 3 ? WP : 0)),
               zlo[apz] + ((k - 1) & 1) * 2 * a.Co, f[k]);
      };
      auto issue = [&](int ks, int apz, uint32_t(&f)[4][4]) {
#pragma unroll
        for (int i = 0; i < TPW; ++i) fence_acc(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int apy = 0; apy < 2; ++apy) {
          const uint64_t db = desc(ks, apz, apy);
#pragma unroll
          for (int i = 0; i < 3; ++i) wgmma_rs_mn<N>(acc[i], f[apy + 2 - i], db);
        }
        wgmma_commit();
      };
      uint32_t fa[4][4], fb[4][4];
      int s = 0, ph = 0;
      for (int brick = split; brick < a.nbricks; brick += gridDim.x) {
        if (tid == 0) produce();
        __syncwarp();
        mbar_wait(bar(s), ph);
        pbase = ring0 + s * slot_bytes;
        gbase = pbase + nck_p * p_plane;
        int hr0 = qtab[krow];
        load(hr0, 0, fa);
        for (int ks = 0; ks < nks; ++ks) {
          const int hr1 = qtab[(ks + 1 < nks ? 16 * (ks + 1) : 0) + krow];  // the next step's
          issue(ks, 0, fa);
          wgmma_wait<1>();  // the group before retired: its fragments (fb) are free
          keep_live(fb);
          load(hr0, 1, fb);
          issue(ks, 1, fb);
          wgmma_wait<1>();
          keep_live(fa);
          if (ks + 1 < nks) load(hr1, 0, fa);
          hr0 = hr1;
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < TPW; ++i) fence_acc(acc[i]);
        keep_live(fa);
        keep_live(fb);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(S + s));
        if (++s == S) s = 0, ph ^= 1;
      }
    } else {
      // one commit group a pass (a'z, a'y) = (pass / 2, pass % 2): TPW wgmma;
      // the next pass's fragments load while it runs
      auto load = [&](int hr0, int pass, uint32_t(&f)[TPW][4]) {
        const int apz = pass >> 1, apy = pass & 1;
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const int sz = apz + 1 - tz[i], sy = apy + 1 - ty[i];  // a + 2 e per dimension
          ldsm(hr0 + (sz >> 1) * HPWP + (sy >> 1) * WP + ex,
               ((sz & 1) * 4 + (sy & 1) * 2 + ax) * a.Co + co0[i] + cohi, f[i]);
        }
      };
      auto issue = [&](int ks, int pass, uint32_t(&f)[TPW][4]) {
#pragma unroll
        for (int i = 0; i < TPW; ++i) fence_acc(acc[i]);
        wgmma_fence();
        const uint64_t db = desc(ks, pass >> 1, pass & 1);
#pragma unroll
        for (int i = 0; i < TPW; ++i) wgmma_rs_mn<N>(acc[i], f[i], db);
        wgmma_commit();
      };
      uint32_t fa[TPW][4], fb[TPW][4];
      int s = 0, ph = 0;
      for (int brick = split; brick < a.nbricks; brick += gridDim.x) {
        if (tid == 0) produce();
        __syncwarp();
        mbar_wait(bar(s), ph);
        pbase = ring0 + s * slot_bytes;
        gbase = pbase + nck_p * p_plane;
        int hr0 = qtab[krow];
        load(hr0, 0, fa);
        for (int ks = 0; ks < nks; ++ks) {
          const int hr1 = qtab[(ks + 1 < nks ? 16 * (ks + 1) : 0) + krow];  // the next step's
#pragma unroll
          for (int pass = 0; pass < 4; pass += 2) {  // fa at even passes, fb at odd
            issue(ks, pass, fa);
            wgmma_wait<1>();  // the pass before retired: its fragments (fb) are free
            keep_live(fb);
            load(hr0, pass + 1, fb);
            issue(ks, pass + 1, fb);
            wgmma_wait<1>();
            keep_live(fa);
            if (pass + 2 < 4) {
              load(hr0, pass + 2, fa);
            } else if (ks + 1 < nks) {
              load(hr1, 0, fa);
            }
          }
          hr0 = hr1;
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < TPW; ++i) fence_acc(acc[i]);
        keep_live(fa);
        keep_live(fb);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(S + s));
        if (++s == S) s = 0, ph ^= 1;
      }
    }

    // accumulator (row g + 8 half: co; columns 8 j + 2 t4, + 1: (a'x, ci), (a'x, ci + 1))
    const int g8 = lane >> 2, t4 = lane & 3;
    const long long n_out = 27LL * a.Ci * a.Co;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if ((group * NWG + wg) * TPW + i >= a.ntiles) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int co = co0[i] + g8 + 8 * half;
        if ((half && a.Co < 16) || co >= a.Co) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const int apx = col / a.Ci, ci = col - apx * a.Ci;
          const int tx = t0x + apx;
          if (tx < 0 || tx > 2) continue;
          const int tap = (tz[i] * 3 + ty[i]) * 3 + tx;
          float* dst = a.part + (2LL * split + apx) * n_out + (long long)tap * a.Ci * a.Co;
          dst[(long long)ci * a.Co + co] = acc[i][4 * j + 2 * half];
          dst[(long long)(ci + 1) * a.Co + co] = acc[i][4 * j + 2 * half + 1];
        }
      }
    }
  }
}

template <int N, int TPW, int NWG>
cudaError_t launch_phase_dw_inst(const CUtensorMap& tmp, const CUtensorMap& tmg,
                                 const PhaseDwArgs& a, dim3 grid, int smem_bytes,
                                 cudaStream_t stream) {
  auto kernel = conv3_phase_dw_kernel<N, TPW, NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, phase_dw_threads(NWG), smem_bytes, stream>>>(tmp, tmg, a);
  return cudaGetLastError();
}

// p (B, D/2, H/2, W/2, 8 Ci) and g (B, D/2, H/2, W/2, 8 Co) bf16, phase-major;
// D, H, W the full-resolution (even) extents; ws holds 2 * splits * 27 * Ci *
// Co floats; out (3, 3, 3, Ci, Co) f32. (td, th, tw, tpw, nwg, splits,
// stages, smem_bytes) is the wrapper's plan (ops/fused_conv.py::phase_dw_plan).
inline int launch_conv3_phase_dw(const void* p, const void* g, float* ws, float* out, int B,
                                 int D, int H, int W, int Ci, int Co, int td, int th, int tw,
                                 int tpw, int nwg, int splits, int stages, int smem_bytes,
                                 void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const int P = td * th * tw;
  if ((Ci != 8 && Ci != 16 && Ci != 32 && Ci != 64) || (Co != 8 && (Co < 16 || Co % 16)) ||
      D % 2 || H % 2 || W % 2 || td < 1 || th < 1 || tw < 1 || td + 2 > 256 || th + 2 > 256 ||
      tw + 2 > 256 || P % 16 || P > PHASE_DW_MAX_ROWS || stages < 2 || stages > 4 || splits < 1)
    return invalid;
  PhaseDwArgs a;
  a.part = ws;
  a.Ci = Ci, a.Co = Co;
  a.td = td, a.th = th, a.tw = tw;
  const int D2 = D / 2, H2 = H / 2, W2 = W / 2;
  a.nbz = (D2 + td - 1) / td, a.nby = (H2 + th - 1) / th, a.nbx = (W2 + tw - 1) / tw;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  if (nbricks > 0x7fffffffLL || splits > nbricks) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.ntiles = 9 * ((Co + 15) / 16);
  a.stages = stages;
  const int groups = (a.ntiles + nwg * tpw - 1) / (nwg * tpw);
  if (splits > 65535 || smem_bytes != phase_dw_smem_bytes(Ci, Co, td, th, tw, stages) ||
      smem_bytes > 232448)
    return invalid;
  CUtensorMap tmp, tmg;
  if (!encode_ndhwc(&tmp, p, B, D2, H2, W2, 8 * Ci, td, th, tw) ||
      !encode_ndhwc(&tmg, g, B, D2, H2, W2, 8 * Co, td + 2, th + 2, tw + 2))
    return invalid;
  const dim3 grid(splits, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const int n = 2 * Ci;
#define SEGK_PHASE_DW_CASE(N_, TPW_, NWG_)                                                \
  if (n == N_ && tpw == TPW_ && nwg == NWG_)                                              \
    err = launch_phase_dw_inst<N_, TPW_, NWG_>(tmp, tmg, a, grid, smem_bytes, s);
  SEGK_PHASE_DW_CASE(16, 3, 3)
  SEGK_PHASE_DW_CASE(32, 3, 3)
  SEGK_PHASE_DW_CASE(64, 3, 3)
  SEGK_PHASE_DW_CASE(128, 1, 3)
#undef SEGK_PHASE_DW_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nout = 27LL * Ci * Co;
  const int parts = 2 * splits;  // two partials a split: a'x = 0 and 1
  if (parts < 16) {
    dw_reduce_kernel<<<(unsigned)((nout + 255) / 256), 256, 0, s>>>(ws, out, nout, parts);
  } else {
    dw_reduce_lanes_kernel<<<(unsigned)((nout + 31) / 32), 256, 0, s>>>(ws, out, nout, parts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk
