// Deep-channel body of the dense stride-1 SAME 3x3x3 convolution kernel
// (fused_conv.cu) for bf16 input with C, CO >= 64: the 12^3 / 24^3 convs of
// UNETR and the 6^3 / 12^3 stages of the flagship UNet, forward and input
// gradient (the same conv with flipped weights). The helpers here (mbarriers,
// TMA, wgmma) serve the weight-gradient body of conv3_dw_wgmma.cuh as well.
//
// It replaces, with conv3_mma.cuh, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_kernel (conv3d_packed_p) at these
// shapes. The conv is an implicit GEMM: M = output positions, N = CO,
// K = 27 taps x C, f32 accumulation. At 64-256 channels it is bound by
// operations (12^3 x 256 -> 128 at batch 8: 24.5 GFLOP against 6 MB), so the
// design is about the tensor cores' rate, which on Hopper only wgmma reaches:
//
// - One block: NWG = 2 or 3 consumer warpgroups and a producer warpgroup
//   (one thread of it issues the copies). The block owns a brick of TD x TH
//   x TW output positions (its M rows, flattened z, y, x; up to 64 * NWG *
//   SPW), an N tile of NT = 64 or 128 output channels (so a staged halo is
//   read by one or two N tiles, not by 4-16 of 8-32 as in conv3_mma.cuh) and
//   a range of K blocks. Each consumer warpgroup multiplies SPW slabs of 64
//   rows; every weight tile feeds all of the block's rows. Three warpgroups
//   (192-row bricks) won at the flagship's 12^3 x 64 at batch 4 and at
//   UNETR's 24^3 x 64 -> 128 input gradient, where two lost ground.
// - A K block is one tap of one chunk of 64 input channels, in the order
//   chunk, tap. Per chunk the producer brings the brick's halo, 64 channels
//   of (TD+2)(TH+2)(TW+2) positions, by one TMA load of a 5-D box of the
//   NDHWC tensor (SAME padding, ragged edges and channel padding are the
//   TMA's zero fill), 128-byte swizzled, into a ring of two; per K block it
//   brings the (tap, chunk) tile of the packed weights (ops/fused_conv.py::
//   pack_weights_deep: NT rows x 64 k, already in the 128-byte-swizzled
//   K-major order a wgmma descriptor reads) by one 1-D cp.async.bulk into a
//   ring of `stages`. Full and empty mbarriers count both rings.
// - Operand A comes from registers: each consumer warp loads its 16 rows x
//   16 k with ldmatrix from the halo at the tap's offset (the wgmma register
//   fragment of rows 16w..16w+15 is mma.sync's A fragment), so the 27
//   tap-shifted windows stay address arithmetic on one staged brick. The
//   swizzle puts 8 consecutive positions on 8 distinct bank groups.
// - wgmma.mma_async m64nNTk16 with B by descriptor, one commit group per K
//   block. The A fragments of the next K block load while a group runs (two
//   register sets, one group left in flight), and a weight slot is released
//   once the group that read it has retired.
// - Split-K: where bricks x N tiles cannot fill the card (6^3, 12^3 at
//   batch 4), blocks split the K blocks; each writes f32 partials to a
//   workspace [split][position][CO] and a second kernel sums them in split
//   order and applies the epilogue after the whole sum: a repeated launch is
//   bit-equal.
// - Epilogue from the accumulator layout: scale, shift and none / relu /
//   prelu, stored as channel pairs in bf16 or f32.
// Brick, N tile, slabs, ring depth and splits are the wrapper's plan
// (ops/fused_conv.py::deep_plan); the launcher refuses a plan whose
// shared-memory sum differs from its own (wgmma_smem_bytes). The launch
// bound leaves ptxas 168 registers a thread at two consumer warpgroups and
// 128 at three, setmaxnreg or not, so the instances are those whose
// accumulators and two sets of A fragments fit without spills: NT x SPW x
// NWG = 64 x 1 x 2, 64 x 2 x 2, 128 x 1 x 2, 64 x 1 x 3, 128 x 1 x 3.
// setmaxnreg still hands the producer warpgroup's registers to the
// consumers. (At 256 threads, thread 0 issuing the copies between its own
// steps, ptxas allowed 255 registers, but the consumers stalled on the
// refills and the body ran slower.)
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder itself is reached through the runtime

#include "conv3_mma.cuh"

namespace segk {

// NWG consumer warpgroups (2 or 3), then the producer warpgroup.
__host__ __device__ constexpr int wgmma_threads(int nwg) { return 128 * (nwg + 1); }

// ---- host: libcuda's tensor-map encoder, reached through the runtime (no link flag)

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map of a bf16 (B, D, H, W, C) tensor whose box is 64 channels x bw x
// bh x bd positions of one sample, 128-byte swizzled (64 channels = one
// 128-byte row); out-of-range elements of a box arrive as zeros.
inline bool encode_ndhwc(CUtensorMap* map, const void* base, int B, int D, int H, int W, int C,
                         int bd, int bh, int bw) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)C * 2;
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  const cuuint32_t box[5] = {64, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bd, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__host__ __device__ constexpr int round1024(int n) { return (n + 1023) / 1024 * 1024; }

// One staged halo: 64 channels (128 bytes) of each of the brick's halo positions.
__host__ __device__ constexpr int wgmma_halo_bytes(int td, int th, int tw) {
  return round1024((td + 2) * (th + 2) * (tw + 2) * 128);
}

// 1024 bytes to align the base to the swizzle's period, 1024 of barriers,
// two halo buffers, `stages` weight tiles of NT rows x 128 bytes. The
// wrapper's plan computes the same sum: the launcher refuses a mismatch.
inline int wgmma_smem_bytes(int nt, int td, int th, int tw, int stages) {
  return 2048 + 2 * wgmma_halo_bytes(td, th, tw) + stages * nt * 128;
}

// ---- device: barriers, bulk copies, wgmma

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive once and expect `bytes` of asynchronous copies to complete the phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait of seconds
// means a lost arrival, and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo & 0x3FFF) << 16 |
         (uint64_t)(sbo & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers between the roles: the producer warpgroup keeps 40 a thread, the
// NWG consumer warpgroups share the rest (232 a thread for two, 152 for three).
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
template <int NWG>
__device__ __forceinline__ void consumer_registers() {
  constexpr int kRegs = (65536 - 128 * 40) / (128 * NWG) / 8 * 8;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs) : "memory");
}

// A fragments an in-flight wgmma still reads: the compiler must see them live
// (and keep their registers) until the wait that retires that wgmma.
template <int N>
__device__ __forceinline__ void keep_live(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(r[i][q])::"memory");
}

// D (m64 x n64, f32) += A (m64 x k16 bf16, registers) * B (k16 x n64, descriptor);
// TB = 1: B is MN-major (transposed) in shared memory. The scale-d predicate
// is always set: the accumulators start at zero in the registers.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TB), "r"(1));
}

// D (m64 x n128, f32) += A (m64 x k16 bf16, registers) * B (k16 x n128, descriptor);
// TB = 1: B is MN-major (transposed) in shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TB), "r"(1));
}

// The N tile's instruction, B K-major (TB = 0) or MN-major (TB = 1).
template <int NT, int TB>
__device__ __forceinline__ void wgmma_rs_nt(float (&d)[NT / 2], const uint32_t (&a)[4],
                                            uint64_t desc) {
  static_assert(NT == 64 || NT == 128, "N tiles of 64 or 128");
  if constexpr (NT == 64) {
    wgmma_rs_n64<TB>(d, a, desc);
  } else {
    wgmma_rs_n128<TB>(d, a, desc);
  }
}

struct WgArgs {
  const __nv_bfloat16* wp;  // packed weights [N tile][K block][NT][64], swizzled
  const float* scale;
  const float* shift;
  const float* alpha;
  void* out;  // the result, or with splits > 1 the f32 partials [split][position][CO]
  int relu_mode, out_bf16;
  int D, H, W, C, CO;  // extents
  int td, th, tw;      // brick of output positions
  int nbz, nby, nbx;
  int nkb;             // K blocks: chunks of 64 channels x 27 taps
  int splits, stages;
  long long positions;  // B * D * H * W
};

template <int NT, int SPW, int NWG>
__global__ void __launch_bounds__(wgmma_threads(NWG), 1)
    conv3_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const WgArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int TILE = NT * 128;  // bytes of one (tap, chunk) weight tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HP = a.th + 2, WP = a.tw + 2;
  const int halo_rows = (a.td + 2) * HP * WP;
  const int halo_bytes = wgmma_halo_bytes(a.td, a.th, a.tw);
  const int rows = a.td * a.th * a.tw;

  // barriers: halo full [0, 2), halo empty [2, 4), weights full [4, 4 + S), empty [4 + S, 4 + 2S)
  const uint32_t bars = smem_addr(smem);
  auto bar = [&](int i) { return bars + 8 * i; };
  const uint32_t halo0 = bars + 1024;
  const uint32_t ring0 = halo0 + 2 * halo_bytes;

  int brick = blockIdx.x;
  const int bx = brick % a.nbx;
  brick /= a.nbx;
  const int by = brick % a.nby;
  brick /= a.nby;
  const int bz = brick % a.nbz, b = brick / a.nbz;
  const int z0 = bz * a.td, y0 = by * a.th, x0 = bx * a.tw;
  const int ntile = blockIdx.y, split = blockIdx.z;
  const int kb0 = (int)((long long)split * a.nkb / a.splits);
  const int kb1 = (int)((long long)(split + 1) * a.nkb / a.splits);

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar(i), 1);
      mbar_init(bar(2 + i), 4 * NWG);
    }
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(bar(4 + i), 1);
      mbar_init(bar(4 + a.stages + i), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: one thread issues the copies
    producer_registers();
    if (warp == 4 * NWG && lane == 0) {
      const unsigned char* wtile =
          reinterpret_cast<const unsigned char*>(a.wp) + (size_t)ntile * a.nkb * TILE;
      int hs = 0, hph = 0, ws = 0, wph = 0;
      for (int kb = kb0; kb < kb1; ++kb) {
        const int chunk = kb / 27, tap = kb - chunk * 27;
        if (kb == kb0 || tap == 0) {
          mbar_wait(bar(2 + hs), hph ^ 1);
          mbar_expect_tx(bar(hs), halo_rows * 128);
          tma_load_5d(halo0 + hs * halo_bytes, &tmx, bar(hs), chunk * 64, x0 - 1, y0 - 1, z0 - 1,
                      b);
          if (++hs == 2) hs = 0, hph ^= 1;
        }
        mbar_wait(bar(4 + a.stages + ws), wph ^ 1);
        mbar_expect_tx(bar(4 + ws), TILE);
        bulk_load(ring0 + ws * TILE, wtile + (size_t)kb * TILE, TILE, bar(4 + ws));
        if (++ws == a.stages) ws = 0, wph ^= 1;
      }
    }
  } else {  // the consumers, to the end: the roles never reconverge (setmaxnreg)
    consumer_registers<NWG>();

    // a consumer warpgroup: slabs of 64 rows wg * SPW .. wg * SPW + SPW - 1
    const int wg = warp >> 2, w = warp & 3;
    const int hi = lane >> 4;  // ldmatrix: lanes 16-31 address k 8-15
    int prow[SPW];             // this lane's A row: its halo row at tap (0, 0, 0)
#pragma unroll
    for (int s = 0; s < SPW; ++s) {
      int r = (wg * SPW + s) * 64 + 16 * w + (lane & 15);
      if (r >= rows) r = 0;  // padding rows read row 0; never stored
      const int rz = r / (a.th * a.tw), rr = r - rz * a.th * a.tw;
      prow[s] = (rz * HP + rr / a.tw) * WP + rr % a.tw;
    }
    float acc[SPW][NT / 2];
#pragma unroll
    for (int s = 0; s < SPW; ++s)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[s][i] = 0.f;

    // The A fragments of K block kb + 1 load while the wgmma of kb run: two
    // register sets, a wait that leaves one commit group in flight, and the
    // weight slot of kb - 1 released once that group has retired.
    int hs = 0, hph = 0, ws = 0, wph = 0, prev_ws = 0;
    auto load_a = [&](int kb, uint32_t (&af)[SPW * 4][4]) {
      const int tap = kb % 27;
      if (kb == kb0 || tap == 0) mbar_wait(bar(hs), hph);  // a new chunk's halo
      const uint32_t hbase = halo0 + hs * halo_bytes;
      const int toff = ((tap / 9) * HP + (tap / 3) % 3) * WP + tap % 3;
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        const int p = prow[s] + toff;
        const uint32_t rowa = hbase + p * 128;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldsm_x4(rowa + (((2 * ks + hi) ^ (p & 7)) << 4), af[s * 4 + ks]);
      }
      if (tap == 26 || kb == kb1 - 1) {  // the halo's last reader: release the buffer
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(2 + hs));
        if (++hs == 2) hs = 0, hph ^= 1;
      }
    };
    auto step = [&](int kb, uint32_t (&cur)[SPW * 4][4], uint32_t (&nxt)[SPW * 4][4]) {
      mbar_wait(bar(4 + ws), wph);
      const uint64_t desc = desc_b128(ring0 + ws * TILE, 1, 64);  // K-major: 8-row groups 1024 B apart
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int s = 0; s < SPW; ++s) wgmma_rs_nt<NT, 0>(acc[s], cur[s * 4 + ks], desc + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();  // K block kb - 1 retired: its A set and weight slot are free
      keep_live(nxt);
      if (kb > kb0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(4 + a.stages + prev_ws));
      }
      prev_ws = ws;
      if (++ws == a.stages) ws = 0, wph ^= 1;
      if (kb + 1 < kb1) load_a(kb + 1, nxt);
    };
    uint32_t a0[SPW * 4][4], a1[SPW * 4][4];
    load_a(kb0, a0);
    for (int kb = kb0; kb < kb1; kb += 2) {
      step(kb, a0, a1);
      if (kb + 1 < kb1) step(kb + 1, a1, a0);
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(4 + a.stages + prev_ws));

    // epilogue: accumulator (row g + 8 * half, columns 8 i + 2 t, + 1) of each n8 piece
    const int g = lane >> 2, t = lane & 3;
    const float slope = a.relu_mode == 2 ? a.alpha[0] : 0.f;
    const int co_base = ntile * NT + 2 * t;
#pragma unroll
    for (int s = 0; s < SPW; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (wg * SPW + s) * 64 + 16 * w + g + 8 * half;
        if (r >= rows) continue;
        const int rz = r / (a.th * a.tw), rr = r - rz * a.th * a.tw;
        const int gz = z0 + rz, gy = y0 + rr / a.tw, gx = x0 + rr % a.tw;
        if (gz >= a.D || gy >= a.H || gx >= a.W) continue;
        const long long pos = (((long long)b * a.D + gz) * a.H + gy) * a.W + gx;
#pragma unroll
        for (int i = 0; i < NT / 8; ++i) {
          const int co = co_base + 8 * i;
          if (co >= a.CO) break;  // CO % 8 == 0: the pair is whole
          const float v0 = acc[s][4 * i + 2 * half], v1 = acc[s][4 * i + 2 * half + 1];
          if (a.splits > 1) {
            float* part = static_cast<float*>(a.out) + (split * a.positions + pos) * a.CO + co;
            *reinterpret_cast<float2*>(part) = make_float2(v0, v1);
            continue;
          }
          const float y0v = activate(v0 * a.scale[co] + a.shift[co], a.relu_mode, slope);
          const float y1v = activate(v1 * a.scale[co + 1] + a.shift[co + 1], a.relu_mode, slope);
          if (a.out_bf16) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + pos * a.CO +
                                               co) = __floats2bfloat162_rn(y0v, y1v);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + pos * a.CO + co) =
                make_float2(y0v, y1v);
          }
        }
      }
  }
}

namespace {
// out[p, co] = act((sum over the splits, in order, of ws[split][p][co]) *
// scale[co] + shift[co]): four channels a thread.
__global__ void wgmma_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                                    const float* __restrict__ shift,
                                    const float* __restrict__ alpha, int relu_mode, void* out,
                                    int out_bf16, long long n4, int CO, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* src = reinterpret_cast<const float4*>(ws);
  float4 s = src[i];
  for (int k = 1; k < splits; ++k) {
    const float4 v = src[k * n4 + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  const int co = (int)((i * 4) % CO);
  const float slope = relu_mode == 2 ? alpha[0] : 0.f;
  const float y0 = activate(s.x * scale[co] + shift[co], relu_mode, slope);
  const float y1 = activate(s.y * scale[co + 1] + shift[co + 1], relu_mode, slope);
  const float y2 = activate(s.z * scale[co + 2] + shift[co + 2], relu_mode, slope);
  const float y3 = activate(s.w * scale[co + 3] + shift[co + 3], relu_mode, slope);
  if (out_bf16) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
    o[0] = __floats2bfloat162_rn(y0, y1);
    o[1] = __floats2bfloat162_rn(y2, y3);
  } else {
    reinterpret_cast<float4*>(out)[i] = make_float4(y0, y1, y2, y3);
  }
}
}  // namespace

template <int NT, int SPW, int NWG>
cudaError_t launch_wgmma_inst(const CUtensorMap& tmx, const WgArgs& a, dim3 grid, int smem_bytes,
                              cudaStream_t stream) {
  auto kernel = conv3_wgmma_kernel<NT, SPW, NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wgmma_threads(NWG), smem_bytes, stream>>>(tmx, a);
  return cudaGetLastError();
}

// x, packed weights bf16 (B, D, H, W, C) / pack_weights_deep; out bf16 or f32;
// ws holds splits * B * D * H * W * CO floats (unused with one split).
// (td, th, tw, nt, spw, splits, stages, smem_bytes) is the wrapper's plan
// (ops/fused_conv.py::deep_plan).
inline int launch_conv3_wgmma(const void* x, const void* wp, const float* scale,
                              const float* shift, const float* alpha, int relu_mode, void* out,
                              float* ws, int B, int D, int H, int W, int C, int CO, int out_bf16,
                              int td, int th, int tw, int nt, int spw, int nwg, int splits,
                              int stages, int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (C < 8 || C % 8 || CO < 8 || CO % 8 || td < 1 || th < 1 || tw < 1 || td > 254 ||
      th > 254 || tw > 254 || nwg < 2 || nwg > 3 || td * th * tw > 64 * nwg * spw ||
      stages < 2 || splits < 1)
    return invalid;
  WgArgs a;
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.scale = scale, a.shift = shift, a.alpha = alpha;
  a.out = splits > 1 ? static_cast<void*>(ws) : out;
  a.relu_mode = relu_mode, a.out_bf16 = out_bf16;
  a.D = D, a.H = H, a.W = W, a.C = C, a.CO = CO;
  a.td = td, a.th = th, a.tw = tw;
  a.nbz = (D + td - 1) / td, a.nby = (H + th - 1) / th, a.nbx = (W + tw - 1) / tw;
  a.nkb = (C + 63) / 64 * 27;
  a.splits = splits, a.stages = stages;
  a.positions = (long long)B * D * H * W;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  const int n_tiles = (CO + nt - 1) / nt;
  if (nbricks > 0x7fffffffLL || n_tiles > 65535 || splits > 65535 || splits > a.nkb ||
      smem_bytes != wgmma_smem_bytes(nt, td, th, tw, stages) || smem_bytes > 232448)
    return invalid;
  CUtensorMap tmx;
  if (!encode_ndhwc(&tmx, x, B, D, H, W, C, td + 2, th + 2, tw + 2)) return invalid;
  const dim3 grid((unsigned)nbricks, n_tiles, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SEGK_WGMMA_CASE(NT_, SPW_, NWG_)                                                  \
  if (nt == NT_ && spw == SPW_ && nwg == NWG_)                                            \
    err = launch_wgmma_inst<NT_, SPW_, NWG_>(tmx, a, grid, smem_bytes, s);
  SEGK_WGMMA_CASE(64, 1, 2)
  SEGK_WGMMA_CASE(64, 2, 2)
  SEGK_WGMMA_CASE(128, 1, 2)
  SEGK_WGMMA_CASE(64, 1, 3)
  SEGK_WGMMA_CASE(128, 1, 3)
#undef SEGK_WGMMA_CASE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n4 = a.positions * CO / 4;
  wgmma_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      ws, scale, shift, alpha, relu_mode, out, out_bf16, n4, CO, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk
