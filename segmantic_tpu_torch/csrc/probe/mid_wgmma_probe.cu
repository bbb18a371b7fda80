// Probe of the wgmma forms the mid-channel bodies (conv3_mid.cuh,
// conv3_mid_dw.cuh) rest on, built and run by probe_mid_wgmma.py (not part
// of the kernel library):
//
// - one m64nNk16 with A and B from shared memory by no-swizzle K-major
//   descriptors, and one with A from registers and B MN-major, on operands
//   the host lays out: the host compares D with the products the two readings
//   of the descriptors' LBO / SBO fields would give;
// - the rate of the forward's inner loop: two warpgroups a block, one block a
//   multiprocessor, each warpgroup issuing the 27 tap windows of one slab
//   over a staged halo (rows 16 * WP bytes apart, the taps 16-byte granular),
//   A by descriptor (ss) or by ldmatrix into registers (rs), N = 8-64.
#include "../conv3_mid.cuh"

namespace segk {

// A from registers, B by descriptor (TB = 1: MN-major): the RS form.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n8x(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n16x(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32x(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64x(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}


template <int NT, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NT == 8) {
    wgmma_rs_n8x<TB>(d, a, db);
  } else if constexpr (NT == 16) {
    wgmma_rs_n16x<TB>(d, a, db);
  } else if constexpr (NT == 32) {
    wgmma_rs_n32x<TB>(d, a, db);
  } else {
    wgmma_rs_n64x<TB>(d, a, db);
  }
}

// D of one wgmma on an operand image: img (units x 8 bf16) copied to shared
// memory at 0; descriptors' starts are units of that image.
template <int N, int SS>
__global__ void probe_one(const __nv_bfloat16* img, int units, const float* a_frag,
                          uint32_t a_start, uint32_t a_lbo, uint32_t a_sbo, uint32_t b_start,
                          uint32_t b_lbo, uint32_t b_sbo, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  for (int i = threadIdx.x; i < units; i += blockDim.x)
    reinterpret_cast<int4*>(smem)[i] = reinterpret_cast<const int4*>(img)[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base16 = smem_addr(smem) >> 4;
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  wgmma_fence();
  if (SS) {
    wgmma_ss<N>(d, desc_plain(base16 + a_start, a_lbo, a_sbo),
                desc_plain(base16 + b_start, b_lbo, b_sbo));
  } else {  // A fragment (m 16 w + g (+8), k 2 t (+1, +8, +9)) from a_frag [64][16]; B MN-major
    uint32_t a[4];
    for (int q = 0; q < 4; ++q) {
      const int m = 16 * warp + g + 8 * (q & 1), k = 2 * t + 8 * (q >> 1);
      __nv_bfloat162 v = __floats2bfloat162_rn(a_frag[m * 16 + k], a_frag[m * 16 + k + 1]);
      a[q] = *reinterpret_cast<uint32_t*>(&v);
    }
    wgmma_rs<N, 1>(d, a, desc_plain(base16 + b_start, b_lbo, b_sbo));
  }
  wgmma_commit();
  wgmma_wait<0>();
  for (int i = 0; i < N / 8; ++i)
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * warp + g + 8 * half, n = 8 * i + 2 * t;
      out[m * N + n] = d[4 * i + 2 * half];
      out[m * N + n + 1] = d[4 * i + 2 * half + 1];
    }
}

// The forward's inner loop, `iters` times: per warpgroup one slab, 27 taps x
// two planes (C = 16) of a halo whose rows are WPU 16-byte units apart, A by
// descriptor (SS = 1) or by ldmatrix (SS = 0), B resident; ILP slabs a
// warpgroup, their wgmma interleaved tap by tap (1: one dependent chain).
template <int N, int SS, int ILP>
__global__ void __launch_bounds__(512, 1) probe_rate(int iters, int wpu, float* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int WP = wpu, HP = 10, PLANE = 10 * HP * WP * 16;  // a (10, 10, WP) halo a plane
  for (int i = threadIdx.x; i < (2 * PLANE + 27 * N * 32) / 16; i += blockDim.x)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0x3c003c00, 0x3c003c00, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base16 = smem_addr(smem) >> 4, w16 = base16 + 2 * PLANE / 16;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int slab = wg * 2 * HP * WP;  // the warpgroups: z planes 0, 2, 4, 6
  const int am = 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int arow = (am >> 3) * WP + (am & 7) + (lane >> 4) * (PLANE / 16);
  float d[ILP][N / 2];
  for (int j = 0; j < ILP; ++j)
    for (int i = 0; i < N / 2; ++i) d[j][i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const uint64_t db = desc_plain(w16 + tap * N * 2, N, 8);
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        const int off = slab + j * 8 + ((tap / 9) * HP + (tap / 3) % 3) * WP + tap % 3;
        if (SS) {
          wgmma_ss<N>(d[j], desc_plain(base16 + off, PLANE / 16, WP), db);
        } else {
          uint32_t a[4];
          ldsm_x4((base16 + off + arow) << 4, a);
          wgmma_rs<N, 0>(d[j], a, db);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  float s = 0.f;
  for (int j = 0; j < ILP; ++j)
    for (int i = 0; i < N / 2; ++i) s += d[j][i];
  if (s == 12345.f) sink[threadIdx.x] = s;  // keeps the loop
}


// TMA staging rate: one block a multiprocessor, one thread keeping four boxes
// in flight into a ring; the boxes walk the tensor brick by brick.
__global__ void probe_tma_kernel(const __grid_constant__ CUtensorMap map, int nbx, int nby,
                                 int nbz, int nb, int bw, int bh, int bd, int box_bytes,
                                 int iters, int lane_step, float* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem + 1024;
  const uint32_t bars = smem_addr(smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int slot_bytes = (box_bytes + 1023) / 1024 * 1024;
  int phase[4] = {0, 0, 0, 0};
  const int total = nbx * nby * nbz * nb;
  for (int it = 0; it < iters; ++it) {
    const int s = it & 3;
    if (it >= 4) {
      mbar_wait(bars + 8 * s, phase[s]);
      phase[s] ^= 1;
    }
    int r = (blockIdx.x + it * gridDim.x) % total;
    const int x = r % nbx * bw;
    r /= nbx;
    const int y = r % nby * bh;
    r /= nby;
    const int z = r % nbz * bd, b = r / nbz;
    mbar_expect_tx(bars + 8 * s, box_bytes);
    tma_load_5d(smem_addr(ring + s * slot_bytes), &map, bars + 8 * s, (it % 2) * lane_step, x, y,
                z, b);
  }
  for (int it = iters; it < iters + 4; ++it) {
    const int s = it & 3;
    mbar_wait(bars + 8 * s, phase[s]);
    phase[s] ^= 1;
  }
  if (ring[5] == 123) sink[0] = 1.f;
}

// One wgmma with A K-major in a swizzled layout written by TMA: rows of
// `rowb` bytes (32, 64 or 128: the swizzle), A's start `r0` rows (+ `kb`
// bytes) into the box, its 8-row groups `sbo` bytes apart, with
// `base_offset` in the descriptor; B no-swizzle K-major from `img` at 0.
template <int N>
__global__ void probe_swz_kernel(const __grid_constant__ CUtensorMap map, int rowb, int rows,
                                 const __nv_bfloat16* img, int img_units, int r0, int kb, int sbo,
                                 int base_offset, int b_lbo, float* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* a = smem + 1024;               // the box, 1024-aligned
  unsigned char* bimg = a + (rows * rowb + 1023) / 1024 * 1024;
  const uint32_t bar = smem_addr(smem);
  for (int i = threadIdx.x; i < img_units; i += blockDim.x)
    reinterpret_cast<int4*>(bimg)[i] = reinterpret_cast<const int4*>(img)[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, rows * rowb);
    tma_load_5d(smem_addr(a), &map, bar, 0, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  const int layout = rowb == 128 ? 1 : rowb == 64 ? 2 : 3;
  const uint32_t start = smem_addr(a) + r0 * rowb + kb;
  const uint64_t da = ((uint64_t)((start & 0x3FFFF) >> 4)) | (uint64_t)1 << 16 |
                      (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)(base_offset & 7) << 49 |
                      (uint64_t)layout << 62;
  const uint64_t db = desc_plain(smem_addr(bimg) >> 4, b_lbo, 8);
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wgmma_fence();
  wgmma_ss<N>(d, da, db);
  wgmma_commit();
  wgmma_wait<0>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < N / 8; ++i)
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * warp + g + 8 * half, n = 8 * i + 2 * t;
      out[m * N + n] = d[4 * i + 2 * half];
      out[m * N + n + 1] = d[4 * i + 2 * half + 1];
    }
}


// m64n64k16, both operands by descriptor, transpose bits TA, TB (1: MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64_t(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The rate of m64n64k16 with both operands 128-byte swizzled in shared
// memory, K-major or MN-major (TA, TB), `iters` x 27 a warpgroup, the
// starts moving by whole 128-byte rows as the dw's taps do.
template <int TA, int TB>
__global__ void __launch_bounds__(384, 1) probe_swz_rate(int iters, float* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 64 * 1024 / 16; i += blockDim.x)
    reinterpret_cast<int4*>(base)[i] = make_int4(0x3c003c00, 0, 0x3c003c00, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x >= 256) return;
  const uint32_t a0 = smem_addr(base), b0 = a0 + 32 * 1024;
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 27; ++t)
      wgmma_ss_n64_t<TA, TB>(d, desc_b128(a0 + (t % 9) * 128 + (threadIdx.x >> 7) * 8192, 1, 64),
                             desc_b128(b0 + (t / 9) * 2048, 1, 64));
    wgmma_commit();
    wgmma_wait<0>();
  }
  float s = 0.f;
  for (int i = 0; i < 32; ++i) s += d[i];
  if (s == 12345.f) sink[threadIdx.x] = s;
}

template <int N, int SS>
int launch_one(const void* img, int units, const float* a_frag, int as, int al, int asb, int bs,
               int bl, int bsb, float* out) {
  probe_one<N, SS><<<1, 128, units * 16>>>(static_cast<const __nv_bfloat16*>(img), units, a_frag,
                                           as, al, asb, bs, bl, bsb, out);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int SS, int ILP>
int launch_rate(int blocks, int nwg, int iters, int wpu, float* sink, void* stream) {
  const int smem = 2 * 10 * 10 * wpu * 16 + 27 * N * 32;
  auto kernel = probe_rate<N, SS, ILP>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<blocks, 128 * nwg, smem, static_cast<cudaStream_t>(stream)>>>(iters, wpu, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk

extern "C" int probe_one(int n, int ss, const void* img, int units, const float* a_frag, int as,
                         int al, int asb, int bs, int bl, int bsb, float* out) {
#define PROBE_ONE(N_)                                                                    \
  if (n == N_) return ss ? segk::launch_one<N_, 1>(img, units, a_frag, as, al, asb, bs, bl, bsb, out) \
                         : segk::launch_one<N_, 0>(img, units, a_frag, as, al, asb, bs, bl, bsb, out);
  PROBE_ONE(8) PROBE_ONE(16) PROBE_ONE(32) PROBE_ONE(64)
#undef PROBE_ONE
  return -1;
}

extern "C" int probe_rate(int n, int ss, int ilp, int blocks, int nwg, int iters, int wpu,
                          float* sink, void* stream) {
#define PROBE_RATE(N_)                                                                         \
  if (n == N_ && ilp == 1)                                                                     \
    return ss ? segk::launch_rate<N_, 1, 1>(blocks, nwg, iters, wpu, sink, stream)             \
              : segk::launch_rate<N_, 0, 1>(blocks, nwg, iters, wpu, sink, stream);            \
  if (n == N_ && ilp == 4)                                                                     \
    return ss ? segk::launch_rate<N_, 1, 4>(blocks, nwg, iters, wpu, sink, stream)             \
              : segk::launch_rate<N_, 0, 4>(blocks, nwg, iters, wpu, sink, stream);
  PROBE_RATE(8) PROBE_RATE(16) PROBE_RATE(32) PROBE_RATE(64)
#undef PROBE_RATE
  return -1;
}

// a (B, D, H, W, lanes) bf16 tensor's TMA map with box (inner lanes, bw, bh, bd),
// swizzle 0 / 32 / 64 / 128 bytes
static bool probe_map(CUtensorMap* map, const void* base, int B, int D, int H, int W, int lanes,
                      int inner, int bw, int bh, int bd, int swizzle) {
  const segk::EncodeTiledFn fn = segk::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)lanes, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)lanes * 2;
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  const cuuint32_t box[5] = {(cuuint32_t)inner, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bd, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

extern "C" int probe_tma(const void* base, int B, int D, int H, int W, int lanes, int inner,
                         int bw, int bh, int bd, int blocks, int iters, int lane_step,
                         float* sink, void* stream) {
  CUtensorMap map;
  if (!probe_map(&map, base, B, D, H, W, lanes, inner, bw, bh, bd, 0)) return -2;
  const int box_bytes = inner * 2 * bw * bh * bd;
  const int smem = 1024 + 4 * ((box_bytes + 1023) / 1024 * 1024);
  cudaFuncSetAttribute(segk::probe_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  segk::probe_tma_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      map, (W + bw - 1) / bw, (H + bh - 1) / bh, (D + bd - 1) / bd, B, bw, bh, bd, box_bytes,
      iters, lane_step, sink);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_swz(const void* base, int rowb, int rows, const void* img, int img_units,
                         int r0, int kb, int sbo, int base_offset, int b_lbo, float* out) {
  CUtensorMap map;
  // a (1, 1, 1, rows, rowb / 2) tensor: one box of `rows` rows of rowb bytes
  if (!probe_map(&map, base, 1, 1, 1, rows, rowb / 2, rowb / 2, rows, 1, 1, rowb)) return -2;
  const int smem = 1024 + (rows * rowb + 1023) / 1024 * 1024 + img_units * 16;
  cudaFuncSetAttribute(segk::probe_swz_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  segk::probe_swz_kernel<16><<<1, 128, smem>>>(map, rowb, rows,
                                               static_cast<const __nv_bfloat16*>(img), img_units,
                                               r0, kb, sbo, base_offset, b_lbo, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_swz_rate(int ta, int tb, int blocks, int iters, float* sink, void* stream) {
  const int smem = 65 * 1024;
  auto go = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<blocks, 384, smem, static_cast<cudaStream_t>(stream)>>>(iters, sink);
    return static_cast<int>(cudaGetLastError());
  };
  if (ta && tb) return go(segk::probe_swz_rate<1, 1>);
  if (ta) return go(segk::probe_swz_rate<1, 0>);
  if (tb) return go(segk::probe_swz_rate<0, 1>);
  return go(segk::probe_swz_rate<0, 0>);
}
