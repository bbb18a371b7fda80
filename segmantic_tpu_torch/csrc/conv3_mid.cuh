// Mid-channel body of the two stride-1 SAME 3x3x3 convolution kernels
// (fused_conv.cu: dense NDHWC; phase_conv.cu: phase-major tensors standing
// for a 2x-upsampled volume) for bf16 input between the few-channel and the
// deep-channel bands: C a multiple of 8 (phase: of 16) and C + CO >= 48
// (ops/fused_conv.py::conv_body) -- packed UNETR's phase-space stages with a
// 32-channel side (96^3 x 32 -> 16 and its input gradient 16 -> 32, 48^3 x 32,
// 48^3 x 64 -> 32 and 32 -> 64), the 24^3 / 12^3 x 32 convs of the flagship,
// SegResNet and UNETR; forward and input gradient (the same conv with
// flipped weights). Its accumulator fence serves the weight-gradient body of
// conv3_mid_dw.cuh too.
//
// It replaces, with the other bodies, the Pallas kernels
// segmantic_tpu/ops/pallas_conv.py::_kernel (conv3d_packed_p) and
// segmantic_tpu/ops/phase_gemm.py::_fwd_kernel_folded / _fwd_kernel
// (phase_conv_gemm_folded_p, phase_conv_gemm_p) at these shapes. The conv is
// an implicit GEMM: M = output positions, N = CO, K = 27 taps x C, f32
// accumulation. At 16-64 channels the work sits near the ridge (48^3 x 32 in
// phase space at batch 8: 49 GFLOP against 113 MB), so every staged byte has
// to reach the tensor cores cheaply; conv3_mma.cuh spent its time on
// ldmatrix traffic and mma.sync issue and staged the halo once per N tile.
// Here:
//
// - One persistent block: NWG consumer warpgroups and MID_PRODUCERS producer
//   threads. The block walks bricks blockIdx.x, += gridDim.x; a brick is TD
//   x TH x TW points of the grid (dense: output positions; phase: block
//   voxels, each eight output phases), TH and TW multiples of 8. Its M rows
//   are NWG x SPW slabs of 64: one slab is 8 rows (y) of 8 consecutive x of
//   one z plane (phase: of one output phase), so each of its row groups is
//   one core matrix of the operand.
// - Staging: per (brick, chunk of CK = 16 input channels; C = 8: one of 8)
//   the producers write the halo into an mbarrier ring of `stages` as planes
//   of 8 channels, each plane ordered (z, y, x) with 16 bytes a point (dense
//   (TD+2)(TH+2)(TW+2) points; phase, per input phase, the (TD+1)(TH+1)(TW+1)
//   block voxels that phase's taps reach, starting one block before the
//   brick where the phase is odd along an axis), zero outside the volume.
//   The planes are a transposition of the channel-last tensor, a 16-byte
//   request a piece: TMA boxes 16 bytes wide ran at ~4 bytes a cycle a
//   multiprocessor on an H100 (probe_mid_wgmma.py), and cp.async did no
//   better, so each producer thread keeps one piece of its points, walks
//   them by carries and moves eight at a time through its registers
//   (mid_stage), then fences them for the async proxy.
// - Operand A comes straight from shared memory: 8 consecutive x of one
//   plane are one 128-byte core matrix of the no-swizzle K-major layout, so a
//   slab's window at any tap is a descriptor whose start is the tap's offset
//   (16-byte granular), whose stride between row groups (SBO) is the halo's
//   row pitch and between the two k halves (LBO) the plane pitch. C = 8 (one
//   plane) pairs two taps in one k16 step instead: the LBO is the distance
//   between the two taps' windows, and the first step pairs tap 0 with tap
//   1 under zero weights. The phase layout's M rows are ordered by output
//   phase, so every tap of a slab reads one input phase's plane at one block
//   offset (the tap table, mid_tap_offset).
// - Operand B: the weights of the N tile (ops/fused_conv.py::
//   pack_weights_mid: per k16 step two k halves x NT / 8 core matrices of 8
//   output channels x 8 k, K-major) come once per block by one bulk copy and
//   stay resident. N = the whole CO tile (8-64), so each staged window is
//   read once, not once per N tile.
// - wgmma.mma_async m64nNTk16 with both operands by descriptor, straight-line
//   from the fence to the commit (tap by tap, the slabs' accumulator chains
//   interleaved), one commit group per (brick, chunk) and warpgroup, retired
//   before the slot is released; the epilogue (scale, shift, none / relu /
//   prelu; bf16 or f32 pairs) runs from the accumulator layout straight to
//   the mapped address.
//
// What bounds it: each wgmma reads A (2 KB) and B (NT x 32 bytes) from
// shared memory, ~128 bytes a cycle (probe_mid_wgmma.py on an H100: 395
// TFLOP/s at N = 16, 995 at N = 64, ~19 and ~31 cycles a wgmma at 1.755
// GHz), so at N = 8 or 16 the operand
// traffic, not the tensor cores, paces the products, and the staging shares
// the multiprocessor's memory pipeline with them; the rule keeps C + CO < 48
// on conv3_mma.cuh, which measured faster there.
// Brick, chunk, N tile, slabs and ring are the wrapper's plan
// (ops/fused_conv.py::mid_plan); the launcher refuses a plan whose
// shared-memory sum differs from its own (mid_smem_bytes).
#pragma once

#include "conv3_wgmma.cuh"

namespace segk {

// ---- wgmma forms of the mid band: A and B by descriptor, K-major. The
// scale-d predicate is always set: the accumulators start at zero in the
// registers.

__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int NT>
__device__ __forceinline__ void wgmma_ss(float (&d)[NT / 2], uint64_t da, uint64_t db) {
  static_assert(NT == 8 || NT == 16 || NT == 32 || NT == 64, "N tiles of 8, 16, 32 or 64");
  if constexpr (NT == 8) {
    wgmma_ss_n8(d, da, db);
  } else if constexpr (NT == 16) {
    wgmma_ss_n16(d, da, db);
  } else if constexpr (NT == 32) {
    wgmma_ss_n32(d, da, db);
  } else {
    wgmma_ss_n64(d, da, db);
  }
}

// Shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets, all in 16-byte units (the layout bits stay 0).
__device__ __forceinline__ uint64_t desc_plain(uint32_t start16, uint32_t lbo16, uint32_t sbo16) {
  return (uint64_t)(start16 & 0x3FFF) | (uint64_t)(lbo16 & 0x3FFF) << 16 |
         (uint64_t)(sbo16 & 0x3FFF) << 32;
}

__host__ __device__ constexpr int round128(int n) { return (n + 127) / 128 * 128; }

// Points of one staged plane: the dense halo, or one input phase's share.
__host__ __device__ constexpr int mid_halo_points(int phase, int td, int th, int tw) {
  return phase ? (td + 1) * (th + 1) * (tw + 1) : (td + 2) * (th + 2) * (tw + 2);
}
// A staged plane of n points: 16 bytes a point, pitched 16 bytes past a
// multiple of 128 so that the pieces of one point, which neighbouring
// threads stage, fall on different banks.
__host__ __device__ constexpr int mid_pitch(int n) { return round128(n * 16) + 16; }
__host__ __device__ constexpr int mid_plane_bytes(int phase, int td, int th, int tw) {
  return mid_pitch(mid_halo_points(phase, td, th, tw));
}
// k16 steps of a chunk: C = 8 pairs the taps (14), else 27 taps of CK = 16.
__host__ __device__ constexpr int mid_ksteps(int ck) { return ck == 8 ? 14 : 27; }
// one N tile's packed weights: every k16 step holds 2 x NT / 8 core matrices
__host__ __device__ constexpr int mid_w_bytes(int ck, int nchunks, int nt) {
  return nchunks * mid_ksteps(ck) * nt * 32;
}
__host__ __device__ constexpr int mid_stage_bytes(int phase, int ck, int td, int th, int tw) {
  return (phase ? 8 : 1) * (ck / 8) * mid_plane_bytes(phase, td, th, tw);
}
// 128 bytes to align the base, 1024 of barriers and the tap table, the
// resident weights, `stages` ring slots. The wrapper's plan computes the
// same sum: the launcher refuses a mismatch.
__host__ __device__ constexpr int mid_smem_bytes(int phase, int ck, int nchunks, int nt, int td,
                                                 int th, int tw, int stages) {
  return 1152 + mid_w_bytes(ck, nchunks, nt) + stages * mid_stage_bytes(phase, ck, td, th, tw);
}

// The accumulators an in-flight wgmma writes: pinned to their registers from
// the fence before the first wgmma of a group to the wait after its last.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The producer threads that stage the planes, after the NWG consumer
// warpgroups.
constexpr int MID_PRODUCERS = 128;
__host__ __device__ constexpr int mid_threads(int nwg) { return 128 * nwg + MID_PRODUCERS; }

// Stage the 8-lane planes of one box of nd x nh x nw points from `count`
// threads (index `ptid`; count a multiple of the pieces a point has): plane
// (ip, j) of NPH input phases x 2^lg_npl planes holds, point by point in
// (z, y, x) order, lanes ip * C + c0 + 8 j of the grid point at the box's
// origin + the point, zero outside the grid or at channels past C. The
// origin is o (z, y, x) less, per axis, 1 (dense: the halo) or the input
// phase's bit (NPH = 8: that phase's share of the halo).
//
// A thread keeps one 16-byte piece (ip, j) of its points and walks them by
// a fixed step with carries (no division, no table), neighbouring threads
// taking neighbouring pieces of one point; the pieces go through registers,
// eight 16-byte loads in flight a thread, then to shared memory (cp.async,
// tried first, overlapped the products no better). The
// caller fences the writes for the async proxy before it signals them.
template <int NPH>
__device__ __forceinline__ void mid_stage(uint32_t dst, int plane_bytes, const __nv_bfloat16* x,
                                          int nd, int nh, int nw, int lg_npl, int C, int c0,
                                          int b, int oz, int oy, int ox, int D, int H, int W,
                                          int ptid, int count) {
  constexpr int BATCH = 8;
  const int lg_per = lg_npl + (NPH == 8 ? 3 : 0);
  const int sub = ptid & ((1 << lg_per) - 1);
  const int ip = sub >> lg_npl, j = sub & ((1 << lg_npl) - 1);
  const int lanes = NPH * C, c = c0 + 8 * j;
  const int bz = oz - (NPH == 8 ? ip >> 2 : 1), by = oy - (NPH == 8 ? (ip >> 1) & 1 : 1);
  const int bx = ox - (NPH == 8 ? ip & 1 : 1);
  const int4* base = reinterpret_cast<const int4*>(x + (size_t)b * D * H * W * lanes + ip * C + c);
  const int row4 = lanes / 8;  // 16-byte pieces a grid point
  const uint32_t d0 = dst + (ip << lg_npl | j) * plane_bytes;
  const int npts = nd * nh * nw, step = count >> lg_per;
  int p = ptid >> lg_per;
  int z = p / (nh * nw), y = p / nw % nh, xx = p % nw;
  const int tz = step / (nh * nw), ty = step / nw % nh, tx = step % nw;
  const bool cok = c < C;
  while (p < npts) {
    int4 v[BATCH];
    uint32_t at[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int gz = bz + z, gy = by + y, gx = bx + xx;
      const bool in = p + k * step < npts;
      const bool ok = in && cok && (unsigned)gz < (unsigned)D && (unsigned)gy < (unsigned)H &&
                      (unsigned)gx < (unsigned)W;
      v[k] = ok ? __ldg(base + ((gz * H + gy) * W + gx) * row4) : make_int4(0, 0, 0, 0);
      at[k] = in ? d0 + (p + k * step) * 16 : 0xFFFFFFFFu;
      xx += tx, y += ty, z += tz;
      if (xx >= nw) xx -= nw, ++y;
      if (y >= nh) y -= nh, ++z;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (at[k] != 0xFFFFFFFFu)
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at[k]), "r"(v[k].x),
                     "r"(v[k].y), "r"(v[k].z), "r"(v[k].w)
                     : "memory");
    p += BATCH * step;
  }
}

// The producers' side of a ring slot: their plain stores made visible to
// the async proxy (wgmma reads shared memory through it), then the arrival.
__device__ __forceinline__ void mid_stage_done(uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(bar);
}

// The tap table: for output phase ph (0 in the dense layout) and tap t, the
// offset in 16-byte units of the tap's window from a slab's window at
// offset 0, plane included (the phase layout's taps read the plane of their
// input phase).
template <int PHASE>
__device__ __forceinline__ int mid_tap_offset(int ph, int t, int hp, int wp, int npl, int plane16) {
  const int e[3] = {t / 9, (t / 3) % 3, t % 3};  // halo offsets 0..2 along z, y, x
  if constexpr (!PHASE) {
    return (e[0] * hp + e[1]) * wp + e[2];
  } else {
    int ip = 0, o[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int s = ((ph >> (2 - k)) & 1) + e[k] - 1;  // full-resolution step: -1 .. 2
      ip |= (s & 1) << (2 - k);                         // the input phase along this axis
      o[k] = (s + 1) >> 1;                              // block offset in the phase's plane
    }
    return ip * npl * plane16 + (o[0] * hp + o[1]) * wp + o[2];
  }
}

struct MidArgs {
  const float* scale;
  const float* shift;
  const float* alpha;
  void* out;
  int relu_mode, out_bf16;
  int D, H, W;   // the grid: dense output positions, phase block voxels
  int C, CO;
  int td, th, tw;
  int nbz, nby, nbx, nbricks;
  int nchunks, stages;
  int w_bytes;   // one N tile's packed weights
};

template <int PHASE, int CK, int NT, int SPW, int NWG>
__global__ void __launch_bounds__(mid_threads(NWG), 1)
    conv3_mid_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                     const MidArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  constexpr int NPH = PHASE ? 8 : 1;
  constexpr int HALO = PHASE ? 1 : 2;
  constexpr int NG = NT / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HP = a.th + HALO, WP = a.tw + HALO;
  const int plane_bytes = mid_plane_bytes(PHASE, a.td, a.th, a.tw);
  const int plane16 = plane_bytes >> 4;
  constexpr int NPL = CK / 8, KSTEPS = mid_ksteps(CK);
  const int stage_bytes = NPH * NPL * plane_bytes;
  const int S = a.stages;

  // barriers: full [0, S), empty [S, 2S), weights 2S; the tap table at 128
  const uint32_t base = smem_addr(smem);
  auto bar = [&](int i) { return base + 8 * i; };
  int* tab = reinterpret_cast<int*>(smem + 128);
  const uint32_t wsm = base + 1024;
  const uint32_t ring = wsm + a.w_bytes;
  const int ntile = blockIdx.y;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar(i), MID_PRODUCERS);  // every producer thread, its pieces stored
      mbar_init(bar(S + i), 4 * NWG);
    }
    mbar_init(bar(2 * S), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < NPH * 27; i += blockDim.x)
    tab[i] = mid_tap_offset<PHASE>(i / 27, i % 27, HP, WP, NPL, plane16);
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warps stage the halo
    const int ptid = tid - 128 * NWG;  // 0 .. MID_PRODUCERS - 1
    if (ptid == 0) {  // the weights: one bulk copy, resident
      mbar_expect_tx(bar(2 * S), a.w_bytes);
      bulk_load(wsm, reinterpret_cast<const unsigned char*>(wp) + (size_t)ntile * a.w_bytes,
                a.w_bytes, bar(2 * S));
    }
    int s = 0, ph = 0;
    for (int brick = blockIdx.x; brick < a.nbricks; brick += gridDim.x) {
      int r = brick;
      const int x0 = (r % a.nbx) * a.tw;
      r /= a.nbx;
      const int y0 = (r % a.nby) * a.th;
      r /= a.nby;
      const int z0 = (r % a.nbz) * a.td, b = r / a.nbz;
      for (int chunk = 0; chunk < a.nchunks; ++chunk) {
        mbar_wait(bar(S + s), ph ^ 1);
        mid_stage<NPH>(ring + s * stage_bytes, plane_bytes, x, a.td + HALO, HP, WP, NPL / 2, a.C,
                       chunk * CK, b, z0, y0, x0, a.D, a.H, a.W, ptid, MID_PRODUCERS);
        mid_stage_done(bar(s));
        if (++s == S) s = 0, ph ^= 1;
      }
    }
  } else {  // the consumers
    const int wg = warp >> 2, w = warp & 3;
    const int sx = a.tw >> 3, sy = a.th >> 3;
    const int per_phase = a.td * sy * sx;
    int sph[SPW], szl[SPW], syo[SPW], spos[SPW];  // a slab: its phase, z, y offset, window
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int q = wg * SPW + i;
      sph[i] = q / per_phase;
      const int r = q - sph[i] * per_phase;
      const int xo = r % sx;
      syo[i] = (r / sx) % sy * 8;
      szl[i] = r / (sx * sy);
      spos[i] = (szl[i] * HP + syo[i]) * WP + xo * 8;
      syo[i] |= xo << 16;  // x offset / 8 beside the y offset
    }
    const int g = lane >> 2, t4 = lane & 3;
    float sc[NG][2], sh[NG][2];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int co = ntile * NT + 8 * n + 2 * t4 + q;
        sc[n][q] = co < a.CO ? a.scale[co] : 0.f;
        sh[n][q] = co < a.CO ? a.shift[co] : 0.f;
      }
    const float slope = a.relu_mode == 2 ? a.alpha[0] : 0.f;
    float acc[SPW][NT / 2];
#pragma unroll
    for (int i = 0; i < SPW; ++i)
#pragma unroll
      for (int k = 0; k < NT / 2; ++k) acc[i][k] = 0.f;

    mbar_wait(bar(2 * S), 0);  // the resident weights
    const uint32_t w16 = wsm >> 4;
    int s = 0, ph = 0;
    for (int brick = blockIdx.x; brick < a.nbricks; brick += gridDim.x) {
      for (int chunk = 0; chunk < a.nchunks; ++chunk) {
        mbar_wait(bar(s), ph);
        const uint32_t st16 = (ring + s * stage_bytes) >> 4;
        const uint32_t wb16 = w16 + chunk * KSTEPS * NT * 2;  // a k16 step: NT * 32 bytes
        // tap by tap, the slabs' wgmma interleaved; straight-line code from the
        // fence to the commit, the accumulators pinned to their registers
#pragma unroll
        for (int i = 0; i < SPW; ++i) fence_acc(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) {
          const uint64_t db = desc_plain(wb16 + k * NT * 2, NG * 8, 8);
#pragma unroll
          for (int i = 0; i < SPW; ++i) {
            const int* tb = tab + sph[i] * 27;
            if constexpr (CK == 8) {  // dense C = 8: taps (0, 1 under zero weights), (2k - 1, 2k)
              const int t0 = k ? 2 * k - 1 : 0, t1 = k ? 2 * k : 1;
              wgmma_ss<NT>(acc[i], desc_plain(st16 + spos[i] + tb[t0], tb[t1] - tb[t0], WP), db);
            } else {  // tap k, both planes of the chunk
              wgmma_ss<NT>(acc[i], desc_plain(st16 + spos[i] + tb[k], plane16, WP), db);
            }
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < SPW; ++i) fence_acc(acc[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar(S + s));
        if (++s == S) s = 0, ph ^= 1;
      }

      // epilogue: accumulator (row 16 w + g + 8 half, columns 8 n + 2 t4, + 1):
      // row group 2 w + half is the slab's y, g its x
      int r = brick;
      const int x0 = (r % a.nbx) * a.tw;
      r /= a.nbx;
      const int y0 = (r % a.nby) * a.th;
      r /= a.nby;
      const int z0 = (r % a.nbz) * a.td, b = r / a.nbz;
#pragma unroll
      for (int i = 0; i < SPW; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gz = z0 + szl[i], gy = y0 + (syo[i] & 0xFFFF) + 2 * w + half,
                    gx = x0 + (syo[i] >> 16) * 8 + g;
          if (gz >= a.D || gy >= a.H || gx >= a.W) continue;
          const long long pos = (((long long)b * a.D + gz) * a.H + gy) * a.W + gx;
          const long long o = (PHASE ? pos * 8 + sph[i] : pos) * a.CO;
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const int co = ntile * NT + 8 * n + 2 * t4;
            if (co >= a.CO) break;
            const float v0 = activate(acc[i][4 * n + 2 * half] * sc[n][0] + sh[n][0], a.relu_mode, slope);
            const float v1 = activate(acc[i][4 * n + 2 * half + 1] * sc[n][1] + sh[n][1], a.relu_mode, slope);
            if (a.out_bf16) {
              __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + o + co;
              if ((a.CO & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
              } else {
                dst[0] = __float2bfloat16(v0);
                if (co + 1 < a.CO) dst[1] = __float2bfloat16(v1);
              }
            } else {
              float* dst = static_cast<float*>(a.out) + o + co;
              if ((a.CO & 1) == 0) {
                *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
              } else {
                dst[0] = v0;
                if (co + 1 < a.CO) dst[1] = v1;
              }
            }
          }
        }
#pragma unroll
      for (int i = 0; i < SPW; ++i)
#pragma unroll
        for (int k = 0; k < NT / 2; ++k) acc[i][k] = 0.f;
    }
  }
}

template <int PHASE, int CK, int NT, int SPW, int NWG>
cudaError_t launch_mid_inst(const __nv_bfloat16* x, const __nv_bfloat16* wp, const MidArgs& a,
                            dim3 grid, int smem_bytes, cudaStream_t stream) {
  auto kernel = conv3_mid_kernel<PHASE, CK, NT, SPW, NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, mid_threads(NWG), smem_bytes, stream>>>(x, wp, a);
  return cudaGetLastError();
}

// x bf16 (dense (B, D, H, W, C); phase (B, D/2, H/2, W/2, 8 C) with D, H, W
// the full-resolution extents), packed weights (pack_weights_mid), out bf16
// or f32 in x's layout with CO channels. (td, th, tw, ck, nt, spw, nwg,
// grid_x, stages, smem_bytes) is the wrapper's plan (ops/fused_conv.py::
// mid_plan); the brick is in points of the grid (phase: block voxels).
template <int PHASE>
int launch_conv3_mid(const void* x, const void* wp, const float* scale, const float* shift,
                     const float* alpha, int relu_mode, void* out, int B, int D, int H, int W,
                     int C, int CO, int out_bf16, int td, int th, int tw, int ck, int nt,
                     int spw, int nwg, int grid_x, int stages, int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  constexpr int NPH = PHASE ? 8 : 1;
  if (C < 8 || C % 8 || CO < 1 || td < 1 || th < 8 || tw < 8 || th % 8 || tw % 8 ||
      td + 2 > 256 || th + 2 > 256 || tw + 2 > 256 || stages < 2 || stages > 4 || grid_x < 1)
    return invalid;
  if (ck == 8 ? (C != 8 || PHASE) : (ck != 16 || (PHASE && C % ck))) return invalid;
  if (PHASE && (D % 2 || H % 2 || W % 2)) return invalid;
  if (NPH * td * (th / 8) * (tw / 8) != spw * nwg) return invalid;  // the slabs are the rows
  MidArgs a;
  a.scale = scale, a.shift = shift, a.alpha = alpha;
  a.out = out;
  a.relu_mode = relu_mode, a.out_bf16 = out_bf16;
  a.D = PHASE ? D / 2 : D, a.H = PHASE ? H / 2 : H, a.W = PHASE ? W / 2 : W;
  a.C = C, a.CO = CO;
  a.td = td, a.th = th, a.tw = tw;
  a.nbz = (a.D + td - 1) / td, a.nby = (a.H + th - 1) / th, a.nbx = (a.W + tw - 1) / tw;
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  if (nbricks > 0x7fffffffLL) return invalid;
  a.nbricks = static_cast<int>(nbricks);
  a.nchunks = (C + ck - 1) / ck, a.stages = stages;
  a.w_bytes = mid_w_bytes(ck, a.nchunks, nt);
  const int n_tiles = (CO + nt - 1) / nt;
  if (n_tiles > 65535 || smem_bytes != mid_smem_bytes(PHASE, ck, a.nchunks, nt, td, th, tw, stages) ||
      smem_bytes > 232448)
    return invalid;
  if ((long long)a.D * a.H * a.W * NPH * C >= 0x7fffffffLL) return invalid;  // 32-bit offsets
  const dim3 grid(grid_x, n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wp);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
#define SEGK_MID_CASE(CK_, NT_, SPW_, NWG_)                                       \
  if (ck == CK_ && nt == NT_ && spw == SPW_ && nwg == NWG_)                       \
    return static_cast<int>(                                                      \
        launch_mid_inst<PHASE, CK_, NT_, SPW_, NWG_>(xb, w, a, grid, smem_bytes, s));
  if constexpr (!PHASE) {  // bricks of 4 or 8 slabs; C = 8 pairs its taps
    SEGK_MID_CASE(8, 8, 2, 2)
    SEGK_MID_CASE(8, 8, 4, 2)
    SEGK_MID_CASE(8, 16, 2, 2)
    SEGK_MID_CASE(8, 16, 4, 2)
    SEGK_MID_CASE(8, 32, 2, 2)
    SEGK_MID_CASE(8, 32, 4, 2)
    SEGK_MID_CASE(8, 64, 2, 2)
    SEGK_MID_CASE(8, 64, 2, 4)
    SEGK_MID_CASE(16, 8, 2, 2)
    SEGK_MID_CASE(16, 8, 4, 2)
    SEGK_MID_CASE(16, 16, 2, 2)
    SEGK_MID_CASE(16, 16, 4, 2)
    SEGK_MID_CASE(16, 32, 2, 2)
    SEGK_MID_CASE(16, 32, 4, 2)
    SEGK_MID_CASE(16, 64, 2, 2)
    SEGK_MID_CASE(16, 64, 2, 4)
  } else {  // one plane of 8 x 8 block voxels: the 8 output phases' slabs
    SEGK_MID_CASE(16, 8, 4, 2)
    SEGK_MID_CASE(16, 16, 4, 2)
    SEGK_MID_CASE(16, 32, 4, 2)
    SEGK_MID_CASE(16, 64, 2, 4)
  }
#undef SEGK_MID_CASE
  return invalid;
}

}  // namespace segk
