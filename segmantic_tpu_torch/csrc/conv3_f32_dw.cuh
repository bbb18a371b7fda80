// Register-tiled f32 body of the two weight-gradient kernels of the
// stride-1 SAME 3x3x3 convolution (fused_conv_dw.cu: dense NDHWC tensors;
// phase_conv_dw.cu: phase-major tensors standing for a 2x-upsampled volume)
// on the H100's CUDA cores: f32 input, and bf16 input whose channel counts
// fit no tensor-core body. Exact f32 FFMA only (no TF32).
//
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]
//
// is a GEMM with M = 27 * C rows (tap, ci), N = CO, K = output positions. A
// block owns a tap group of `taps` taps (9 or 27: a plane of (ky, kx) or
// all; smaller groups restage x more often and were slower where timed), a
// tile of `ci` input channels and one of nt output channels (grid.y, the
// tap group fastest), and walks the position bricks split, split + splits,
// ... (grid.x: the K splits). Its threads are
// npg position groups x ceil(taps * ci / 8) row groups x nt / 8 channel
// groups; each holds an 8 x 8 register tile of (tap, ci) rows x output
// channels (the two channel quads nt / 2 apart). For each brick the x halo
// the tap group needs ([z][y][x][ci], channels pitched at an odd number of
// quads) and the brick of dy ([p][nt + 4]) are staged by cp.async (16-byte
// pieces where the channel vectors allow, else 4-byte ones; bf16 by plain
// loads) into a ring of 2-3 slots, so the next brick lands under the current
// FMAs; a position group then takes every npg-th (z, y) row of the brick and
// runs outer products along it: per position two (one tap's 8 channels) or
// eight (fewer than 4 channels in a tile) loads of x and two float4 of dy for
// 64 FMAs, the addresses stepped by pointer increments.
//
// The position groups' tiles are summed in shared memory in group order,
// then one partial per block and split goes to the workspace and a second
// kernel sums the splits in split order: the result repeats bit for bit from
// run to run. An accumulator's chain is its group's share of the split's
// positions; the plan (ops/fused_conv.py::f32_dw_plan) keeps it within 2,048
// products. The launcher refuses a plan whose shared memory differs from
// f32_dw_smem_bytes.
//
// What bounds it on the card: the FMAs (the f32 peak) at the i2i and deep
// rows, the staging at the one-channel phase layer; measured, the shared
// loads that feed the FMAs: skipping every other dy or x load took ~10% off
// (H100), while a tile of the three kx taps x 4 channels x 8 outputs, which
// slides along x with half the loads, needs 96 accumulators and spilled.
#pragma once

#include "conv3_dw_mma.cuh"
#include "conv3_f32.cuh"

namespace segk {

__host__ __device__ constexpr int f32_dw_ci_pitch(int ci) {
  return f32_round4(ci) % 8 == 0 ? f32_round4(ci) + 4 : f32_round4(ci);
}
__host__ __device__ constexpr int f32_dw_threads(int taps, int ci, int nt, int npg) {
  return npg * ((taps * ci + 7) / 8) * (nt / 8);
}
// The halo extent a tap group adds along z (2 along y and x).
__host__ __device__ constexpr int f32_dw_ez(int taps) { return taps == 27 ? 2 : 0; }

// 4-byte words: the tables of the halo and brick positions' (z, y, x), then
// the ring of slots (x halo, dy brick), which the position groups' sum
// reuses.
inline int f32_dw_smem_bytes(int td, int th, int tw, int taps, int ci, int nt, int npg,
                             int stages) {
  const int P = td * th * tw;
  const int nh = (td + f32_dw_ez(taps)) * (th + 2) * (tw + 2);
  const int ring = stages * (nh * f32_dw_ci_pitch(ci) + P * (nt + 4));
  const int red = npg > 1 ? f32_dw_threads(taps, ci, nt, npg) * 64 : 0;
  return 4 * (f32_round4(nh) + f32_round4(P) + (ring > red ? ring : red));
}

struct F32DwArgs {
  const void* x;
  const void* dy;
  float* out;  // dw (one split), or the f32 partials [split][27 * C * CO]
  int B, D, H, W, C, CO;
  int td, th, tw, taps, ci, nt, npg, splits, stages;
  int nbz, nby, nbx;
  long long nbricks;
  int vec_x, vec_dy;
};

// RV = 4: a thread's 8 rows are two quads of consecutive channels (ci % 4 ==
// 0); RV = 1: eight rows of their own (ci = 1..3: several taps a thread).
template <typename Tin, typename Layout, int RV>
__global__ void __launch_bounds__(F32_MAX_THREADS, 2) conv3_f32_dw_kernel(const F32DwArgs a) {
  constexpr bool kF32 = std::is_same<Tin, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int td = a.td, th = a.th, tw = a.tw, taps = a.taps, cib = a.ci, nt = a.nt;
  const int D = a.D, H = a.H, W = a.W, C = a.C, CO = a.CO;
  const int P = td * th * tw;
  const int ez = f32_dw_ez(taps);
  const int HZ = td + ez, HY = th + 2, HX = tw + 2;
  float* const ring = reinterpret_cast<float*>(smem) + f32_round4(HZ * HY * HX) + f32_round4(P);
  const int ckp = f32_dw_ci_pitch(cib), ntp = nt + 4;
  const int xs_f = HZ * HY * HX * ckp, slot_f = xs_f + P * ntp;
  const int nthreads = blockDim.x, tid = threadIdx.x;

  const int n_tg = 27 / taps, n_ci = (C + cib - 1) / cib;
  const int tile = blockIdx.y;
  const int tg = tile % n_tg;
  const int c0 = (tile / n_tg % n_ci) * cib;
  const int co0 = tile / n_tg / n_ci * nt;
  const int split = blockIdx.x;
  const int t0 = tg * taps;  // the group's first tap
  const int oz = ez ? -1 : t0 / 9 - 1;  // the halo's first plane, relative to the brick's

  const int G = nt / 8, R = (taps * cib + 7) / 8;
  const int g = tid % G;
  const int rg = tid / G % R;
  const int pg = tid / G / R;

  // halo offset of each of the thread's rows (tap, channel); rows past the
  // group's taps read row 0 and are never stored
  int xo[RV == 4 ? 2 : 8];
#pragma unroll
  for (int i = 0; i < (RV == 4 ? 2 : 8); ++i) {
    const int k = rg * 8 + i * RV;
    const int tl = k / cib, cl = k % cib;
    const int t = t0 + tl;
    const int lz = ez ? t / 9 : 0;
    xo[i] = tl < taps ? ((lz * HY + t / 3 % 3) * HX + t % 3) * ckp + cl : 0;
  }

  // (z, y, x) of each halo position and of each brick position, packed, so
  // that staging divides nothing
  const int nh = HZ * HY * HX;
  int* const htab = reinterpret_cast<int*>(smem);
  int* const ptab = htab + f32_round4(nh);
  for (int i = tid; i < nh; i += nthreads)
    htab[i] = (i / (HX * HY)) << 20 | (i / HX % HY) << 10 | i % HX;
  for (int i = tid; i < P; i += nthreads)
    ptab[i] = (i / (tw * th)) << 20 | (i / tw % th) << 10 | i % tw;
  __syncthreads();

  // stage brick `brick` into slot s; offsets inside the sample are 32-bit
  // (the wrapper checks D * H * W * max(C, CO) < 2^31)
  auto issue = [&](long long brick, int s) {
    long long bi = brick;
    const int bx = (int)(bi % a.nbx);
    bi /= a.nbx;
    const int by = (int)(bi % a.nby);
    bi /= a.nby;
    const int bz = (int)(bi % a.nbz);
    const int b = (int)(bi / a.nbz);
    const int z0 = bz * td, y0 = by * th, x0 = bx * tw;
    const Tin* const xb = static_cast<const Tin*>(a.x) + (long long)b * D * H * W * C;
    const Tin* const gb = static_cast<const Tin*>(a.dy) + (long long)b * D * H * W * CO;
    float* const xs = ring + s * slot_f;
    float* const ds = xs + xs_f;
    if (kF32 && a.vec_x) {  // ci / 4 pieces a position (a power of two), zero past C
      const int qs = 31 - __clz(cib >> 2);
      for (int i = tid; i < nh << qs; i += nthreads) {
        const int pos = i >> qs, q = i & ((1 << qs) - 1);
        const int t = htab[pos];
        const int gz = z0 + oz + (t >> 20), gy = y0 - 1 + ((t >> 10) & 1023),
                  gx = x0 - 1 + (t & 1023);
        const bool ok = c0 + 4 * q < C && (unsigned)gz < (unsigned)D &&
                        (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
        const Tin* src = ok ? xb + Layout::inner(gz, gy, gx, c0 + 4 * q, H, W, C) : xb;
        cp_async16(smem_addr(xs + pos * ckp + 4 * q), src, ok ? 16 : 0);
      }
    } else {
      for (int c = 0; c < cib; ++c) {
        for (int pos = tid; pos < nh; pos += nthreads) {
          const int t = htab[pos];
          const int gz = z0 + oz + (t >> 20), gy = y0 - 1 + ((t >> 10) & 1023),
                    gx = x0 - 1 + (t & 1023);
          const bool ok = c0 + c < C && (unsigned)gz < (unsigned)D &&
                          (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
          const Tin* src = ok ? xb + Layout::inner(gz, gy, gx, c0 + c, H, W, C) : xb;
          if constexpr (kF32) {
            cp_async4(smem_addr(xs + pos * ckp + c), src, ok ? 4 : 0);
          } else {
            xs[pos * ckp + c] = ok ? to_f32(*src) : 0.f;
          }
        }
      }
    }
    const int ns = 31 - __clz(nt);  // nt is a power of two
    if (kF32 && a.vec_dy) {
      for (int i = tid; i < P << (ns - 2); i += nthreads) {
        const int p = i >> (ns - 2), q = i & ((1 << (ns - 2)) - 1);
        const int t = ptab[p];
        const int gz = z0 + (t >> 20), gy = y0 + ((t >> 10) & 1023), gx = x0 + (t & 1023);
        const bool ok = co0 + 4 * q < CO && gz < D && gy < H && gx < W;
        const Tin* src = ok ? gb + Layout::inner(gz, gy, gx, co0 + 4 * q, H, W, CO) : gb;
        cp_async16(smem_addr(ds + p * ntp + 4 * q), src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < P << ns; i += nthreads) {
        const int p = i >> ns, n = i & (nt - 1);
        const int t = ptab[p];
        const int gz = z0 + (t >> 20), gy = y0 + ((t >> 10) & 1023), gx = x0 + (t & 1023);
        const bool ok = co0 + n < CO && gz < D && gy < H && gx < W;
        const Tin* src = ok ? gb + Layout::inner(gz, gy, gx, co0 + n, H, W, CO) : gb;
        if constexpr (kF32) {
          cp_async4(smem_addr(ds + p * ntp + n), src, ok ? 4 : 0);
        } else {
          ds[p * ntp + n] = ok ? to_f32(*src) : 0.f;
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;

  const long long nb = a.nbricks > split ? (a.nbricks - split + a.splits - 1) / a.splits : 0;
  for (int i = 0; i < a.stages - 1; ++i) {
    if (i < nb) issue(split + (long long)i * a.splits, i);
    cp_async_commit();
  }
  for (long long k = 0; k < nb; ++k) {
    if (a.stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // brick k landed; every thread is done with brick k - 1
    if (k + a.stages - 1 < nb)
      issue(split + (k + a.stages - 1) * a.splits, (int)((k + a.stages - 1) % a.stages));
    cp_async_commit();
    const float* const xs = ring + (int)(k % a.stages) * slot_f;
    const float* const ds = xs + xs_f + g * 4;
    for (int row = pg; row < td * th; row += a.npg) {  // the brick's (z, y) rows
      const float* xp = xs + ((row / th) * HY + row % th) * HX * ckp;
      const float* dp = ds + row * tw * ntp;
#pragma unroll 2
      for (int px = 0; px < tw; ++px, xp += ckp, dp += ntp) {
        float xv[8], dv[8];
        if constexpr (RV == 4) {
          const float4 v0 = *reinterpret_cast<const float4*>(xp + xo[0]);
          const float4 v1 = *reinterpret_cast<const float4*>(xp + xo[1]);
          xv[0] = v0.x, xv[1] = v0.y, xv[2] = v0.z, xv[3] = v0.w;
          xv[4] = v1.x, xv[5] = v1.y, xv[6] = v1.z, xv[7] = v1.w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) xv[i] = xp[xo[i]];
        }
        const float4 d0 = *reinterpret_cast<const float4*>(dp);
        const float4 d1 = *reinterpret_cast<const float4*>(dp + (nt >> 1));
        dv[0] = d0.x, dv[1] = d0.y, dv[2] = d0.z, dv[3] = d0.w;
        dv[4] = d1.x, dv[5] = d1.y, dv[6] = d1.z, dv[7] = d1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(xv[i], dv[q], acc[i][q]);
      }
    }
  }
  cp_async_wait<0>();

  float* const dst = a.splits > 1 ? a.out + (long long)split * 27 * C * CO : a.out;
  // one (row, output channel) of the block's tile
  auto store = [&](int rgi, int gi, int e, float v) {
    const int i = e >> 3, q = e & 7;
    const int k = rgi * 8 + i;
    const int tl = k / cib, cl = k % cib;
    const int co = co0 + (q < 4 ? gi * 4 + q : (nt >> 1) + gi * 4 + q - 4);
    if (tl < taps && c0 + cl < C && co < CO)
      dst[((long long)(t0 + tl) * C + c0 + cl) * CO + co] = v;
  };
  if (a.npg == 1) {
#pragma unroll
    for (int e = 0; e < 64; ++e) store(rg, g, e, acc[e >> 3][e & 7]);
    return;
  }
  __syncthreads();  // the ring is free: it holds the position groups' tiles now
#pragma unroll
  for (int e = 0; e < 64; ++e) ring[e * nthreads + tid] = acc[e >> 3][e & 7];
  __syncthreads();
  const int rgn = R * G;  // threads of one position group
  for (int idx = tid; idx < rgn * 64; idx += nthreads) {
    const int e = idx / rgn, j = idx - e * rgn;
    float s = ring[e * nthreads + j];
    for (int k = 1; k < a.npg; ++k) s += ring[e * nthreads + k * rgn + j];
    store(j / G, j % G, e, s);
  }
}

template <typename Tin, typename Layout, int RV>
cudaError_t launch_conv3_f32_dw_inst(const F32DwArgs& a, dim3 grid, int threads, int smem_bytes,
                                     cudaStream_t stream) {
  auto kernel = conv3_f32_dw_kernel<Tin, Layout, RV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// x (B, D, H, W, C) and dy (B, D, H, W, CO) in the Layout, D/H/W full
// resolution; ws holds splits * 27 * C * CO floats (unused with one split);
// out (3, 3, 3, C, CO) f32. (td, th, tw, taps, ci, nt, npg, splits, stages,
// smem_bytes) is the wrapper's plan.
template <typename Layout>
int launch_conv3_f32_dw(const void* x, const void* dy, float* ws, float* out, int B, int D,
                        int H, int W, int C, int CO, int in_bf16, int td, int th, int tw,
                        int taps, int ci, int nt, int npg, int splits, int stages,
                        int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (td < 1 || th < 1 || tw < 1 || td > 1000 || th > 1000 || tw > 1000 ||
      (taps != 9 && taps != 27) || ci < 1 ||
      (nt != 8 && nt != 16 && nt != 32 && nt != 64) || npg < 1 || npg > td * th || splits < 1 ||
      stages < 2 || stages > 3 || C < 1 || CO < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = f32_dw_threads(taps, ci, nt, npg);
  const long long n_tiles = (27LL / taps) * ((C + ci - 1) / ci) * ((CO + nt - 1) / nt);
  if (threads > F32_MAX_THREADS || threads < 32 || n_tiles > 65535 ||
      smem_bytes != f32_dw_smem_bytes(td, th, tw, taps, ci, nt, npg, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  F32DwArgs a;
  a.x = x, a.dy = dy, a.out = splits > 1 ? ws : out;
  a.B = B, a.D = D, a.H = H, a.W = W, a.C = C, a.CO = CO;
  a.td = td, a.th = th, a.tw = tw, a.taps = taps, a.ci = ci, a.nt = nt, a.npg = npg;
  a.splits = splits, a.stages = stages;
  a.nbz = (D + td - 1) / td, a.nby = (H + th - 1) / th, a.nbx = (W + tw - 1) / tw;
  a.nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  a.vec_x = !in_bf16 && C % 4 == 0 && ci >= 4 && (ci & (ci - 1)) == 0 && aligned(x);
  a.vec_dy = !in_bf16 && CO % 4 == 0 && aligned(dy);
  const dim3 grid((unsigned)splits, (unsigned)n_tiles);
  const bool rv4 = ci % 4 == 0;
  cudaError_t err;
  if (in_bf16) {
    err = rv4 ? launch_conv3_f32_dw_inst<__nv_bfloat16, Layout, 4>(a, grid, threads, smem_bytes,
                                                                   s)
              : launch_conv3_f32_dw_inst<__nv_bfloat16, Layout, 1>(a, grid, threads, smem_bytes,
                                                                   s);
  } else {
    err = rv4 ? launch_conv3_f32_dw_inst<float, Layout, 4>(a, grid, threads, smem_bytes, s)
              : launch_conv3_f32_dw_inst<float, Layout, 1>(a, grid, threads, smem_bytes, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = 27LL * C * CO;
  dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ws, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segk
