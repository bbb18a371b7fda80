// Register-tiled f32 body of the two stride-1 SAME 3x3x3 convolution
// kernels (fused_conv.cu: dense NDHWC tensors; phase_conv.cu: phase-major
// tensors that stand for a 2x-upsampled volume) on the H100's CUDA cores:
// f32 input (the 3D i2i generator, f32 training and the parity checks), and
// bf16 input whose channel count fits no tensor-core body (C > 8 and not a
// multiple of 8). Exact f32 FFMA only: no TF32, so the f32 paths keep their
// ~1e-6 agreement with the CPU.
//
// The conv is an implicit GEMM: M = output positions, N = output channels,
// K = 27 taps x C input channels. A block owns a brick of td x th x tw output
// positions of one sample (grid.x), an N tile of nt output channels (grid.y)
// and one K split (grid.z). Its threads are the brick's rows of PW = 4
// consecutive W positions times nt / TC channel groups (TC = 8), and each
// holds a PW x TC register tile (32 accumulators; a tile of 8 x 4 was slower
// at every row timed but one, by up to 2.3x). K is walked in units
// of (channel chunk of ck <= 16 channels, plane offset dz): per unit the
// td planes of the (th+2) x (tw+2) halo of ck channels and the [ck][9][nt]
// weight slab are staged by cp.async (16-byte pieces where the channel
// vectors allow, else 4-byte ones; bf16 is converted by plain loads) into a
// ring of 2-3 slots, so the next units land under the current FMAs. The
// halo is then turned channel-major in one more buffer ([c][z][y][x], rows
// pitched at 4 mod 8 floats) so that a thread reads the PW + 2 values of
// one input row with two vector loads and uses them for the three dx taps;
// the weights are read as two float4 along N, nt / 2 apart, so a warp's
// quads are contiguous. Per (channel, dy) a thread issues 8 shared loads for
// 96 FMAs.
//
// Accuracy: each accumulator sums one channel chunk (27 * ck <= 432
// products, c, dy, dx order) into a fresh partial that is then added to its
// total; with K splits (small volumes, so that the blocks fill the card) the
// splits' f32 totals are summed in split order by a second kernel, which
// applies the epilogue (y = acc * scale + shift, then none / relu / prelu)
// after the sum. No chain is longer than 432 products plus one add per chunk
// and one per split.
//
// The geometry (brick, nt, ck, splits, ring depth) is the wrapper's plan
// (ops/fused_conv.py::f32_plan); the launcher refuses a plan whose shared
// memory differs from f32_smem_bytes.
//
// What bounds it on the card: the FMAs (the f32 peak), at every row but the
// one-channel phase layer, whose output bytes bound it. The staging was the
// largest cost past the FMAs, ~40% of a 16^3 x 256 call while every staged
// piece divided its halo position out (H100); the positions' (z, y, x) now
// sit in a table built once a block, offsets inside a sample are 32-bit, and
// the call took a quarter less.
#pragma once

#include <type_traits>

#include "conv3_mma.cuh"

namespace segk {

constexpr int F32_MAX_THREADS = 256;
constexpr int F32_PW = 4;  // W positions a thread
constexpr int F32_TC = 8;  // output channels a thread

__host__ __device__ constexpr int f32_round4(int n) { return (n + 3) & ~3; }
// Row pitch of the channel-major halo: >= tw + 2 floats and 4 mod 8, so the
// rows of a warp start on distinct 16-byte bank groups.
__host__ __device__ constexpr int f32_row_pitch(int tw) {
  return tw + 2 + ((4 - (tw + 2) % 8) + 8) % 8;
}

// 4-byte words: a ring slot holds the staged halo ([td][th+2][tw+2][ck],
// channel pitch rounded to 4) and the weight slab ([ck][9][nt]); then one
// channel-major halo and the table of the halo positions' (z, y, x).
inline int f32_smem_bytes(int td, int th, int tw, int nt, int ck, int stages) {
  const int npos = td * (th + 2) * (tw + 2);
  const int raw = npos * f32_round4(ck);
  const int wt = ck * 9 * nt;
  const int xp = ck * td * (th + 2) * f32_row_pitch(tw);
  return 4 * (stages * (raw + wt) + xp + f32_round4(npos));
}

// 4 bytes global -> shared; src_bytes = 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

struct F32Args {
  const void* x;
  const void* w;  // (3, 3, 3, C, CO) DHWIO
  const float* scale;
  const float* shift;
  const float* alpha;
  void* out;  // the result (one split), or the f32 partials [split][position][CO]
  int relu_mode;
  int B, D, H, W, C, CO;  // full-resolution extents
  int td, th, tw, nt, ck, splits, stages;
  int nbz, nby, nbx;
  int vec_x, vec_w;  // 16-byte pieces of x / of the weights
};

template <typename Tin, typename Tout, typename Layout>
__global__ void __launch_bounds__(F32_MAX_THREADS, 2) conv3_f32_kernel(const F32Args a) {
  constexpr int PW = F32_PW, TC = F32_TC;
  constexpr bool kF32 = std::is_same<Tin, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  float* const fs = reinterpret_cast<float*>(smem);

  const int td = a.td, th = a.th, tw = a.tw, nt = a.nt, ck = a.ck;
  const int D = a.D, H = a.H, W = a.W, C = a.C, CO = a.CO;
  const int HY = th + 2, HX = tw + 2;
  const int npos = td * HY * HX;
  const int ckp = f32_round4(ck);
  const int XP = f32_row_pitch(tw), PP = HY * XP, CP = td * PP;
  const int raw_f = npos * ckp, slot_f = raw_f + ck * 9 * nt;
  float* const xp = fs + a.stages * slot_f;
  const int nthreads = blockDim.x, tid = threadIdx.x;

  long long bi = blockIdx.x;
  const int bx = (int)(bi % a.nbx);
  bi /= a.nbx;
  const int by = (int)(bi % a.nby);
  bi /= a.nby;
  const int bz = (int)(bi % a.nbz);
  const int b = (int)(bi / a.nbz);
  const int z0 = bz * td, y0 = by * th, x0 = bx * tw;
  const int co0 = blockIdx.y * nt;
  const int split = blockIdx.z;
  const int nch = (C + ck - 1) / ck;
  const int units = 3 * nch;
  const int u0 = (int)((long long)split * units / a.splits);
  const int u1 = (int)((long long)(split + 1) * units / a.splits);

  const int G = nt / TC;
  const int g = tid % G;
  const int r = tid / G;
  const int rpp = tw / PW;  // rows of a brick row
  const int tz = r / (th * rpp);
  const int ty = (r / rpp) % th;
  const int tx = (r % rpp) * PW;

  const Tin* const xb = static_cast<const Tin*>(a.x) + (long long)b * D * H * W * C;
  const Tin* const w = static_cast<const Tin*>(a.w);
  int* const tab = reinterpret_cast<int*>(xp + ck * CP);  // each halo position's (z, y, x)
  for (int pos = tid; pos < npos; pos += nthreads)
    tab[pos] = (pos / (HX * HY)) << 20 | (pos / HX % HY) << 10 | pos % HX;
  __syncthreads();

  // stage unit u (channel chunk u / 3, plane offset u % 3) into slot s; a
  // halo position's (z, y, x) come from the table, offsets inside the sample
  // are 32-bit (the wrapper checks D * H * W * C < 2^31)
  auto issue = [&](int u, int s) {
    const int c0 = (u / 3) * ck, cn = min(ck, C - c0), dz = u % 3;
    float* const raw = fs + s * slot_f;
    float* const wsl = raw + raw_f;
    const int zb = z0 + dz - 1;
    if (kF32 && a.vec_x) {  // ck / 4 pieces a position (a power of two), zero past C
      const int qs = ck == 16 ? 2 : ck == 8 ? 1 : 0;
      for (int i = tid; i < npos << qs; i += nthreads) {
        const int pos = i >> qs, q = i & ((1 << qs) - 1);
        const int t = tab[pos];
        const int gz = zb + (t >> 20), gy = y0 - 1 + ((t >> 10) & 1023),
                  gx = x0 - 1 + (t & 1023);
        const bool ok = c0 + 4 * q < C && (unsigned)gz < (unsigned)D &&
                        (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
        const Tin* src = ok ? xb + Layout::inner(gz, gy, gx, c0 + 4 * q, H, W, C) : xb;
        cp_async16(smem_addr(raw + pos * ckp + 4 * q), src, ok ? 16 : 0);
      }
    } else {
      for (int c = 0; c < cn; ++c) {
        for (int pos = tid; pos < npos; pos += nthreads) {
          const int t = tab[pos];
          const int gz = zb + (t >> 20), gy = y0 - 1 + ((t >> 10) & 1023),
                    gx = x0 - 1 + (t & 1023);
          const bool ok = (unsigned)gz < (unsigned)D && (unsigned)gy < (unsigned)H &&
                          (unsigned)gx < (unsigned)W;
          const Tin* src = ok ? xb + Layout::inner(gz, gy, gx, c0 + c, H, W, C) : xb;
          if constexpr (kF32) {
            cp_async4(smem_addr(raw + pos * ckp + c), src, ok ? 4 : 0);
          } else {
            raw[pos * ckp + c] = ok ? to_f32(*src) : 0.f;
          }
        }
      }
    }
    // weight rows (c, tap) of nt values: w[(dz * 9 + tap) * C + c0 + c][co0 ...]
    const int ns = nt == 64 ? 6 : nt == 32 ? 5 : nt == 16 ? 4 : 3;  // nt is a power of two
    if (kF32 && a.vec_w) {
      for (int i = tid; i < (cn * 9) << (ns - 2); i += nthreads) {
        const int row = i >> (ns - 2), q = i & ((1 << (ns - 2)) - 1);
        const int c = row / 9, tap = row - c * 9;
        const bool ok = co0 + 4 * q < CO;
        const Tin* src = ok ? w + ((dz * 9 + tap) * C + c0 + c) * CO + co0 + 4 * q : w;
        cp_async16(smem_addr(wsl + row * nt + 4 * q), src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < (cn * 9) << ns; i += nthreads) {
        const int row = i >> ns, n = i & (nt - 1);
        const int c = row / 9, tap = row - c * 9;
        const bool ok = co0 + n < CO;
        const Tin* src = ok ? w + ((dz * 9 + tap) * C + c0 + c) * CO + co0 + n : w;
        if constexpr (kF32) {
          cp_async4(smem_addr(wsl + row * nt + n), src, ok ? 4 : 0);
        } else {
          wsl[row * nt + n] = ok ? to_f32(*src) : 0.f;
        }
      }
    }
  };

  // the staged halo of slot s, channel-major: xp[c][hz][hy][hx]
  auto transpose = [&](int s, int cn) {
    const float* const raw = fs + s * slot_f;
    for (int pos = tid; pos < npos; pos += nthreads) {
      const int t = tab[pos];
      float* const dst = xp + (t >> 20) * PP + ((t >> 10) & 1023) * XP + (t & 1023);
      const float* const src = raw + pos * ckp;
      int c = 0;
      for (; c + 4 <= cn; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + c);
        dst[c * CP] = v.x;
        dst[(c + 1) * CP] = v.y;
        dst[(c + 2) * CP] = v.z;
        dst[(c + 3) * CP] = v.w;
      }
      for (; c < cn; ++c) dst[c * CP] = src[c];
    }
  };

  float part[PW][TC], tot[PW][TC];
#pragma unroll
  for (int j = 0; j < PW; ++j)
#pragma unroll
    for (int q = 0; q < TC; ++q) part[j][q] = tot[j][q] = 0.f;

  const int n = u1 - u0;
  for (int i = 0; i < a.stages - 1; ++i) {
    if (i < n) issue(u0 + i, i);
    cp_async_commit();
  }
  const float* const xrow = xp + tz * PP + ty * XP + tx;
  for (int k = 0; k < n; ++k) {
    if (a.stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit k landed; every thread is done with unit k - 1
    if (k + a.stages - 1 < n) issue(u0 + k + a.stages - 1, (k + a.stages - 1) % a.stages);
    cp_async_commit();
    const int u = u0 + k;
    const int cn = min(ck, C - (u / 3) * ck);
    const int s = k % a.stages;
    transpose(s, cn);
    __syncthreads();
    const float* const wsl = fs + s * slot_f + raw_f + g * 4;
#pragma unroll 2
    for (int c = 0; c < cn; ++c) {
      const float* const xc = xrow + c * CP;
      const float* const wc = wsl + c * 9 * nt;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float row[PW + 2];
        const float* const xr = xc + dy * XP;
        const float4 r0 = *reinterpret_cast<const float4*>(xr);
        row[0] = r0.x, row[1] = r0.y, row[2] = r0.z, row[3] = r0.w;
        const float2 rt = *reinterpret_cast<const float2*>(xr + PW);
        row[PW] = rt.x, row[PW + 1] = rt.y;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float wv[TC];
          const float4 w0 = *reinterpret_cast<const float4*>(wc + (dy * 3 + dx) * nt);
          const float4 w1 = *reinterpret_cast<const float4*>(wc + (dy * 3 + dx) * nt + (nt >> 1));
          wv[0] = w0.x, wv[1] = w0.y, wv[2] = w0.z, wv[3] = w0.w;
          wv[4] = w1.x, wv[5] = w1.y, wv[6] = w1.z, wv[7] = w1.w;
#pragma unroll
          for (int j = 0; j < PW; ++j)
#pragma unroll
            for (int q = 0; q < TC; ++q) part[j][q] = fmaf(row[j + dx], wv[q], part[j][q]);
        }
      }
    }
    if (u % 3 == 2 || k == n - 1) {  // the chunk's 27 taps (or the split's share) are in
#pragma unroll
      for (int j = 0; j < PW; ++j)
#pragma unroll
        for (int q = 0; q < TC; ++q) {
          tot[j][q] += part[j][q];
          part[j][q] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  const int gz = z0 + tz, gy = y0 + ty;
  if (gz >= D || gy >= H) return;
  int cos[TC];
#pragma unroll
  for (int q = 0; q < TC; ++q)
    cos[q] = co0 + (q < 4 ? g * 4 + q : (nt >> 1) + g * 4 + q - 4);
  const bool quads = (CO & 3) == 0;
  if (a.splits == 1) {
    const float slope = a.relu_mode == 2 ? a.alpha[0] : 0.f;
    Tout* const out = static_cast<Tout*>(a.out);
#pragma unroll
    for (int j = 0; j < PW; ++j) {
      const int gx = x0 + tx + j;
      if (gx >= W) continue;
#pragma unroll
      for (int h = 0; h < TC / 4; ++h) {
        float y[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int co = min(cos[4 * h + q], CO - 1);
          y[q] = activate(tot[j][4 * h + q] * a.scale[co] + a.shift[co], a.relu_mode, slope);
        }
        const int cq = cos[4 * h];
        if (cq >= CO) continue;
        Tout* dst = out + Layout::offset(b, gz, gy, gx, cq, D, H, W, CO);
        if (std::is_same<Tout, float>::value && quads) {
          *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (cq + q < CO) dst[q] = from_f32<Tout>(y[q]);
        }
      }
    }
  } else {
    const long long P = (long long)a.B * D * H * W;
    float* const part_out = static_cast<float*>(a.out) + (long long)split * P * CO;
#pragma unroll
    for (int j = 0; j < PW; ++j) {
      const int gx = x0 + tx + j;
      if (gx >= W) continue;
      float* const dst = part_out + ((((long long)b * D + gz) * H + gy) * W + gx) * CO;
#pragma unroll
      for (int h = 0; h < TC / 4; ++h) {
        const int cq = cos[4 * h];
        if (cq >= CO) continue;
        if (quads) {
          *reinterpret_cast<float4*>(dst + cq) = make_float4(
              tot[j][4 * h], tot[j][4 * h + 1], tot[j][4 * h + 2], tot[j][4 * h + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (cq + q < CO) dst[cq + q] = tot[j][4 * h + q];
        }
      }
    }
  }
}

// out at (b, z, y, x, co) = act((sum over the splits, in order, of
// ws[split][((b * D + z) * H + y) * W + x][co]) * scale[co] + shift[co]).
template <typename Tout, typename Layout>
__global__ void conv3_f32_reduce_kernel(const float* __restrict__ ws,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift,
                                        const float* __restrict__ alpha, int relu_mode,
                                        Tout* __restrict__ out, long long n, int D, int H,
                                        int W, int CO, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = ws[i];
  for (int k = 1; k < splits; ++k) s += ws[k * n + i];
  const int co = (int)(i % CO);
  long long pos = i / CO;
  const int x = (int)(pos % W);
  pos /= W;
  const int y = (int)(pos % H);
  pos /= H;
  const int z = (int)(pos % D);
  const int b = (int)(pos / D);
  const float slope = relu_mode == 2 ? alpha[0] : 0.f;
  out[Layout::offset(b, z, y, x, co, D, H, W, CO)] =
      from_f32<Tout>(activate(s * scale[co] + shift[co], relu_mode, slope));
}

template <typename Tin, typename Tout, typename Layout>
cudaError_t launch_conv3_f32_typed(const F32Args& a, dim3 grid, int threads, int smem_bytes,
                                   float* ws, void* out, cudaStream_t s) {
  auto kernel = conv3_f32_kernel<Tin, Tout, Layout>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long n = (long long)a.B * a.D * a.H * a.W * a.CO;
  conv3_f32_reduce_kernel<Tout, Layout><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      ws, a.scale, a.shift, a.alpha, a.relu_mode, static_cast<Tout*>(out), n, a.D, a.H, a.W,
      a.CO, a.splits);
  return cudaGetLastError();
}

// x (B, D, H, W, C) and out (B, D, H, W, CO) in the Layout (D, H, W full
// resolution), w (3, 3, 3, C, CO); in_bf16: x and w are bf16 (else f32),
// out_bf16: out is bf16 (else f32). ws holds splits * B * D * H * W * CO
// floats (unused with one split). (td, th, tw, nt, ck, splits, stages,
// smem_bytes) is the wrapper's plan.
template <typename Layout>
int launch_conv3_f32(const void* x, const void* w, const float* scale, const float* shift,
                     const float* alpha, int relu_mode, void* out, float* ws, int B, int D,
                     int H, int W, int C, int CO, int in_bf16, int out_bf16, int td,
                     int th, int tw, int nt, int ck, int splits, int stages, int smem_bytes,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (td < 1 || th < 1 || tw < F32_PW || tw % F32_PW ||
      (nt != 16 && nt != 32 && nt != 64) || ck < 1 || ck > 16 || stages < 2 || stages > 3 ||
      C < 1 || CO < 1 || splits < 1 || (!in_bf16 && out_bf16) || td > 1000 || th > 1000 ||
      tw > 1000)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = td * th * (tw / F32_PW) * (nt / F32_TC);
  const int nch = (C + ck - 1) / ck;
  if (threads < 32 || threads > F32_MAX_THREADS || splits > 3 * nch ||
      27LL * C * CO >= 1LL << 31 || smem_bytes != f32_smem_bytes(td, th, tw, nt, ck, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  F32Args a;
  a.x = x, a.w = w, a.scale = scale, a.shift = shift, a.alpha = alpha;
  a.out = splits > 1 ? static_cast<void*>(ws) : out;
  a.relu_mode = relu_mode;
  a.B = B, a.D = D, a.H = H, a.W = W, a.C = C, a.CO = CO;
  a.td = td, a.th = th, a.tw = tw, a.nt = nt, a.ck = ck, a.splits = splits, a.stages = stages;
  a.nbz = (D + td - 1) / td, a.nby = (H + th - 1) / th, a.nbx = (W + tw - 1) / tw;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  a.vec_x = !in_bf16 && C % 4 == 0 && (ck == 4 || ck == 8 || ck == 16) && aligned(x);
  a.vec_w = !in_bf16 && CO % 4 == 0 && aligned(w);
  const long long nbricks = (long long)B * a.nbz * a.nby * a.nbx;
  const int n_tiles = (CO + nt - 1) / nt;
  if (nbricks > 0x7fffffffLL || n_tiles > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)nbricks, n_tiles, splits);
  cudaError_t err;
  if (!in_bf16) {
    err = launch_conv3_f32_typed<float, float, Layout>(a, grid, threads, smem_bytes, ws, out, s);
  } else if (out_bf16) {
    err = launch_conv3_f32_typed<__nv_bfloat16, __nv_bfloat16, Layout>(
        a, grid, threads, smem_bytes, ws, out, s);
  } else {
    err = launch_conv3_f32_typed<__nv_bfloat16, float, Layout>(a, grid, threads, smem_bytes, ws,
                                                               out, s);
  }
  return static_cast<int>(err);
}

}  // namespace segk
