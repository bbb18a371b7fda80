// One rotation group of the augmentation's shear chain: the three passes
//   shear(a <- b, s0), shear(b <- a, s1), shear(a <- b, s2)
// in the (a, b) plane of a batch of channel-first volumes, for every index of
// the third axis c, with per-sample coefficients, an optional folded zoom per
// pass and shrinking center windows (segmantic_tpu_torch/ops/shear_resample.py
// is the plain version: shear_pass three times).
//
// Replaces the Pallas kernel exp/fused_shear_pallas.py::make_group_kernel. That
// kernel keeps a (144, 144, 128-row) tile resident in VMEM across the three
// passes and multiplies by banded interpolation matrices built in the kernel
// (the TPU's matrix unit is its fast path). Here the band is interpolated
// directly: order 1 reads two neighbours, order 0 copies one, so no matrix is
// formed. What is kept is the residency: a block loads the plane of one
// (sample, channel, c-chunk) into shared memory, runs passes 0 and 1 between
// two shared buffers and writes pass 2 straight to global memory, so a group
// reads its input once and writes its output once.
//
// What bounds it on the card: device-memory bytes (a few operations per
// element and pass). What the design does about it: one read and one write per
// group instead of three of each. Where the plane holds the memory-minor axis
// (groups in the (H, W) and (D, W) planes) loads and stores are coalesced
// along it; where the minor axis is the third axis (the (D, H) plane) a block
// takes a chunk of `wc` neighbours along it, as many as two plane buffers
// leave room for in the 227 KB a block may use, so that accesses are at least
// 4 bytes wide; neighbouring blocks share the 32-byte sectors through L2.
//
// Numerics, as the plain version: positions in f32 with every operation
// rounded on its own (no FMA contraction), the full-frame position first and
// the window offset subtracted last; floor(pos + 0.5) for order 0; for order
// 1 the weights 1 - frac and frac (rounded to bf16 with the samples when
// `round_w`), two products summed in f32, and each pass rounded to the carry
// type T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Pass {
  int n_in;      // input extent of the sheared axis
  int n_other;   // extent of the plane's other axis (indexes the coefficient)
  int n_out;     // output extent of the sheared axis (center window)
  int use_zoom;  // merged shear + scale about the full frame
  int frame;     // full-frame extent of the sheared axis (zoom passes)
};

struct Group {
  Pass p[3];
  int nc, wc, channels, order, round_w;
  int64_t in_sa, in_sb, in_sc, in_sn;      // element strides: a, b, c, image
  int64_t out_sa, out_sb, out_sc, out_sn;
};

template <typename T> struct Conv;
template <> struct Conv<float> {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float zero() { return 0.f; }
};
template <> struct Conv<__nv_bfloat16> {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
};
template <> struct Conv<uint8_t> {
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ uint8_t zero() { return 0; }
};
template <> struct Conv<int32_t> {
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ int32_t zero() { return 0; }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Input coordinate along the sheared axis for output index o on the line with
// index `other` of the plane's second axis.
__device__ __forceinline__ float position(int o, int other, const Pass& p, float s, float zoom) {
  const float rel = __fsub_rn((float)other, 0.5f * (float)(p.n_other - 1));
  const float o_glob = (float)(o + (p.n_in - p.n_out) / 2);
  const float shift = __fmul_rn(s, rel);
  if (!p.use_zoom) return __fsub_rn(o_glob, shift);
  const float off_in = (float)((p.frame - p.n_in) / 2);
  const float c_f = 0.5f * (float)(p.frame - 1);
  float v = __fdiv_rn(__fsub_rn(__fadd_rn(o_glob, off_in), c_f), zoom);
  v = __fsub_rn(__fadd_rn(v, c_f), shift);
  return __fsub_rn(v, off_in);
}

// One output sample from the line `line[i * stride]`, i = 0 .. n_in - 1.
template <typename T>
__device__ __forceinline__ T interp(const T* line, int stride, int n_in, float pos, int order,
                                    int round_w) {
  if (order == 0) {
    const int idx = (int)floorf(__fadd_rn(pos, 0.5f));
    return (idx >= 0 && idx <= n_in - 1) ? line[idx * stride] : Conv<T>::zero();
  }
  if constexpr (Conv<T>::kFloat) {
    if (!(pos >= 0.f && pos <= (float)(n_in - 1))) return Conv<T>::zero();
    const int lo = min(max((int)floorf(pos), 0), n_in - 2);
    float w1 = __fsub_rn(pos, (float)lo);
    float w0 = __fsub_rn(1.f, w1);
    float x0 = Conv<T>::to_f(line[lo * stride]);
    float x1 = Conv<T>::to_f(line[(lo + 1) * stride]);
    if (round_w) {
      w0 = round_bf16(w0);
      w1 = round_bf16(w1);
      x0 = round_bf16(x0);
      x1 = round_bf16(x1);
    }
    return Conv<T>::from_f(__fadd_rn(__fmul_rn(w0, x0), __fmul_rn(w1, x1)));
  } else {
    return Conv<T>::zero();  // order 1 on an integer type is refused by the host
  }
}

template <typename T>
__global__ void shear_group_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   const float* __restrict__ coef,
                                   const float* __restrict__ zoom, Group g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Pass p0 = g.p[0], p1 = g.p[1], p2 = g.p[2];
  const int A0 = p0.n_in, B0 = p0.n_other, A1 = p0.n_out, B1 = p1.n_out, A2 = p2.n_out;
  const int wc = g.wc;
  T* buf0 = reinterpret_cast<T*>(smem_raw);  // the input plane, then pass 1's output
  T* buf1 = buf0 + (int64_t)A0 * B0 * wc;    // pass 0's output

  const int chunks = (g.nc + wc - 1) / wc;
  const int chunk = blockIdx.x % chunks;
  const int img = blockIdx.x / chunks;  // sample * channels + channel
  const int sample = img / g.channels;
  const int c0 = chunk * wc;
  const float s0 = coef[sample * 3], s1 = coef[sample * 3 + 1], s2 = coef[sample * 3 + 2];
  const float z = zoom[sample];
  const int tid = threadIdx.x, nt = blockDim.x;

  // items run c fastest, then b, then a: with wc == 1 consecutive threads take
  // consecutive b, the memory-minor axis of the planes that hold it
  const T* xin = x + (int64_t)img * g.in_sn + (int64_t)c0 * g.in_sc;
  for (int i = tid; i < A0 * B0 * wc; i += nt) {
    const int c = i % wc, r = i / wc;
    const int b = r % B0, a = r / B0;
    buf0[i] = (c0 + c < g.nc) ? xin[a * g.in_sa + b * g.in_sb + c * g.in_sc] : Conv<T>::zero();
  }
  __syncthreads();
  // pass 0: a <- b, (A0, B0) -> (A1, B0)
  for (int i = tid; i < A1 * B0 * wc; i += nt) {
    const int c = i % wc, r = i / wc;
    const int b = r % B0, o = r / B0;
    buf1[i] = interp(buf0 + b * wc + c, B0 * wc, A0, position(o, b, p0, s0, z), g.order,
                     g.round_w);
  }
  __syncthreads();
  // pass 1: b <- a, (A1, B0) -> (A1, B1)
  for (int i = tid; i < A1 * B1 * wc; i += nt) {
    const int c = i % wc, r = i / wc;
    const int o = r % B1, a = r / B1;
    buf0[i] = interp(buf1 + a * B0 * wc + c, wc, B0, position(o, a, p1, s1, z), g.order,
                     g.round_w);
  }
  __syncthreads();
  // pass 2: a <- b, (A1, B1) -> (A2, B1), straight to global memory
  T* yout = y + (int64_t)img * g.out_sn + (int64_t)c0 * g.out_sc;
  for (int i = tid; i < A2 * B1 * wc; i += nt) {
    const int c = i % wc, r = i / wc;
    const int b = r % B1, o = r / B1;
    if (c0 + c >= g.nc) continue;
    yout[o * g.out_sa + b * g.out_sb + c * g.out_sc] =
        interp(buf0 + b * wc + c, B1 * wc, A1, position(o, b, p2, s2, z), g.order, g.round_w);
  }
}

template <typename T>
int launch_group(const void* x, void* y, const float* coef, const float* zoom, const Group& g,
                 int n_img, cudaStream_t stream) {
  const Pass& p0 = g.p[0];
  const size_t smem =
      ((size_t)p0.n_in * p0.n_other + (size_t)p0.n_out * p0.n_other) * g.wc * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(shear_group_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (g.nc + g.wc - 1) / g.wc;
  shear_group_kernel<T><<<(unsigned)(n_img * chunks), 512, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), coef, zoom, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x (S, C, *spatial) and y (S, C, *out spatial) of one type: dtype 0 f32, 1 bf16,
// 2 uint8, 3 int32. coef (S, 3) f32 and zoom (S,) f32 on the device. passes:
// host array of 15 ints, (n_in, n_other, n_out, use_zoom, frame) per pass.
// strides: host array of 8 ints, the element strides of a, b, c and of one
// image for x, then for y. n_img = S * C; nc the extent of the third axis; wc
// the chunk of it a block takes.
extern "C" int segk_shear_group(const void* x, void* y, const float* coef, const float* zoom,
                                const int* passes, const int* strides, int dtype, int n_img,
                                int channels, int nc, int wc, int order, int round_w,
                                void* stream) {
  Group g;
  for (int j = 0; j < 3; ++j) {
    g.p[j].n_in = passes[5 * j];
    g.p[j].n_other = passes[5 * j + 1];
    g.p[j].n_out = passes[5 * j + 2];
    g.p[j].use_zoom = passes[5 * j + 3];
    g.p[j].frame = passes[5 * j + 4];
  }
  g.nc = nc;
  g.wc = wc;
  g.channels = channels;
  g.order = order;
  g.round_w = round_w;
  g.in_sa = strides[0];
  g.in_sb = strides[1];
  g.in_sc = strides[2];
  g.in_sn = strides[3];
  g.out_sa = strides[4];
  g.out_sb = strides[5];
  g.out_sc = strides[6];
  g.out_sn = strides[7];
  if (n_img <= 0 || nc <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_group<float>(x, y, coef, zoom, g, n_img, s);
    case 1: return launch_group<__nv_bfloat16>(x, y, coef, zoom, g, n_img, s);
    case 2: return launch_group<uint8_t>(x, y, coef, zoom, g, n_img, s);
    case 3: return launch_group<int32_t>(x, y, coef, zoom, g, n_img, s);
  }
  return (int)cudaErrorInvalidValue;
}
