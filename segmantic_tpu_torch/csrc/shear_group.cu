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
// (sample, channel, c-chunk) into shared memory, runs the three passes there
// and writes the result out, so a group reads its input once and writes its
// output once.
//
// What bounds it on the card: device-memory bytes (a few operations per
// element and pass). A first version was bound by instruction count and by
// one resident block per SM instead: divisions to take a flat index apart per
// element, the whole position (with a division in zoom passes) per element,
// two plane buffers. What this design does about each:
//  - One plane buffer, passes in place. A pass works on lines that do not
//    depend on each other (pass 0 and 2 on the lines along a, pass 1 on those
//    along b), so a warp takes a whole line: every lane computes its outputs
//    of the line into registers (kMaxPerLane full rounds of 32 and a partial
//    one), the warp synchronises, and the lanes write them over the line. An
//    output window stays centered in its line, so nothing is compacted or
//    moved. One buffer instead of two leaves at least two blocks on an SM for
//    every type at the 144 x 144 planes of the training chain, so one block's
//    load, barrier or write-out hides behind another's passes. Lines longer
//    than 32 * kMaxPerLane take a whole block per line through a scratch line.
//  - What a line shares is computed once per line (the shift s * rel); what an
//    output index shares is computed once per block and pass into a table in
//    shared memory (the window offset and, in zoom passes, the division). Per
//    element the position costs one load and two subtractions. The values are
//    the same floats as before, each operation rounded on its own, so the
//    results are too.
//  - Index and weights are shared by all elements at one (output, line):
//    where the third axis is the memory-minor one (the (D, H) plane) a block
//    takes WC neighbours along it packed into one unit of up to 4 bytes (2
//    bf16, 4 uint8; a wider unit would leave one block per SM); elsewhere it
//    takes CP = 2 neighbouring planes, where two such blocks still fit an SM
//    and the grid still gives every SM two blocks.
//  - No % or / per element: warps walk rows or lines, lanes walk along them.
//    No conversion instructions per element either (they run at a quarter
//    of an add's rate): floor and int-to-float go through the mantissa of
//    2^23 + v. The sampler has no branch: an index outside the line is
//    clamped for the loads and the result replaced by zero.
//  - Rows in shared memory are padded to an odd number of 32-bit words, so
//    lanes that walk a line across rows hit distinct banks.
//  - A plane too large for one block's shared memory (the 2D flagship's
//    384 x 384 bf16 margin patch: 297 KB) lives in a global scratch buffer of
//    the block's own instead (segk_shear_group_global; GLOBAL below), served
//    by L1 and L2. The traversal, the passes in place and the barriers are
//    the same; the position tables or the scratch line stay in shared memory.
//  - Where the plane holds the memory-minor axis, global loads and the final
//    stores move 16 bytes a thread along it (8 bf16, 16 uint8, 4 f32): the
//    last pass also writes in place, and a copy-out phase stores whole
//    vectors. Unaligned or odd extents take element accesses, still
//    coalesced along the rows. In the (D, H) plane a block's accesses are its
//    4-byte units, 4 bytes of every 32-byte sector: neighbouring blocks share
//    the sectors through L2, whose bandwidth bounds that group.
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

constexpr int kMaxPerLane = 8;  // full rounds of 32 outputs of one line held in registers

struct Pass {
  int n_in;      // input extent of the sheared axis
  int n_other;   // extent of the plane's other axis (indexes the coefficient)
  int n_out;     // output extent of the sheared axis (center window)
  int use_zoom;  // merged shear + scale about the full frame
  int frame;     // full-frame extent of the sheared axis (zoom passes)
};

struct Group {
  Pass p[3];
  int nc, channels, round_w;
  int row_units;    // row stride of the plane buffer in units (padded)
  int block_lines;  // lines too long for a warp's registers: a block per line
  int vec_in, vec_out;                     // 16-byte rows of x / of y
  int64_t in_sa, in_sb, in_sc, in_sn;      // element strides: a, b, c, image
  int64_t out_sa, out_sb, out_sc, out_sn;
};

// A unit is what one shared-memory slot holds: WC neighbours along the third
// axis, kept as raw bits.
template <int BYTES> struct Bits;
template <> struct Bits<1> { using type = uint8_t; };
template <> struct Bits<2> { using type = uint16_t; };
template <> struct Bits<4> { using type = uint32_t; };

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ float to_f(uint32_t bits) { return __uint_as_float(bits); }
  static __device__ __forceinline__ uint32_t from_f(float v) { return __float_as_uint(v); }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ float to_f(uint32_t bits) {
    return __uint_as_float(bits << 16);  // exact, as __bfloat162float
  }
  static __device__ __forceinline__ uint32_t from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Elem<uint8_t> {  // order 1 on an integer type is refused by the host
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ float to_f(uint32_t) { return 0.f; }
  static __device__ __forceinline__ uint32_t from_f(float) { return 0; }
};
template <> struct Elem<int32_t> : Elem<uint8_t> {};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The part of the input coordinate that output index o fixes; the line's
// shift (and in zoom passes the input window's offset) is subtracted per line.
__device__ __forceinline__ float position_of_output(int o, const Pass& p, float zoom) {
  const float o_glob = (float)(o + (p.n_in - p.n_out) / 2);
  if (!p.use_zoom) return o_glob;
  const float off_in = (float)((p.frame - p.n_in) / 2);
  const float c_f = 0.5f * (float)(p.frame - 1);
  return __fadd_rn(__fdiv_rn(__fsub_rn(__fadd_rn(o_glob, off_in), c_f), zoom), c_f);
}

// floor(v) as an int without a conversion instruction (those run at a
// quarter of the rate of an add): adding 2^23 rounding down leaves
// 2^23 + floor(v) in the mantissa for -2^22 < v < 2^22. Beyond that range, and
// for NaN, the result lies outside [0, 2^22), which every caller treats as
// outside its line (extents are far below 2^22: a line fits in shared memory).
__device__ __forceinline__ int floor_to_int(float v) {
  return __float_as_int(__fadd_rd(v, 8388608.f)) - 0x4B000000;
}

// The outputs of CP planes at one position of the line `line[i * stride]`,
// i = 0 .. n_in - 1 (plane q lies q * plane units further): index and weights
// are the planes' to share. No branch: an index outside the line is clamped
// for the loads and the result replaced by zero.
template <typename T, int WC, int CP, int ORDER>
__device__ __forceinline__ void sample(const typename Bits<sizeof(T) * WC>::type* line,
                                       int stride, int plane, int n_in, float pos, int round_w,
                                       typename Bits<sizeof(T) * WC>::type (&out)[CP]) {
  using U = typename Bits<sizeof(T) * WC>::type;
  if constexpr (ORDER == 0) {
    const int idx = floor_to_int(__fadd_rn(pos, 0.5f));
    const bool valid = (unsigned)idx < (unsigned)n_in;
    const U* at = line + (valid ? idx : 0) * stride;
#pragma unroll
    for (int q = 0; q < CP; ++q) out[q] = valid ? at[q * plane] : (U)0;
  } else {
    const bool valid = pos >= 0.f && pos <= (float)(n_in - 1);
    const int lo = min(max(floor_to_int(pos), 0), n_in - 2);
    // (float)lo, exactly: 2^23 + lo in the mantissa, minus 2^23
    float w1 = __fsub_rn(pos, __fsub_rn(__int_as_float(lo + 0x4B000000), 8388608.f));
    float w0 = __fsub_rn(1.f, w1);
    if (round_w) {
      w0 = round_bf16(w0);
      w1 = round_bf16(w1);
    }
    const U* at = line + lo * stride;
    constexpr int kBits = 8 * sizeof(T);
    constexpr uint32_t kMask = sizeof(T) == 4 ? 0xffffffffu : ((1u << (kBits % 32)) - 1u);
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const uint32_t u0 = at[q * plane], u1 = at[q * plane + stride];
      uint32_t bits = 0;
#pragma unroll
      for (int e = 0; e < WC; ++e) {
        float x0 = Elem<T>::to_f((u0 >> (e * kBits % 32)) & kMask);
        float x1 = Elem<T>::to_f((u1 >> (e * kBits % 32)) & kMask);
        if (sizeof(T) == 4 && round_w) {  // bf16 samples are bf16 already
          x0 = round_bf16(x0);
          x1 = round_bf16(x1);
        }
        const float v = __fadd_rn(__fmul_rn(w0, x0), __fmul_rn(w1, x1));
        bits |= Elem<T>::from_f(v) << (e * kBits % 32);
      }
      out[q] = valid ? (U)bits : (U)0;
    }
  }
}

// One unit from / to global memory: WC elements at p[0 .. WC-1], of which the
// first `valid` lie inside the third axis (the rest read as zero).
template <typename T, int WC>
__device__ __forceinline__ typename Bits<sizeof(T) * WC>::type load_unit(const T* p, int valid) {
  using U = typename Bits<sizeof(T) * WC>::type;
  using E = typename Bits<sizeof(T)>::type;
  if (WC == 1) return *reinterpret_cast<const U*>(p);
  if (valid >= WC && (reinterpret_cast<uintptr_t>(p) & (sizeof(U) - 1)) == 0)
    return *reinterpret_cast<const U*>(p);
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < WC; ++e)
    if (e < valid)
      bits |= (uint32_t) reinterpret_cast<const E*>(p)[e] << (e * 8 * sizeof(T) % 32);
  return (U)bits;
}

template <typename T, int WC>
__device__ __forceinline__ void store_unit(T* p, typename Bits<sizeof(T) * WC>::type u,
                                           int valid) {
  using U = typename Bits<sizeof(T) * WC>::type;
  using E = typename Bits<sizeof(T)>::type;
  if (WC == 1 || (valid >= WC && (reinterpret_cast<uintptr_t>(p) & (sizeof(U) - 1)) == 0)) {
    *reinterpret_cast<U*>(p) = u;
    return;
  }
#pragma unroll
  for (int e = 0; e < WC; ++e)
    if (e < valid) reinterpret_cast<E*>(p)[e] = (E)((uint32_t)u >> (e * 8 * sizeof(T) % 32));
}

// One pass in place over CP planes that share their positions. `first` points
// at input index 0 of line 0 of plane 0; a line's samples lie `stride` units
// apart, its neighbours `line_stride` and the planes `plane`. Output o goes to
// index o + (n_in - n_out) / 2 of its line. `table[o]` holds
// position_of_output(o) where a warp takes a line; where a block does
// (`scratch` given) it is computed in place. Ends in a block barrier.
template <typename T, int WC, int CP, int ORDER>
__device__ __forceinline__ void run_pass(typename Bits<sizeof(T) * WC>::type* first,
                                         int line_stride, int stride, int plane, const Pass& p,
                                         float s, float zoom, int round_w, const float* table,
                                         typename Bits<sizeof(T) * WC>::type* scratch) {
  using U = typename Bits<sizeof(T) * WC>::type;
  const int off = (p.n_in - p.n_out) / 2;
  const float center = 0.5f * (float)(p.n_other - 1);
  // subtracted last in zoom passes; x - 0 is x, so the other passes subtract 0
  const float off_in = p.use_zoom ? (float)((p.frame - p.n_in) / 2) : 0.f;
  if (scratch == nullptr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int full = p.n_out >> 5;       // rounds in which every lane has an output
    const int o_tail = 32 * full + lane;  // the last, partial round
    const bool has_tail = o_tail < p.n_out;
    const float* of_output = table + lane;
    for (int line = warp; line < p.n_other; line += warps) {
      const float shift = __fmul_rn(s, __fsub_rn((float)line, center));
      U* at = first + line * line_stride;
      U vals[kMaxPerLane][CP], tail[CP];
#pragma unroll
      for (int k = 0; k < kMaxPerLane; ++k) {
        if (k >= full) break;
        sample<T, WC, CP, ORDER>(at, stride, plane, p.n_in,
                                 __fsub_rn(__fsub_rn(of_output[32 * k], shift), off_in),
                                 round_w, vals[k]);
      }
      if (has_tail)
        sample<T, WC, CP, ORDER>(at, stride, plane, p.n_in,
                                 __fsub_rn(__fsub_rn(of_output[32 * full], shift), off_in),
                                 round_w, tail);
      __syncwarp();  // the line is read: it may be overwritten
      U* to = at + (off + lane) * stride;
#pragma unroll
      for (int k = 0; k < kMaxPerLane; ++k) {
        if (k >= full) break;
#pragma unroll
        for (int q = 0; q < CP; ++q) to[q * plane + 32 * k * stride] = vals[k][q];
      }
      if (has_tail) {
#pragma unroll
        for (int q = 0; q < CP; ++q) to[q * plane + 32 * full * stride] = tail[q];
      }
    }
  } else {
    for (int line = 0; line < p.n_other; ++line) {
      const float shift = __fmul_rn(s, __fsub_rn((float)line, center));
      U* at = first + line * line_stride;
      for (int o = threadIdx.x; o < p.n_out; o += blockDim.x) {
        U vals[CP];
        sample<T, WC, CP, ORDER>(
            at, stride, plane, p.n_in,
            __fsub_rn(__fsub_rn(position_of_output(o, p, zoom), shift), off_in), round_w, vals);
#pragma unroll
        for (int q = 0; q < CP; ++q) scratch[q * p.n_out + o] = vals[q];
      }
      __syncthreads();
      for (int o = threadIdx.x; o < p.n_out; o += blockDim.x) {
#pragma unroll
        for (int q = 0; q < CP; ++q) at[q * plane + (off + o) * stride] = scratch[q * p.n_out + o];
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

// WC > 1: a block takes WC neighbours of a memory-minor third axis as one
// unit. CP > 1: it takes CP neighbours of a third axis that is not
// memory-minor as CP planes. Never both.
// GLOBAL: the planes lie in `planes`, CP * plane units a block, not in
// shared memory.
template <typename T, int WC, int CP, int ORDER, bool GLOBAL>
__global__ void __launch_bounds__(512, 2)
shear_group_kernel(const void* __restrict__ x_raw, void* __restrict__ y_raw, void* planes,
                   const float* __restrict__ coef, const float* __restrict__ zoom,
                   const Group g) {
  using U = typename Bits<sizeof(T) * WC>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Pass p0 = g.p[0], p1 = g.p[1], p2 = g.p[2];
  const int A0 = p0.n_in, B0 = p0.n_other, A1 = p0.n_out, B1 = p1.n_out, A2 = p2.n_out;
  const int row = g.row_units, plane = A0 * row;
  U* buf = GLOBAL ? reinterpret_cast<U*>(planes) + (int64_t)blockIdx.x * CP * plane
                  : reinterpret_cast<U*>(smem_raw);
  // behind the planes in shared memory: the passes' position tables, or the
  // scratch lines
  unsigned char* behind =
      GLOBAL ? smem_raw : reinterpret_cast<unsigned char*>(buf + CP * plane);
  float* table0 = reinterpret_cast<float*>(behind);
  float* table1 = table0 + p0.n_out;
  float* table2 = table1 + p1.n_out;
  U* scratch = g.block_lines ? reinterpret_cast<U*>(behind) : nullptr;

  const int chunks = (g.nc + WC * CP - 1) / (WC * CP);
  const int chunk = blockIdx.x % chunks;
  const int img = blockIdx.x / chunks;  // sample * channels + channel
  const int sample_i = img / g.channels;
  const int c0 = chunk * WC * CP;
  const int valid = min(WC * CP, g.nc - c0);  // elements of the unit, or planes, inside nc
  const float s0 = coef[sample_i * 3], s1 = coef[sample_i * 3 + 1], s2 = coef[sample_i * 3 + 2];
  const float z = zoom[sample_i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;

  // the planes into shared memory: warps take rows, lanes walk along b; a
  // plane beyond nc repeats the last one inside (computed, never stored)
  const T* xin = static_cast<const T*>(x_raw) + (int64_t)img * g.in_sn + (int64_t)c0 * g.in_sc;
#pragma unroll
  for (int q = 0; q < CP; ++q) {
    const T* xq = xin + (CP > 1 ? min(q, valid - 1) : 0) * g.in_sc;
    U* bq = buf + q * plane;
    if (g.vec_in) {
      const int vectors = B0 * (int)sizeof(T) / 16;
      for (int a = warp; a < A0; a += warps) {
        const uint4* src = reinterpret_cast<const uint4*>(xq + a * g.in_sa);
        uint32_t* dst = reinterpret_cast<uint32_t*>(bq + a * row);
        for (int v = lane; v < vectors; v += 32) {
          const uint4 w = src[v];
          dst[4 * v] = w.x;
          dst[4 * v + 1] = w.y;
          dst[4 * v + 2] = w.z;
          dst[4 * v + 3] = w.w;
        }
      }
    } else {
      for (int a = warp; a < A0; a += warps)
        for (int b = lane; b < B0; b += 32)
          bq[a * row + b] = load_unit<T, WC>(xq + a * g.in_sa + b * g.in_sb, valid);
    }
  }
  if (!g.block_lines) {
    for (int o = threadIdx.x; o < p0.n_out; o += blockDim.x)
      table0[o] = position_of_output(o, p0, z);
    for (int o = threadIdx.x; o < p1.n_out; o += blockDim.x)
      table1[o] = position_of_output(o, p1, z);
    for (int o = threadIdx.x; o < p2.n_out; o += blockDim.x)
      table2[o] = position_of_output(o, p2, z);
  }
  __syncthreads();

  // windows stay centered: after pass 0 the rows off_a .. off_a + A1 - 1 are
  // live, after pass 1 the columns off_b .. off_b + B1 - 1 of those rows
  const int off_a = (A0 - A1) / 2, off_b = (B0 - B1) / 2;
  // pass 0: a <- b, (A0, B0) -> (A1, B0): lines are columns
  run_pass<T, WC, CP, ORDER>(buf, 1, row, plane, p0, s0, z, g.round_w, table0, scratch);
  // pass 1: b <- a, (A1, B0) -> (A1, B1): lines are rows
  run_pass<T, WC, CP, ORDER>(buf + off_a * row, row, 1, plane, p1, s1, z, g.round_w, table1,
                             scratch);
  // pass 2: a <- b, (A1, B1) -> (A2, B1): lines are columns again
  run_pass<T, WC, CP, ORDER>(buf + off_a * row + off_b, 1, row, plane, p2, s2, z, g.round_w,
                             table2, scratch);

  // write-out: warps take rows, lanes walk along b
  T* yout = static_cast<T*>(y_raw) + (int64_t)img * g.out_sn + (int64_t)c0 * g.out_sc;
#pragma unroll
  for (int q = 0; q < CP; ++q) {
    if (CP > 1 && q >= valid) break;
    const U* res = buf + q * plane + (off_a + (A1 - A2) / 2) * row + off_b;
    T* yq = yout + q * g.out_sc;
    if (g.vec_out) {
      constexpr int kPer = 16 / (int)sizeof(T);  // WC == 1: a unit is an element
      const int vectors = B1 / kPer;
      for (int o = warp; o < A2; o += warps) {
        uint4* dst = reinterpret_cast<uint4*>(yq + o * g.out_sa);
        const U* src = res + o * row;
        for (int v = lane; v < vectors; v += 32) {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            w[i * (int)sizeof(T) / 4] |= (uint32_t)src[v * kPer + i]
                                         << (i * 8 * (int)sizeof(T) % 32);
          dst[v] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    } else {
      for (int o = warp; o < A2; o += warps)
        for (int b = lane; b < B1; b += 32)
          store_unit<T, WC>(yq + o * g.out_sa + b * g.out_sb, res[o * row + b], valid);
    }
  }
}

using KernelFn = void (*)(const void*, void*, void*, const float*, const float*, Group);

template <typename T, int WC, int CP, bool GLOBAL = false>
KernelFn kernel_of_order(int order) {
  if (order == 0) return shear_group_kernel<T, WC, CP, 0, GLOBAL>;
  if constexpr (Elem<T>::kFloat) return shear_group_kernel<T, WC, CP, 1, GLOBAL>;
  return nullptr;
}

// dtype 0 f32, 1 bf16, 2 uint8, 3 int32; wc the elements of a unit (units are
// at most 4 bytes), cp the planes of a block (wc == 1); integer types take
// order 0 only. A plane in global memory (`global`) is taken one a block.
KernelFn kernel_for(int dtype, int wc, int cp, int order, bool global = false) {
  if (order != 0 && order != 1) return nullptr;
  if (global) {
    if (wc != 1 || cp != 1) return nullptr;
    if (dtype == 0) return kernel_of_order<float, 1, 1, true>(order);
    if (dtype == 1) return kernel_of_order<__nv_bfloat16, 1, 1, true>(order);
    if (dtype == 2) return kernel_of_order<uint8_t, 1, 1, true>(order);
    if (dtype == 3) return kernel_of_order<int32_t, 1, 1, true>(order);
    return nullptr;
  }
  if (wc == 1 && cp == 1) {
    if (dtype == 0) return kernel_of_order<float, 1, 1>(order);
    if (dtype == 1) return kernel_of_order<__nv_bfloat16, 1, 1>(order);
    if (dtype == 2) return kernel_of_order<uint8_t, 1, 1>(order);
    if (dtype == 3) return kernel_of_order<int32_t, 1, 1>(order);
  }
  if (wc == 1 && cp == 2) {
    if (dtype == 0) return kernel_of_order<float, 1, 2>(order);
    if (dtype == 1) return kernel_of_order<__nv_bfloat16, 1, 2>(order);
    if (dtype == 2) return kernel_of_order<uint8_t, 1, 2>(order);
    if (dtype == 3) return kernel_of_order<int32_t, 1, 2>(order);
  }
  if (cp == 1 && wc == 2) {
    if (dtype == 1) return kernel_of_order<__nv_bfloat16, 2, 1>(order);
    if (dtype == 2) return kernel_of_order<uint8_t, 2, 1>(order);
  }
  if (cp == 1 && wc == 4 && dtype == 2) return kernel_of_order<uint8_t, 4, 1>(order);
  return nullptr;
}

int item_bytes(int dtype) { return dtype == 2 ? 1 : (dtype == 1 ? 2 : 4); }

int blocks_per_sm(KernelFn fn, int threads, int smem_bytes) {
  if (fn == nullptr) return -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
      cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem_bytes) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// The launch of segk_shear_group (planes == nullptr: the planes in shared
// memory) and of segk_shear_group_global (planes: n_img * chunks planes of
// A0 * row_units units in global memory).
int launch_group(const void* x, void* y, void* planes, const float* coef, const float* zoom,
                 const int* passes, const int* strides, int dtype, int n_img, int channels,
                 int nc, int wc, int cp, int order, int round_w, int row_units, int block_lines,
                 int threads, int vec_in, int vec_out, int smem_bytes, void* stream) {
  const int invalid = (int)cudaErrorInvalidValue;
  const bool global = planes != nullptr;
  Group g;
  int longest = 0;
  for (int j = 0; j < 3; ++j) {
    g.p[j].n_in = passes[5 * j];
    g.p[j].n_other = passes[5 * j + 1];
    g.p[j].n_out = passes[5 * j + 2];
    g.p[j].use_zoom = passes[5 * j + 3];
    g.p[j].frame = passes[5 * j + 4];
    if (g.p[j].n_in < 2 || g.p[j].n_out < 1 || g.p[j].n_out > g.p[j].n_in) return invalid;
    longest = g.p[j].n_out > longest ? g.p[j].n_out : longest;
  }
  g.nc = nc;
  g.channels = channels;
  g.round_w = round_w;
  g.row_units = row_units;
  g.block_lines = block_lines;
  g.vec_in = vec_in;
  g.vec_out = vec_out;
  g.in_sa = strides[0];
  g.in_sb = strides[1];
  g.in_sc = strides[2];
  g.in_sn = strides[3];
  g.out_sa = strides[4];
  g.out_sb = strides[5];
  g.out_sc = strides[6];
  g.out_sn = strides[7];
  if (n_img <= 0 || nc <= 0) return 0;
  KernelFn fn = kernel_for(dtype, wc, cp, order, global);
  const int unit = item_bytes(dtype) * wc;
  const int A0 = g.p[0].n_in, B0 = g.p[0].n_other, B1 = g.p[1].n_out;
  if (fn == nullptr || threads < 32 || threads > 512 || threads % 32 || row_units < B0 ||
      (row_units * unit) % 4 || (!block_lines && longest > 32 * kMaxPerLane))
    return invalid;
  const long long tables = 4LL * (g.p[0].n_out + g.p[1].n_out + g.p[2].n_out);
  const long long sum = (global ? 0LL : (long long)A0 * row_units * cp * unit) +
                        (block_lines ? (long long)longest * cp * unit : tables);
  if (sum != smem_bytes || sum > 232448) return invalid;
  const int item = item_bytes(dtype);
  if (vec_in && (wc != 1 || g.in_sb != 1 || (B0 * item) % 16 ||
                 (reinterpret_cast<uintptr_t>(x) & 15) || (g.in_sa * item) % 16 ||
                 (nc > 1 && (g.in_sc * item) % 16) || (g.in_sn * item) % 16))
    return invalid;
  if (vec_out && (wc != 1 || g.out_sb != 1 || (B1 * item) % 16 ||
                  (reinterpret_cast<uintptr_t>(y) & 15) || (g.out_sa * item) % 16 ||
                  (nc > 1 && (g.out_sc * item) % 16) || (g.out_sn * item) % 16))
    return invalid;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (nc + wc * cp - 1) / (wc * cp);
  fn<<<(unsigned)(n_img * chunks), threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, y, planes, coef, zoom, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Resident blocks per SM of the kernel for (dtype, wc, order) at `threads`
// threads and `smem_bytes` of dynamic shared memory, as the runtime counts
// them (registers included); -1 for a combination that has no kernel.
extern "C" int segk_shear_group_blocks_per_sm(int dtype, int wc, int cp, int order, int threads,
                                              int smem_bytes) {
  return blocks_per_sm(kernel_for(dtype, wc, cp, order), threads, smem_bytes);
}

// The same for the kernel that keeps its plane in global memory (wc = cp = 1).
extern "C" int segk_shear_group_global_blocks_per_sm(int dtype, int order, int threads,
                                                     int smem_bytes) {
  return blocks_per_sm(kernel_for(dtype, 1, 1, order, true), threads, smem_bytes);
}

// x (S, C, *spatial) and y (S, C, *out spatial) of one type: dtype 0 f32, 1 bf16,
// 2 uint8, 3 int32. coef (S, 3) f32 and zoom (S,) f32 on the device. passes:
// host array of 15 ints, (n_in, n_other, n_out, use_zoom, frame) per pass.
// strides: host array of 8 ints, the element strides of a, b, c and of one
// image for x, then for y. n_img = S * C; nc the extent of the third axis.
// (wc, cp, row_units, block_lines, threads, vec_in, vec_out, smem_bytes) is the
// wrapper's plan (ops/fused_shear.py::group_plan); a plan whose shared-memory
// sum differs from the one computed here is refused.
extern "C" int segk_shear_group(const void* x, void* y, const float* coef, const float* zoom,
                                const int* passes, const int* strides, int dtype, int n_img,
                                int channels, int nc, int wc, int cp, int order, int round_w,
                                int row_units, int block_lines, int threads, int vec_in,
                                int vec_out, int smem_bytes, void* stream) {
  return launch_group(x, y, nullptr, coef, zoom, passes, strides, dtype, n_img, channels, nc, wc,
                      cp, order, round_w, row_units, block_lines, threads, vec_in, vec_out,
                      smem_bytes, stream);
}

// The same with the planes in global memory: `planes` holds n_img * chunks
// planes of passes[0] * row_units elements (wc = cp = 1), one a block, for a
// plane too large for a block's shared memory; smem_bytes counts only the
// position tables or the scratch line.
extern "C" int segk_shear_group_global(const void* x, void* y, void* planes, const float* coef,
                                       const float* zoom, const int* passes, const int* strides,
                                       int dtype, int n_img, int channels, int nc, int order,
                                       int round_w, int row_units, int block_lines, int threads,
                                       int vec_in, int vec_out, int smem_bytes, void* stream) {
  if (planes == nullptr) return (int)cudaErrorInvalidValue;
  return launch_group(x, y, planes, coef, zoom, passes, strides, dtype, n_img, channels, nc, 1,
                      1, order, round_w, row_units, block_lines, threads, vec_in, vec_out,
                      smem_bytes, stream);
}
