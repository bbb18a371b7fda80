// The phase-major soft Dice of the train step, in two streaming sweeps.
//
// Phase-major logits xp (B, *S/2, P * C) hold, per coarse voxel, P fine voxels
// ("phases") of C class logits each, lane = phase * C + c; the labels yp
// (B, *S/2, P) are uint8. So memory is simply N = V * P voxels per sample with
// C contiguous logits and one label each.
//
//   sums:  per (sample, class): inter = sum_v p[v, c] * [y_v == c],
//          sump = sum_v p[v, c], count = sum_v [y_v == c], p = softmax over c
//   dx:    p * (d - sum_c p * d), d = hot[b, lane] on the label's lane and
//          cold[b, lane] elsewhere, cast to xp's type (the softmax is recomputed)
//
// Replaces the Pallas kernels exp/pallas_dice_ab.py::dice_phase_sums (_fwd_kernel)
// and ::dice_phase_dx (_bwd_kernel). Those keep the TPU's lanes dense: a row
// of P * C lanes is reduced per phase group with small indicator-matrix
// products on the matrix unit, and the sequential grid carries nothing, each
// block writing lane sums that XLA folds. Here one thread owns one voxel: its C
// logits arrive in one 16-byte load (C = 8, bf16), the softmax is a few
// register operations and no group matrices are needed; the TPU gates
// (8 phases, at most 128 lanes, whole row blocks) are gone: any voxel count,
// any P, up to 32 classes.
//
// What bounds them on the card: dx the device-memory bytes (it reads xp and
// yp once and writes dx once, and runs within ~1.25x of their time); sums
// reads the same once and writes nothing, and is bound by the instructions it
// issues per voxel, not by its bytes: its time did not move with the unroll
// or the blocks per SM (any version without spills), and fell by a fifth with
// the cheaper exponential. The compares, integer counts and bf16 unpacking
// run at half the f32 rate, the eight exponentials and the reciprocal on the
// quarter-rate special-function unit. What the design does about it: one pass
// each, 16-byte accesses, f32 only in registers, one reciprocal per voxel and
// a multiply per class (as the Pallas kernel's ``1.0 / z``), never a division
// per class, ex2.approx on a pre-scaled difference for the exponential.
//
// sums: a grid sized to the card (the plan of ops/phase_dice.py::sums_plan: a
// few blocks per SM, each block a contiguous run of one sample's voxels), so
// the block epilogue (24 warp reductions at 8 classes) is paid once per ~70
// voxels of a thread and there is one wave and no tail. A thread strides over
// its block's run by the block width; it takes ``unroll`` voxels a round, all
// loads issued before the arithmetic, so several 16-byte loads are in flight
// per thread. The label counts are integers. No atomics: a thread accumulates
// in registers, a block reduces by warp shuffles and a fixed-order sum over
// its warps and writes one partial per block; a second kernel sums the few
// hundred partials of each (sample, sum, class) in a fixed order, so a
// repeated launch is bit-equal.
//
// dx: one voxel a thread a round at full occupancy; the phase (voxel index
// mod P) advances by a fixed step, so no modulo is taken per voxel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

// The C logits of one voxel into v[0 .. CP), lanes beyond C as -inf (their
// probability is then 0). 16-byte loads where a voxel is a whole number of them.
template <typename T, int CP>
__device__ __forceinline__ void load_voxel(const T* p, int C, float (&v)[CP]) {
  if constexpr ((CP * sizeof(T)) % 16 == 0) {
    if (C == CP) {
      constexpr int kPer = 16 / sizeof(T);
      const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int i = 0; i < CP / kPer; ++i) {
        const uint4 u = q[i];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[i * kPer + j] = to_f(e[j]);
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CP; ++c) v[c] = (c < C) ? to_f(p[c]) : -CUDART_INF_F;
}

template <typename T, int CP>
__device__ __forceinline__ void store_voxel(T* p, int C, const float (&v)[CP]) {
  if constexpr ((CP * sizeof(T)) % 16 == 0) {
    if (C == CP) {
      constexpr int kPer = 16 / sizeof(T);
      uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
      for (int i = 0; i < CP / kPer; ++i) {
        uint4 u;
        T* e = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int j = 0; j < kPer; ++j) from_f(v[i * kPer + j], e + j);
        q[i] = u;
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CP; ++c)
    if (c < C) from_f(v[c], p + c);
}

// The exponential is the card's ex2.approx on the difference scaled by
// log2(e): 2 ulp, and three instructions (subtract, scale, MUFU.EX2) where
// expf adds its range reduction.
__device__ __forceinline__ float exp_of(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d * 1.4426950408889634f));
  return r;
}

// v: logits in; out: e[c] = exp(v[c] - max) in v, returns the correctly
// rounded 1 / sum_c e[c]. The probabilities are e[c] * r: one reciprocal per
// voxel (z lies in [1, CP], never the slow path), a multiply per class.
template <int CP>
__device__ __forceinline__ float softmax_terms(float (&v)[CP]) {
  float m = v[0];
#pragma unroll
  for (int c = 1; c < CP; ++c) m = fmaxf(m, v[c]);
  float z = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    v[c] = exp_of(v[c] - m);
    z += v[c];
  }
  return __frcp_rn(z);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// voxels a thread takes per round, all loaded before any arithmetic: four
// 16-byte loads in flight at 8 bf16 classes; fewer where a voxel's lanes
// already fill the registers. ops/phase_dice.py::sums_plan holds the same rule.
template <int CP>
struct SumsUnroll {
  static constexpr int value = CP <= 8 ? 4 : (CP == 16 ? 2 : 1);
};

// partial[b][blk][3][CP]: intersection and probability sum (f32) and label
// count (int32 bits) of the block's voxels [blk * vpb, (blk + 1) * vpb) of
// sample b. A thread visits v0 + tid, v0 + tid + kThreads, ... in that order.
template <typename T, int CP>
__global__ void __launch_bounds__(kThreads, CP <= 8 ? 3 : 1)
dice_sums_kernel(const T* __restrict__ x, const uint8_t* __restrict__ y,
                 float* __restrict__ partial, int C, int64_t nvox, int64_t vpb) {
  constexpr int U = SumsUnroll<CP>::value;
  __shared__ float warp_part[kThreads / 32][3 * CP];
  const int b = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const int64_t v0 = (int64_t)blk * vpb;
  const int64_t v1 = (v0 + vpb < nvox) ? v0 + vpb : nvox;
  const T* xb = x + (int64_t)b * nvox * C;
  const uint8_t* yb = y + (int64_t)b * nvox;
  float inter[CP], sump[CP];
  int cnt[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    inter[c] = 0.f;
    sump[c] = 0.f;
    cnt[c] = 0;
  }
  auto add = [&](float (&e)[CP], int lab) {
    const float r = softmax_terms<CP>(e);
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const float p = e[c] * r;
      sump[c] += p;
      if (c == lab) {
        inter[c] += p;
        cnt[c] += 1;
      }
    }
  };
  int64_t v = v0 + tid;
  for (; v + (U - 1) * kThreads < v1; v += U * kThreads) {
    float e[U][CP];
    int lab[U];
#pragma unroll
    for (int u = 0; u < U; ++u) load_voxel<T, CP>(xb + (v + u * kThreads) * C, C, e[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) lab[u] = yb[v + u * kThreads];
#pragma unroll
    for (int u = 0; u < U; ++u) add(e[u], lab[u]);
  }
  for (; v < v1; v += kThreads) {
    float e[CP];
    load_voxel<T, CP>(xb + v * C, C, e);
    add(e, yb[v]);
  }
  const int w = tid >> 5;
  const bool lead = (tid & 31) == 0;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const float si = warp_sum(inter[c]);
    const float sp = warp_sum(sump[c]);
    const int sc = warp_sum(cnt[c]);
    if (lead) {
      warp_part[w][c] = si;
      warp_part[w][CP + c] = sp;
      warp_part[w][2 * CP + c] = __int_as_float(sc);
    }
  }
  __syncthreads();
  if (tid < 3 * CP) {
    float out;
    if (tid < 2 * CP) {
      out = 0.f;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) out += warp_part[i][tid];
    } else {
      int n = 0;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) n += __float_as_int(warp_part[i][tid]);
      out = __int_as_float(n);
    }
    partial[((int64_t)b * gridDim.x + blk) * 3 * CP + tid] = out;
  }
}

// out[k][b][c] = sum over the blocks of sample b, one warp per output, each
// lane a fixed strided subset, then the shuffle tree: a fixed order. The
// counts (k == 2) are summed as integers and converted once.
__global__ void dice_sums_finalize(const float* __restrict__ partial, float* __restrict__ out,
                                   int B, int C, int CP, int nblk) {
  const int o = blockIdx.x, lane = threadIdx.x;
  const int c = o % C, k = (o / C) % 3, b = o / (3 * C);
  const float* p = partial + ((int64_t)b * nblk * 3 + k) * CP + c;
  float r;
  if (k < 2) {
    float s = 0.f;
    for (int i = lane; i < nblk; i += 32) s += p[(int64_t)i * 3 * CP];
    r = warp_sum(s);
  } else {
    int n = 0;
    for (int i = lane; i < nblk; i += 32) n += __float_as_int(p[(int64_t)i * 3 * CP]);
    r = (float)warp_sum(n);
  }
  if (lane == 0) out[((int64_t)k * B + b) * C + c] = r;
}

// Six blocks of kThreads resident per SM up to 8 class lanes (40 registers a
// thread): the sweep is bound by bytes in flight, and holding the thread's
// hot / cold lanes in registers or taking two voxels a round cost more in
// occupancy than they saved in instructions (timed on the card).
template <typename T, int CP>
__global__ void __launch_bounds__(kThreads, CP <= 8 ? 6 : 1)
dice_dx_kernel(const T* __restrict__ x, const uint8_t* __restrict__ y,
               const float* __restrict__ hot, const float* __restrict__ cold,
               T* __restrict__ dx, int C, int P, int64_t nvox, int vpb) {
  extern __shared__ float lanes[];  // hot[L], cold[L] of this sample
  const int b = blockIdx.y, tid = threadIdx.x, L = P * C;
  for (int i = tid; i < L; i += kThreads) {
    lanes[i] = hot[(int64_t)b * L + i];
    lanes[L + i] = cold[(int64_t)b * L + i];
  }
  __syncthreads();
  const int64_t v0 = (int64_t)blockIdx.x * vpb;
  const int64_t v1 = (v0 + vpb < nvox) ? v0 + vpb : nvox;
  const T* xb = x + (int64_t)b * nvox * C;
  T* db = dx + (int64_t)b * nvox * C;
  const uint8_t* yb = y + (int64_t)b * nvox;
  // the phase v % P: one 64-bit modulo a thread, then a step of kThreads % P
  int ph = (int)((v0 + tid) % P);
  const int step = kThreads % P;
  for (int64_t v = v0 + tid; v < v1; v += kThreads) {
    float e[CP];
    load_voxel<T, CP>(xb + v * C, C, e);
    const float r = softmax_terms<CP>(e);
    const int lab = yb[v];
    const float* h = lanes + ph * C;
    float d[CP];
    float inner = 0.f;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      e[c] *= r;
      d[c] = (c < C) ? ((c == lab) ? h[c] : h[L + c]) : 0.f;
      inner += e[c] * d[c];
    }
#pragma unroll
    for (int c = 0; c < CP; ++c) e[c] = e[c] * (d[c] - inner);
    store_voxel<T, CP>(db + v * C, C, e);
    ph += step;
    if (ph >= P) ph -= P;
  }
}

template <typename T, int CP>
int launch_sums(const void* x, const uint8_t* y, float* partial, float* out, int B, int C,
                int64_t nvox, int64_t vpb, int nblk, int unroll, cudaStream_t s) {
  if (unroll != SumsUnroll<CP>::value) return (int)cudaErrorInvalidValue;  // another plan
  dice_sums_kernel<T, CP><<<dim3(nblk, B), kThreads, 0, s>>>(static_cast<const T*>(x), y,
                                                             partial, C, nvox, vpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dice_sums_finalize<<<B * 3 * C, 32, 0, s>>>(partial, out, B, C, CP, nblk);
  return (int)cudaGetLastError();
}

template <typename T, int CP>
int launch_dx(const void* x, const uint8_t* y, const float* hot, const float* cold, void* dx,
              int B, int C, int P, int64_t nvox, int vpb, int nblk, cudaStream_t s) {
  dice_dx_kernel<T, CP><<<dim3(nblk, B), kThreads, 2 * P * C * sizeof(float), s>>>(
      static_cast<const T*>(x), y, hot, cold, static_cast<T*>(dx), C, P, nvox, vpb);
  return (int)cudaGetLastError();
}

}  // namespace

#define SEGK_DICE_DISPATCH(CALL)                                    \
  if (dtype == 0) {                                                 \
    switch (cp) {                                                   \
      case 2: return CALL(float, 2);                                \
      case 4: return CALL(float, 4);                                \
      case 8: return CALL(float, 8);                                \
      case 16: return CALL(float, 16);                              \
      case 32: return CALL(float, 32);                              \
    }                                                               \
  } else if (dtype == 1) {                                          \
    switch (cp) {                                                   \
      case 2: return CALL(__nv_bfloat16, 2);                        \
      case 4: return CALL(__nv_bfloat16, 4);                        \
      case 8: return CALL(__nv_bfloat16, 8);                        \
      case 16: return CALL(__nv_bfloat16, 16);                      \
      case 32: return CALL(__nv_bfloat16, 32);                      \
    }                                                               \
  }                                                                 \
  return (int)cudaErrorInvalidValue;

// x (B, nvox, C) of dtype 0 f32 or 1 bf16; y (B, nvox) uint8; partial
// (B, nblk, 3, cp) 4-byte scratch with cp = C rounded up to a power of two
// (2 .. 32); out (3, B, C) f32: intersection, probability sum, label count.
// Each block takes vpb voxels of one sample, nblk = ceil(nvox / vpb), and
// unroll voxels a round: the plan of ops/phase_dice.py::sums_plan, refused
// when its unroll is not the kernel's.
extern "C" int segk_dice_phase_sums(const void* x, const void* y, float* partial, float* out,
                                    int dtype, int B, int C, int cp, long long nvox,
                                    long long vpb, int nblk, int unroll, void* stream) {
  if (B <= 0 || nvox <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* yy = static_cast<const uint8_t*>(y);
#define SEGK_SUMS(T, CP) launch_sums<T, CP>(x, yy, partial, out, B, C, nvox, vpb, nblk, unroll, s)
  SEGK_DICE_DISPATCH(SEGK_SUMS)
#undef SEGK_SUMS
}

// dx (B, nvox, C) of x's type; hot, cold (B, P * C) f32.
extern "C" int segk_dice_phase_dx(const void* x, const void* y, const float* hot,
                                  const float* cold, void* dx, int dtype, int B, int C, int P,
                                  int cp, long long nvox, int vpb, int nblk, void* stream) {
  if (B <= 0 || nvox <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* yy = static_cast<const uint8_t*>(y);
#define SEGK_DX(T, CP) launch_dx<T, CP>(x, yy, hot, cold, dx, B, C, P, nvox, vpb, nblk, s)
  SEGK_DICE_DISPATCH(SEGK_DX)
#undef SEGK_DX
}
