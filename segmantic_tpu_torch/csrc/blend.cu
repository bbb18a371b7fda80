// Sliding-window Gaussian-blend accumulation, in place:
//   acc[starts[b] + r, c] += logits[b, r, c] * importance[r]   for b = 0 .. B-1
//
// Replaces the Pallas kernel segmantic_tpu/ops/pallas_blend.py::_blend_kernel
// (accumulate_windows_pallas). The TPU runs its grid one step at a time, so
// its read-modify-write per window is race-free even where windows overlap.
// CUDA blocks run in no order, so this kernel is written as a gather: each
// thread owns one (voxel, channel) of the chunk's bounding box and adds the
// windows that cover it in the order b = 0 .. B-1. Products and sums use
// __fmul_rn / __fadd_rn so nothing contracts to an FMA: the result is
// deterministic and bit-equal to the sequential loop of the plain version.
// There is no alignment contract and no channel padding.
//
// What bounds it on the card: device-memory bytes. Each covered element reads
// acc once, one logit per covering window and the importance value, and
// writes acc once; there is no arithmetic to speak of.
// What the design does about it: acc is read and written once per chunk
// however many windows overlap (a scatter would read-modify-write it once per
// window), consecutive threads take consecutive channels and voxels so the
// accesses coalesce, and the importance map (one roi, 3.5 MB at 96^3) stays in
// L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void blend_kernel(float* __restrict__ acc, const float* __restrict__ logits,
                             const float* __restrict__ imp, const int* __restrict__ starts,
                             int B, int R0, int R1, int R2, int C, int H, int W, int lo0,
                             int lo1, int lo2, int n1, int n2, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  int64_t v = i / C;
  const int x = (int)(v % n2) + lo2;
  v /= n2;
  const int y = (int)(v % n1) + lo1;
  const int z = (int)(v / n1) + lo0;
  const int64_t a_off = (((int64_t)z * H + y) * W + x) * C + c;
  float a = acc[a_off];
  for (int b = 0; b < B; ++b) {
    const int rz = z - starts[3 * b];
    const int ry = y - starts[3 * b + 1];
    const int rx = x - starts[3 * b + 2];
    if (rz < 0 || rz >= R0 || ry < 0 || ry >= R1 || rx < 0 || rx >= R2) continue;
    const int64_t r = ((int64_t)rz * R1 + ry) * R2 + rx;
    a = __fadd_rn(a, __fmul_rn(logits[((int64_t)b * R0 * R1 * R2 + r) * C + c], imp[r]));
  }
  acc[a_off] = a;
}

}  // namespace

// acc (D, H, W, C) f32; logits (B, R0, R1, R2, C) f32; imp (R0, R1, R2) f32;
// starts (B, 3) int32 on the device. lo/n: the chunk's bounding box
// (origin and extent per axis), computed by the caller from host-side starts.
extern "C" int segk_blend(float* acc, const float* logits, const float* imp, const int* starts,
                          int B, int R0, int R1, int R2, int C, int H, int W, int lo0,
                          int lo1, int lo2, int n0, int n1, int n2, void* stream) {
  const int64_t total = (int64_t)n0 * n1 * n2 * C;
  if (total <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  blend_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      acc, logits, imp, starts, B, R0, R1, R2, C, H, W, lo0, lo1, lo2, n1, n2, total);
  return static_cast<int>(cudaGetLastError());
}
