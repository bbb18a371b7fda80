// Fused stride-1 SAME 3x3x3 convolution with the folded-norm epilogue.
//
// Replaces the Pallas kernel segmantic_tpu/ops/pallas_conv.py::_kernel
// (launched from conv3d_packed_p), which the eval executor runs for the
// residual-unit convs. It computes the same function on plain NDHWC tensors:
//   out[b,p,co] = act((sum_{t,ci} x[b,p+t-1,ci] * w[t,ci,co]) * scale[co] + shift[co])
// with f32 accumulation; the wrapper passes shift = bias * scale + shift.
// The TPU kernel packs the batch into the 128 lanes and multiplies by a
// block-diagonal weight matrix to fill its matrix unit; none of that layout
// exists here.
//
// What bounds it on the card: at the slice's shapes (48^3 x 16 and 24^3 x 32
// per window, up to 6^3 x 256 at the bottom) each input byte feeds 27 * CO
// multiply-adds, so the conv is compute-bound; without tensor cores the ceiling
// is the SMs' f32 FMA rate, far below the bf16 tensor-core peak.
// What the design does about it: the halo tile and the weight slice live in
// shared memory, so device memory is read about three times per input plane
// instead of 27 times (no im2col), and each thread keeps a 4 x 4
// position x channel tile in registers so one shared-memory read feeds several
// FMAs. Moving the inner product onto wgmma is left to a later change.
#include "conv3.cuh"

extern "C" int segk_fused_conv3(const void* x, const void* w, const float* scale,
                                const float* shift, const float* alpha, int relu_mode,
                                void* out, int B, int D, int H, int W, int C, int CO,
                                int in_bf16, int out_bf16, void* stream) {
  return segk::launch_conv3<segk::DenseLayout>(x, w, scale, shift, alpha, relu_mode, out, B,
                                               D, H, W, C, CO, in_bf16, out_bf16, stream);
}
