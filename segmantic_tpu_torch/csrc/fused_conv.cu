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
// What bounds it on the card: per window the slice runs 48^3 x 16 (28 MB
// moved for 6.1 GFLOP: bytes), 24^3 x 32 (operations, just above the ridge)
// and, at the bottom of the UNet, 12^3 x 64 down to 6^3 x 256 (operations and
// the weights' bytes; few positions, so filling the M rows and the 132 SMs is
// the difficulty). In f32 the ceiling is the CUDA cores' FMA rate.
// What the design does about it: bf16 input runs the tensor-core body of
// conv3_mma.cuh (segk_fused_conv3_mma): mma.sync m16n8k16 fed by ldmatrix
// from a 3-D halo brick staged once by 16-byte cp.async into a ring of
// buffers, weights pre-packed and resident, brick shape picked per launch so
// that 12^3 and 6^3 fill the rows, 16-byte stores of whole channel vectors.
// bf16 input with C = 1..7 (the 96^3 one-channel input layer of SegResNet
// and UNETR) runs the few-channel body of conv3_fewc.cuh
// (segk_fused_conv3_fewc): the same mma.sync on input planes staged along W,
// a rolling window of three along D. f32 input runs the register-tiled f32
// body of conv3_f32.cuh (segk_fused_conv3_f32: an implicit GEMM on FFMA, 32
// accumulators a thread, the K units staged by cp.async into a ring, split-K
// at small volumes), which agrees with the CPU to ~1e-6 where TF32 would
// not; bf16 input with C > 8 and no multiple of 8 takes it too.
// bf16 input with C, CO >= 64 runs the deep-channel body of conv3_wgmma.cuh
// (segk_fused_conv3_wgmma): wgmma with the halo and the weight tiles brought
// by TMA and bulk copies, an N tile covering CO, split-K where the bricks are
// too few to fill the card.
#include "conv3_f32.cuh"
#include "conv3_fewc.cuh"
#include "conv3_wgmma.cuh"

extern "C" int segk_fused_conv3_f32(const void* x, const void* w, const float* scale,
                                    const float* shift, const float* alpha, int relu_mode,
                                    void* out, float* ws, int B, int D, int H, int W, int C,
                                    int CO, int in_bf16, int out_bf16, int td, int th, int tw,
                                    int nt, int ck, int splits, int stages, int smem_bytes,
                                    void* stream) {
  return segk::launch_conv3_f32<segk::DenseLayout>(x, w, scale, shift, alpha, relu_mode, out,
                                                   ws, B, D, H, W, C, CO, in_bf16, out_bf16, td,
                                                   th, tw, nt, ck, splits, stages, smem_bytes,
                                                   stream);
}

extern "C" int segk_fused_conv3_mma(const void* x, const void* wp, const float* scale,
                                    const float* shift, const float* alpha, int relu_mode,
                                    void* out, int B, int D, int H, int W, int C, int CO,
                                    int out_bf16, int td, int th, int tw, int warps, int nt,
                                    int ck, int stages, int resident, int grid_x,
                                    int smem_bytes, void* stream) {
  return segk::launch_conv3_mma<segk::DenseLayout>(
      x, wp, scale, shift, alpha, relu_mode, out, B, D, H, W, C, CO, out_bf16, td, th, tw,
      warps, nt, ck, stages, resident, grid_x, smem_bytes, stream);
}

extern "C" int segk_fused_conv3_fewc(const void* x, const void* wp, const float* scale,
                                     const float* shift, const float* alpha, int relu_mode,
                                     void* out, int B, int D, int H, int W, int C, int CO,
                                     int out_bf16, int th, int tw, int seg, int nt, int grid_x,
                                     int smem_bytes, int vec, void* stream) {
  return segk::launch_conv3_fewc<segk::DenseLayout>(x, wp, scale, shift, alpha, relu_mode, out,
                                                    B, D, H, W, C, CO, out_bf16, th, tw, seg, nt,
                                                    grid_x, smem_bytes, vec, stream);
}

extern "C" int segk_fused_conv3_wgmma(const void* x, const void* wp, const float* scale,
                                      const float* shift, const float* alpha, int relu_mode,
                                      void* out, float* ws, int B, int D, int H, int W, int C,
                                      int CO, int out_bf16, int td, int th, int tw, int nt,
                                      int spw, int nwg, int splits, int stages, int smem_bytes,
                                      void* stream) {
  return segk::launch_conv3_wgmma(x, wp, scale, shift, alpha, relu_mode, out, ws, B, D, H, W, C,
                                  CO, out_bf16, td, th, tw, nt, spw, nwg, splits, stages,
                                  smem_bytes, stream);
}
