// Weight gradient of the stride-1 SAME 3x3x3 convolution on NDHWC tensors: the
// entry points of its tensor-core (mma.sync), few-channel and register-tiled
// f32 bodies, in a unit of their own beside fused_conv_dw.cu (which says what
// each body does and when the rule takes it) so that nvcc builds the two at
// once.
//
// Replaces, with the bodies of fused_conv_dw.cu, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_dw_kernel (conv3d_packed_dw).
#include "conv3_dw_mma.cuh"
#include "conv3_f32_dw.cuh"
#include "conv3_fewc_dw.cuh"

extern "C" int segk_fused_conv3_dw_f32(const void* x, const void* dy, float* ws, float* out,
                                       int B, int D, int H, int W, int C, int CO, int in_bf16,
                                       int td, int th, int tw, int taps, int ci, int nt, int npg,
                                       int splits, int stages, int smem_bytes, void* stream) {
  return segk::launch_conv3_f32_dw<segk::DenseLayout>(x, dy, ws, out, B, D, H, W, C, CO,
                                                      in_bf16, td, th, tw, taps, ci, nt, npg,
                                                      splits, stages, smem_bytes, stream);
}

extern "C" int segk_fused_conv3_dw_mma(const void* x, const void* dy, float* ws, float* out,
                                       int B, int D, int H, int W, int C, int CO, int td,
                                       int th, int tw, int ck, int nt, int splits, int stages,
                                       int smem_bytes, void* stream) {
  return segk::launch_conv3_dw_mma<segk::DenseLayout>(x, dy, ws, out, B, D, H, W, C, CO, td,
                                                      th, tw, ck, nt, splits, stages,
                                                      smem_bytes, stream);
}

extern "C" int segk_fused_conv3_dw_fewc(const void* x, const void* dy, float* ws, float* out,
                                        int B, int D, int H, int W, int C, int CO, int th,
                                        int tw, int seg, int nt, int splits, int smem_bytes,
                                        int vec_x, int vec_dy, void* stream) {
  return segk::launch_conv3_dw_fewc<segk::DenseLayout>(x, dy, ws, out, B, D, H, W, C, CO, th,
                                                       tw, seg, nt, splits, smem_bytes, vec_x,
                                                       vec_dy, stream);
}
