// Fused stride-1 SAME 3x3x3 convolution with the folded-norm epilogue: the
// entry points of its tensor-core (mma.sync), few-channel and register-tiled
// f32 bodies, in a unit of their own beside fused_conv.cu (which says what each
// body does and when the rule takes it) so that nvcc builds the two at once.
//
// Replaces, with the bodies of fused_conv.cu, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_kernel (conv3d_packed_p).
#include "conv3_f32.cuh"
#include "conv3_fewc.cuh"
#include "conv3_mma.cuh"

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
