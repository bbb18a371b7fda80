// Weight gradient of the stride-1 SAME 3x3x3 convolution on NDHWC tensors at
// C = CO = 32: the dense pairs body (conv3_dense_pairs_dw.cuh), in a source
// of its own so that nvcc builds it beside fused_conv_dw.cu.
//
// Replaces, with the bodies of fused_conv_dw.cu, the Pallas kernel
// segmantic_tpu/ops/pallas_conv.py::_dw_kernel (conv3d_packed_dw):
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]   (f32).
// The rule (fused_conv.dw_body) gives it bf16 input with C = CO = 32, W even,
// from fused_conv.DENSE_PAIRS_MIN_POSITIONS positions.
#include "conv3_dense_pairs_dw.cuh"

extern "C" int segk_fused_conv3_dw_pairs(const void* x, const void* dy, float* ws, float* out,
                                         int B, int D, int H, int W, int C, int CO, int grid_x,
                                         int stages, int smem_bytes, void* stream) {
  return segk::launch_conv3_dense_pairs(x, dy, ws, out, B, D, H, W, C, CO, grid_x, stages,
                                        smem_bytes, stream);
}
