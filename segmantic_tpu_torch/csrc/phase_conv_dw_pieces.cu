// Weight gradient of the phase-space stride-1 SAME 3x3x3 convolution at Ci =
// Co = 8 (L = 64): the phase pieces body (conv3_phase_pieces_dw.cuh), in a
// source of its own so that nvcc builds it beside phase_conv_dw.cu.
//
// Replaces, with the bodies of phase_conv_dw.cu, the Pallas kernel
// segmantic_tpu/ops/phase_gemm.py::_dw_kernel_folded
// (phase_conv_gemm_dw_folded_p) together with _unfold_dw:
//   dw[t, ci, co] = sum_{b, v} d2s(p)[b, v + t - 1, ci] * d2s(g)[b, v, co]   (f32).
// The rule (fused_conv.dw_body) gives it bf16 phase-major p and g with Ci =
// Co = 8 from fused_conv.PHASE_PIECES_MIN_POSITIONS block voxels.
#include "conv3_phase_pieces_dw.cuh"

extern "C" int segk_phase_conv3_dw_pieces(const void* p, const void* g, float* ws, float* out,
                                          int B, int D2, int H2, int W2, int C, int CO, int td,
                                          int th, int tw, int splits, int stages, int smem_bytes,
                                          void* stream) {
  return segk::launch_conv3_phase_pieces(p, g, ws, out, B, D2, H2, W2, C, CO, td, th, tw, splits,
                                         stages, smem_bytes, stream);
}
