// Phase-space stride-1 SAME 3x3x3 convolution: the entry points of its tensor-
// core (mma.sync), few-channel and register-tiled f32 bodies, in a unit of
// their own beside phase_conv.cu (which says what each body does and when the
// rule takes it) so that nvcc builds the two at once.
//
// Replaces, with the bodies of phase_conv.cu, the Pallas kernel
// segmantic_tpu/ops/phase_gemm.py::phase_conv_gemm_folded_p and
// ::phase_conv_gemm_p.
#include "conv3_f32.cuh"
#include "conv3_fewc.cuh"
#include "conv3_mma.cuh"

extern "C" int segk_phase_conv3_f32(const void* p, const void* w, const float* scale,
                                    const float* shift, const float* alpha, int relu_mode,
                                    void* out, float* ws, int B, int D2, int H2, int W2, int C,
                                    int CO, int in_bf16, int out_bf16, int td, int th, int tw,
                                    int nt, int ck, int splits, int stages, int smem_bytes,
                                    void* stream) {
  return segk::launch_conv3_f32<segk::PhaseLayout>(p, w, scale, shift, alpha, relu_mode, out,
                                                   ws, B, D2, H2, W2, C, CO, in_bf16, out_bf16,
                                                   td, th, tw, nt, ck, splits, stages,
                                                   smem_bytes, stream);
}

extern "C" int segk_phase_conv3_mma(const void* p, const void* wp, const float* scale,
                                    const float* shift, const float* alpha, int relu_mode,
                                    void* out, int B, int D2, int H2, int W2, int C, int CO,
                                    int out_bf16, int td, int th, int tw, int warps, int nt,
                                    int ck, int stages, int resident, int grid_x,
                                    int smem_bytes, void* stream) {
  return segk::launch_conv3_mma<segk::PhaseLayout>(
      p, wp, scale, shift, alpha, relu_mode, out, B, D2, H2, W2, C, CO, out_bf16, td, th, tw,
      warps, nt, ck, stages, resident, grid_x, smem_bytes, stream);
}

extern "C" int segk_phase_conv3_fewc(const void* p, const void* wp, const float* scale,
                                     const float* shift, const float* alpha, int relu_mode,
                                     void* out, int B, int D2, int H2, int W2, int C, int CO,
                                     int out_bf16, int th, int tw, int seg, int nt, int grid_x,
                                     int smem_bytes, int vec, void* stream) {
  return segk::launch_conv3_fewc<segk::PhaseLayout>(p, wp, scale, shift, alpha, relu_mode, out,
                                                    B, D2, H2, W2, C, CO, out_bf16, th, tw, seg,
                                                    nt, grid_x, smem_bytes, vec, stream);
}
