// Weight gradient of the phase-space stride-1 SAME 3x3x3 convolution.
//
// Replaces both Pallas weight-gradient kernels of
// segmantic_tpu/ops/phase_gemm.py: _dw_kernel_folded
// (phase_conv_gemm_dw_folded_p, L = 64) and _dw_kernel (phase_conv_gemm_dw_p,
// L >= 128), together with _unfold_dw, which carries their expanded (L, L)
// block-space gradients back to the true kernel. Inputs p (B, D, H, W, 8*Ci)
// and the output cotangent g (B, D, H, W, 8*Co) are phase-major: they stand
// for the full-resolution volumes d2s(p) and d2s(g). The result is the true
// (3, 3, 3, Ci, Co) gradient of conv3_SAME(d2s(p), w) directly:
//   dw[t, ci, co] = sum_{b, v} d2s(p)[b, v + t - 1, ci] * d2s(g)[b, v, co]
// over full-resolution positions v, zero padded at the full-resolution border.
//
// The TPU kernels re-phase the input in VMEM and fold W parity into lanes to
// keep 128 lanes dense; here the kernel of fused_conv_dw.cu walks the
// full-resolution grid and reads both tensors through the depth-to-space
// index map (PhaseLayout, the same map phase_conv.cu uses for the forward),
// so it touches exactly the 27 true taps and one entry point serves every L.
//
// What bounds it on the card: the top stage has 7.08 M full-resolution
// positions at batch 8 and only 8 x 8 channels, so 1,728 outputs share one
// very long contraction, and the phase-major addresses make every staged row
// alternate between two phase groups. What the design does about it: f32
// input (and bf16 with odd channel counts) runs the register-tiled f32 body
// (conv3_f32_dw.cuh): at Ci = 1 a block of 32 position groups takes all 27
// taps x 16 outputs, the position bricks split over ~264 blocks, one partial
// each, summed in a fixed order by a second pass; bf16 input with Ci % 8 == 0
// and Co % 8 == 0 runs the tensor-core body (conv3_dw_mma.cuh), which stages
// 16-byte channel vectors through the same index map and keeps one partial
// per split; bf16 input with Ci = 1..7 and any Co runs the few-channel body
// (conv3_fewc_dw.cuh), which stages the rows of block voxels as they lie.
#include "conv3_dw_mma.cuh"
#include "conv3_f32_dw.cuh"
#include "conv3_fewc_dw.cuh"

extern "C" int segk_phase_conv3_dw_f32(const void* p, const void* g, float* ws, float* out,
                                       int B, int D2, int H2, int W2, int C, int CO, int in_bf16,
                                       int td, int th, int tw, int taps, int ci, int nt, int npg,
                                       int splits, int stages, int smem_bytes, void* stream) {
  return segk::launch_conv3_f32_dw<segk::PhaseLayout>(p, g, ws, out, B, D2, H2, W2, C, CO,
                                                      in_bf16, td, th, tw, taps, ci, nt, npg,
                                                      splits, stages, smem_bytes, stream);
}

extern "C" int segk_phase_conv3_dw_mma(const void* p, const void* g, float* ws, float* out,
                                       int B, int D2, int H2, int W2, int C, int CO, int td,
                                       int th, int tw, int ck, int nt, int splits, int stages,
                                       int smem_bytes, void* stream) {
  return segk::launch_conv3_dw_mma<segk::PhaseLayout>(p, g, ws, out, B, D2, H2, W2, C, CO, td,
                                                      th, tw, ck, nt, splits, stages,
                                                      smem_bytes, stream);
}

extern "C" int segk_phase_conv3_dw_fewc(const void* p, const void* g, float* ws, float* out,
                                        int B, int D2, int H2, int W2, int C, int CO, int th,
                                        int tw, int seg, int nt, int splits, int smem_bytes,
                                        int vec_x, int vec_dy, void* stream) {
  return segk::launch_conv3_dw_fewc<segk::PhaseLayout>(p, g, ws, out, B, D2, H2, W2, C, CO, th,
                                                       tw, seg, nt, splits, smem_bytes, vec_x,
                                                       vec_dy, stream);
}
