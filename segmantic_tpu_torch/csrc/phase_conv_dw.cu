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
// keep 128 lanes dense (2.37x the true products); here one entry point
// serves every L and multiplies only the 27 true taps.
//
// What bounds it on the card: the top stage has 7.08 M full-resolution
// positions at batch 8 and only 8 x 8 to 16 x 16 channels, so a few thousand
// outputs share one very long contraction over 450 MB of p and g. The body
// is chosen by fused_conv.dw_body:
// - bf16 with Ci in {16, 32, 64}, Co = 8 or a multiple of 16, at a large
//   enough volume (packed UNETR's four phase rows, the flagship's L = 128):
//   the Hopper phase body (conv3_phase_dw.cuh), which reads p and g as they
//   lie in block space by TMA, sums the products of each tap over the input
//   phases of z and y in its accumulators, and runs wgmma with the g
//   fragments in registers and p by descriptor (it runs Ci = 8 too, through
//   this entry point, but lost to the tensor-core body at L = 64);
// - other bf16 with Ci % 8 == 0 and Co % 8 == 0 (L = 64, small volumes):
//   the tensor-core body (conv3_dw_mma.cuh), which stages 16-byte channel
//   vectors through the depth-to-space index map (PhaseLayout) and keeps one
//   partial per split;
// - bf16 with Ci = 1..7 and any Co: the few-channel body
//   (conv3_fewc_dw.cuh), which stages the rows of block voxels as they lie;
// - f32 (and bf16 with other channel counts): the register-tiled f32 body
//   (conv3_f32_dw.cuh): at Ci = 1 a block of 32 position groups takes all
//   27 taps x 16 outputs, the position bricks split over ~264 blocks.
// Every body with position splits writes one partial a block and sums them
// in a fixed order in a second pass: a repeated launch is bit-equal.
// The entry points of the tensor-core (mma.sync), few-channel and f32 bodies
// live in phase_conv_dw_tc.cu, a unit of their own so that nvcc builds both at once.
#include "conv3_phase_dw.cuh"

extern "C" int segk_phase_conv3_dw_wgmma(const void* p, const void* g, float* ws, float* out,
                                         int B, int D2, int H2, int W2, int C, int CO, int td,
                                         int th, int tw, int tpw, int nwg, int splits, int stages,
                                         int smem_bytes, void* stream) {
  return segk::launch_conv3_phase_dw(p, g, ws, out, B, D2, H2, W2, C, CO, td, th, tw, tpw, nwg,
                                     splits, stages, smem_bytes, stream);
}
