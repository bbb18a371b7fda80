// Phase-space stride-1 SAME 3x3x3 convolution.
//
// Replaces both Pallas forward kernels of segmantic_tpu/ops/phase_gemm.py:
// _fwd_kernel_folded (phase_conv_gemm_folded_p, L = 64) and _fwd_kernel
// (phase_conv_gemm_p, L >= 128). Input p (B, D, H, W, 8*Ci) is phase-major:
// it stands for the 2x-upsampled volume d2s(p) of shape (B, 2D, 2H, 2W, Ci).
// The output is the phase-major tensor of conv3_SAME(d2s(p), w), with the
// same epilogue as fused_conv (scale, shift, activation).
//
// The TPU kernels build a half-block-shifted re-phasing of p in VMEM and run
// eight (rows, L) @ (L, L) products; the L = 64 variant further folds the W
// parity into lanes so its vector unit runs at 128 lanes. Both exist to keep
// the TPU's lanes dense. Here the kernel walks the full-resolution grid and
// reads and writes through the depth-to-space index map, so it touches
// exactly the 27 true taps per output phase and needs neither re-phasing nor
// folding: one kernel serves L = 64 and L = 128.
//
// What bounds it on the card: the top decoder stage is 96^3 x 8 -> 8 per
// window at full resolution, i.e. few channels per voxel; each staged input
// value feeds only 27 * 8 FMAs and the phase-major addresses make the halo
// loads strided (a full-resolution row alternates between two phase groups).
// What the design does about it: the halo tile is staged once per input plane
// in shared memory as f32, the output-channel tile shrinks to 8 so no thread
// idles on padding channels, and the same register tiling as fused_conv keeps
// the FMA units busy.
#include "conv3.cuh"

extern "C" int segk_phase_conv3(const void* p, const void* w, const float* scale,
                                const float* shift, const float* alpha, int relu_mode,
                                void* out, int B, int D2, int H2, int W2, int C, int CO,
                                int in_bf16, int out_bf16, void* stream) {
  return segk::launch_conv3<segk::PhaseLayout>(p, w, scale, shift, alpha, relu_mode, out, B,
                                               D2, H2, W2, C, CO, in_bf16, out_bf16, stream);
}
