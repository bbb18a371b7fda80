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
// window at full resolution (113 MB moved for 6.1 GFLOP at batch 4) and the
// second 48^3 x 16 -> 16: bytes, both. A voxel's channel vector is 16 or 32
// contiguous bytes in the phase-major tensor too, and the 8 phases of one
// block voxel share a 128- or 256-byte line.
// What the design does about it: bf16 input runs the tensor-core body of
// conv3_mma.cuh (segk_phase_conv3_mma), the same code as fused_conv with the
// PhaseLayout address map: each 16-byte piece of the halo brick is one
// cp.async at the mapped address (neighbouring lanes take neighbouring phases
// of one line), C = 8 pairs two taps into one k16 step, and the epilogue
// stores each voxel's whole channel vector at its mapped address. bf16 input
// with C = 1..7 (packed UNETR's one-channel input layer, 48^3 x 8 standing for
// 96^3 x 1) runs the few-channel body of conv3_fewc.cuh
// (segk_phase_conv3_fewc): 16-byte pieces of a row of block voxels staged as
// they lie, and each lane's rows share one output phase, so its tap offsets
// through the index map are constants. f32 input, and bf16 input with C > 8
// and no multiple of 8, run the register-tiled f32 body of conv3_f32.cuh
// (segk_phase_conv3_f32), whose staging reads each halo position through the
// same map.
#include "conv3_f32.cuh"
#include "conv3_fewc.cuh"

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
