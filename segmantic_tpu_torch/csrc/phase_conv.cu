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
// What the design does about it: bf16 input that no body below takes runs
// the tensor-core body of conv3_mma.cuh (segk_phase_conv3_mma), the same code as fused_conv with the
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
// same map. bf16 input with C % 16 == 0 and C + CO >= 48 (packed UNETR's
// stages with a 32-channel side) runs the mid-channel body of conv3_mid.cuh
// (segk_phase_conv3_mid): each input phase's share of the halo staged as
// 8-channel planes, the M rows ordered by output phase so that every tap of
// a slab is one wgmma descriptor into one plane. bf16 input with Ci = Co = 8
// or 16 (the flagship's two top decoder stages, packed UNETR's 96^3 x 16
// stage) runs the Hopper body of conv3_phase.cuh (segk_phase_conv3_lanes):
// the halo brick in block space by TMA, M = block voxels, K = (shift, input
// phase, ci) pairs, N = (output phases, co) = 64, both operands of its wgmma
// by descriptor (A a start moved by the pair's shift and input phase).
// The entry points of the tensor-core (mma.sync), few-channel and f32 bodies
// live in phase_conv_tc.cu, a unit of their own so that nvcc builds both at once.
#include "conv3_mid.cuh"
#include "conv3_phase.cuh"

extern "C" int segk_phase_conv3_mid(const void* p, const void* wp, const float* scale,
                                    const float* shift, const float* alpha, int relu_mode,
                                    void* out, int B, int D2, int H2, int W2, int C, int CO,
                                    int out_bf16, int td, int th, int tw, int ck, int nt, int spw,
                                    int nwg, int grid_x, int stages, int smem_bytes,
                                    void* stream) {
  return segk::launch_conv3_mid<1>(p, wp, scale, shift, alpha, relu_mode, out, B, D2, H2, W2, C,
                                   CO, out_bf16, td, th, tw, ck, nt, spw, nwg, grid_x, stages,
                                   smem_bytes, stream);
}

extern "C" int segk_phase_conv3_lanes(const void* p, const void* wp, const float* scale,
                                      const float* shift, const float* alpha, int relu_mode,
                                      void* out, int B, int D2, int H2, int W2, int C, int CO,
                                      int out_bf16, int grid_x, int stages, int smem_bytes,
                                      void* stream) {
  return segk::launch_conv3_phase_fwd(p, wp, scale, shift, alpha, relu_mode, out, B, D2, H2, W2,
                                      C, CO, out_bf16, grid_x, stages, smem_bytes, stream);
}
