// Weight gradient of the stride-1 SAME 3x3x3 convolution on NDHWC tensors.
//
// Replaces the Pallas kernel segmantic_tpu/ops/pallas_conv.py::_dw_kernel
// (launched from conv3d_packed_dw), which the train step runs in the
// backward pass of every batch-packed conv. It computes the same function,
//   dw[t, ci, co] = sum_{b, p} x[b, p + t - 1, ci] * dy[b, p, co]   (f32),
// directly: the TPU kernel packs the batch into lanes and multiplies out the
// full (B*C, B*CO) block matrix, then discards its off-diagonal blocks;
// nothing of that layout carries over.
//
// What bounds it on the card: two regimes meet in one UNet. At the top
// (48^3 x 16 at batch 8) there are 885 K positions and only 6,912 outputs,
// so the work is a long contraction; at the bottom (6^3 x 256 -> 256) there
// are 1,728 positions and 1.77 M outputs. bf16 input with C % 8 == 0 and
// CO % 8 == 0 runs the tensor-core body (conv3_dw_mma.cuh, which says what
// bounds it and what its design does about that), bf16 input with C = 1..7
// and any CO the few-channel body (conv3_fewc_dw.cuh: the 96^3 one-channel
// input layer), bf16 input with C, CO >= 64 the deep-channel body
// (conv3_dw_wgmma.cuh: wgmma on a TMA-staged halo of x and brick of dy), and
// below its CO >= 128, C and CO multiples of 64 at 24^3-sized volumes, the
// mid-channel body (conv3_mid_dw.cuh: wgmma with both operands MN-major by
// descriptor on a TMA-staged halo of x and brick of dy, no ldmatrix);
// everything else, f32 first of all, the register-tiled f32 body
// (conv3_f32_dw.cuh: 8 x 8 tiles of (tap, ci) x co on FFMA, the tap group's
// halo and the dy brick staged by cp.async, position splits with one partial
// a block, summed by a second pass in a fixed order, so the result is
// deterministic without atomics). bf16 input with C = CO = 8 or 16 and W * C a
// multiple of 64 where the rule takes it runs the dense Hopper body
// (conv3_dense_dw.cuh: 128-byte rows of x and dy by TMA, M = 64 lanes of a
// window of x, N = dy's 64 lanes, K = positions, both operands MN-major by
// descriptor; a partial a block summed by a second pass in a fixed order).
// The entry points of the tensor-core (mma.sync), few-channel and f32 bodies
// live in fused_conv_dw_tc.cu, a unit of their own so that nvcc builds both at once.
#include "conv3_dense_dw.cuh"
#include "conv3_dw_wgmma.cuh"
#include "conv3_mid_dw.cuh"

extern "C" int segk_fused_conv3_dw_wgmma(const void* x, const void* dy, float* ws, float* out,
                                         int B, int D, int H, int W, int C, int CO, int td,
                                         int th, int tw, int nt, int tpw, int nwg, int splits,
                                         int stages, int smem_bytes, void* stream) {
  return segk::launch_conv3_dw_wgmma(x, dy, ws, out, B, D, H, W, C, CO, td, th, tw, nt, tpw, nwg,
                                     splits, stages, smem_bytes, stream);
}

extern "C" int segk_fused_conv3_dw_mid(const void* x, const void* dy, float* ws, float* out,
                                       int B, int D, int H, int W, int C, int CO, int td, int th,
                                       int tw, int tpw, int nwg, int splits, int stages,
                                       int smem_bytes, void* stream) {
  return segk::launch_conv3_mid_dw(x, dy, ws, out, B, D, H, W, C, CO, td, th, tw, tpw, nwg,
                                   splits, stages, smem_bytes, stream);
}

extern "C" int segk_fused_conv3_dw_rows(const void* x, const void* dy, float* ws, float* out,
                                        int B, int D, int H, int W, int C, int CO, int grid_x,
                                        int stages, int smem_bytes, void* stream) {
  return segk::launch_conv3_dense_dw(x, dy, ws, out, B, D, H, W, C, CO, grid_x, stages,
                                     smem_bytes, stream);
}
