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
// are 1,728 positions and 1.77 M outputs. Both are CUDA-core f32 FMA work.
// What the design does about it (conv3_dw.cuh): output channels and the
// three input-plane offsets spread over grid.y and grid.z, and the position
// tiles over as many splits as it takes to put ~4 blocks on every SM; the
// per-split partials are summed by a second pass in a fixed order, so the
// result is deterministic without atomics.
#include "conv3_dw.cuh"

extern "C" long long segk_conv3_dw_workspace(int B, int D, int H, int W, int C, int CO) {
  return segk::dw_workspace(segk::dw_plan(B, D, H, W, C, CO), C, CO);
}

extern "C" int segk_fused_conv3_dw(const void* x, const void* dy, float* ws, float* out,
                                   int B, int D, int H, int W, int C, int CO, int in_bf16,
                                   void* stream) {
  return segk::launch_conv3_dw<segk::DenseLayout>(x, dy, ws, out, B, D, H, W, C, CO,
                                                  in_bf16, stream);
}
