"""Analytic FLOP counts of a training step (utilisation accounting).

Port of ``segmantic_tpu/utils/flops.py``; every count equals the JAX one.
Counts the useful floating-point work by formula, not what a backend happens
to execute (the phase-space convs' structural zeros are not credited).
Conventions:

- a conv is ``2 * out_voxels * prod(kernel) * C_in * C_out`` FLOPs
  (multiply + add);
- a stride-s transposed conv is ``2 * in_voxels * prod(kernel) * C_in *
  C_out`` (every input voxel contributes to ``prod(kernel)`` outputs);
- backward = 2x forward (the dx conv and the dw GEMM each cost one forward;
  dx of the first layer is counted, <1% slack);
- the spatial augmentation is counted as the JAX package runs it: banded
  shear/scale matmuls at their dense cost, walking the per-pass extent
  schedule of :mod:`segmantic_tpu_torch.ops.shear_resample` for the order-1
  image chain and the order-0 one-hot label chain. The port's rotation runs
  on the shear-group kernel (line copies, no matmul), so on the card this
  count is not work done, and the utilisation the port reports is the
  model's: ``model_fwd_bwd`` over the step time over the peak;
- pointwise work (norm, activations, flips, intensity ops, Adam) and the
  small Dice sums are excluded, so the figure can only be understated.

The peak is the dense bf16 rate of one NVIDIA H100 SXM5, from NVIDIA's data
sheet, the figure the kernel bounds of this package use.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

__all__ = ["H100_SXM_BF16_PEAK", "unet_fwd_flops", "augment_flops", "segresnet_fwd_flops",
           "unetr_fwd_flops", "flagship_step_flops"]

# Dense bf16 peak of one NVIDIA H100 SXM5 (NVIDIA's data sheet), FLOPs/s.
H100_SXM_BF16_PEAK = 989e12


def _conv_flops(out_voxels: int, kernel: int, nd: int, c_in: int, c_out: int) -> float:
    return 2.0 * out_voxels * (kernel**nd) * c_in * c_out


def unet_fwd_flops(
    patch: Sequence[int],
    in_channels: int,
    out_channels: int,
    channels: Sequence[int] = (16, 32, 64, 128, 256),
    strides: Sequence[int] = (2, 2, 2, 2),
    num_res_units: int = 2,
    kernel_size: int = 3,
    up_kernel_size: int = 3,
) -> float:
    """Forward conv FLOPs of one sample through ``models.unet.UNet``.

    Walks the same encoder / bottom / decoder structure as the module
    (residual units with projection shortcuts, transposed-conv decoder with
    skip concatenation). Counts true convolution work — the phase-space /
    space-to-depth rewrites are FLOP-preserving reformulations of the same
    convs (their structural-zero padding is NOT credited).
    """
    nd = len(patch)
    shape = tuple(patch)
    k = kernel_size
    total = 0.0

    def vox(s: Tuple[int, ...]) -> int:
        return int(math.prod(s))

    def down(s: Tuple[int, ...], stride: int) -> Tuple[int, ...]:
        return tuple(-(-d // stride) for d in s)

    # encoder
    c_prev = in_channels
    skip_shapes = []  # (shape, channels) after each encoder level
    level_in_shapes = []  # shape each level CONSUMED (the decoder's target)
    for c, s in zip(channels[:-1], strides):
        level_in_shapes.append(shape)
        out_shape = down(shape, s)
        if num_res_units > 0:
            total += _conv_flops(vox(out_shape), k, nd, c_prev, c)  # strided
            for _ in range(num_res_units - 1):
                total += _conv_flops(vox(out_shape), k, nd, c, c)
            if s != 1 or c_prev != c:  # projection shortcut (k^nd when strided)
                rk = k if s != 1 else 1
                total += _conv_flops(vox(out_shape), rk, nd, c_prev, c)
        else:
            total += _conv_flops(vox(out_shape), k, nd, c_prev, c)
        skip_shapes.append((out_shape, c))
        shape, c_prev = out_shape, c

    # bottom (stride 1)
    c = channels[-1]
    if num_res_units > 0:
        total += _conv_flops(vox(shape), k, nd, c_prev, c)
        for _ in range(num_res_units - 1):
            total += _conv_flops(vox(shape), k, nd, c, c)
        if c_prev != c:
            total += _conv_flops(vox(shape), 1, nd, c_prev, c)
    else:
        total += _conv_flops(vox(shape), k, nd, c_prev, c)
    c_prev = c

    # decoder (deepest first); level-0 maps straight to out_channels.
    # Each stage upsamples back to the shape its encoder level consumed
    # (the module's conv_transpose SAME output) — NOT d*s, which
    # disagrees under the encoder's ceil division for non-divisible sizes.
    for level in reversed(range(len(strides))):
        skip_shape, skip_c = skip_shapes[level]
        cat_c = c_prev + skip_c
        out_feats = out_channels if level == 0 else channels[level - 1]
        up_shape = level_in_shapes[level]
        # transposed conv: every input voxel feeds k^nd outputs
        total += _conv_flops(vox(shape), up_kernel_size, nd, cat_c, out_feats)
        if num_res_units > 0:  # one res subunit, identity shortcut
            total += _conv_flops(vox(up_shape), k, nd, out_feats, out_feats)
        shape, c_prev = up_shape, out_feats
    return total


def augment_flops(
    batch: int,
    margin_shape: Sequence[int],
    out_shape: Sequence[int],
    image_channels: int = 1,
    angle_max: float = 0.4,
    zoom_min: float = 0.8,
    aug_cfg=None,
) -> float:
    """Banded shear/scale matmul FLOPs of the spatial augmentation.

    Replays the 9-pass folded schedule (rotation + zoom) of
    ``train.augment`` as the JAX package runs it, banded matmuls: the
    order-1 image chain plus the order-0 one-hot label chain (same einsum
    shapes), using the real per-pass extent schedule. Intensity/flip work is
    pointwise and excluded.

    ``aug_cfg`` is the ``AugmentConfig`` the step actually runs (its
    subset gating / probabilities drive the chained-sample count); when
    omitted the defaults are used.
    """
    from ..ops.shear_resample import _extent_schedule, _folded_pass_list

    nd = len(margin_shape)
    passes, divz = _folded_pass_list(nd, nd if nd == 3 else 1)
    extents = _extent_schedule(
        tuple(margin_shape), tuple(out_shape), passes, angle_max,
        min(zoom_min, 1.0), divz,
    )
    per_sample = 0.0
    shape = list(margin_shape)
    for (kind, a, b, _), ext in zip(passes, extents):
        m = min(ext, shape[a])
        na = shape[a]
        rest = math.prod(shape) // na  # includes the b axis
        per_sample += 2.0 * m * na * rest  # (NB, M, NA) einsum, C folded in rest
        shape[a] = m
    # the exact-count spatial subset runs the chain on round(P[any]*B)
    # samples per step (augment.py::draw_params, the default) —
    # the rest take a zero-FLOP center crop; count only the chained samples
    if aug_cfg is None:
        from ..train.augment import AugmentConfig

        aug_cfg = AugmentConfig()
    if aug_cfg.spatial_subset:
        n_rot = nd if nd == 3 else 1
        p_any = 1.0 - (
            (1.0 - aug_cfg.rotate_prob) ** n_rot * (1.0 - aug_cfg.zoom_prob)
        )
        batch = round(p_any * batch)
    # image chain (C channels) + label chain (1 channel, same shapes)
    return per_sample * batch * (image_channels + 1)


def segresnet_fwd_flops(
    patch: Sequence[int],
    in_channels: int,
    out_channels: int,
    init_filters: int = 8,
    blocks_down: Sequence[int] = (1, 2, 2, 4),
    blocks_up: Sequence[int] = (1, 1, 1),
) -> float:
    """Forward conv FLOPs of one sample through ``models.segresnet``.

    Walks the module exactly: conv_init, per-stage stride-2 down
    convs + pre-activation residual blocks, decoder 1^nd channel-halving
    convs + kernel-3 stride-2 transposed-conv upsamples + residual
    blocks, and the 1^nd head. Norm/act are pointwise and excluded (same
    convention as :func:`unet_fwd_flops`)."""
    nd = len(patch)
    f = init_filters
    total = 0.0

    def vox(level: int) -> int:
        return int(math.prod(-(-d // (2**level)) for d in patch))

    total += _conv_flops(vox(0), 3, nd, in_channels, f)  # conv_init
    for i, n_blocks in enumerate(blocks_down):
        feats = f * 2**i
        if i > 0:
            total += _conv_flops(vox(i), 3, nd, feats // 2, feats)  # down_i
        total += n_blocks * 2 * _conv_flops(vox(i), 3, nd, feats, feats)
    for j, n_blocks in enumerate(blocks_up):
        i = len(blocks_down) - 1 - j  # stage being left
        feats = f * 2 ** (i - 1)
        total += _conv_flops(vox(i), 1, nd, feats * 2, feats)  # up_conv_j
        # k3 s2 transposed conv: every input voxel feeds 3^nd outputs
        total += _conv_flops(vox(i), 3, nd, feats, feats)  # up_j
        total += n_blocks * 2 * _conv_flops(vox(i - 1), 3, nd, feats, feats)
    total += _conv_flops(vox(0), 1, nd, f, out_channels)  # conv_final
    return total


def unetr_fwd_flops(
    patch: Sequence[int],
    in_channels: int,
    out_channels: int,
    hidden_size: int = 768,
    num_layers: int = 12,
    mlp_dim: int = 3072,
    feature_size: int = 16,
    patch_size: int = 16,
) -> float:
    """Forward FLOPs of one sample through ``models.unetr`` — the ViT GEMMs
    (qkv/attention/out-projection/MLP) plus every conv/deconv of the skip
    branches, decoder, and head. The lane-packed phase rewrites are
    FLOP-preserving except the block-space 3^3 convs' structural zeros,
    which (as everywhere in this module) are NOT credited."""
    nd = len(patch)
    H = hidden_size
    f = feature_size
    grid = tuple(d // patch_size for d in patch)
    T = int(math.prod(grid))
    total = 0.0

    def vox(level: int) -> int:  # level = log2 downsampling from full res
        return int(math.prod(d // (2**level) for d in patch))

    # patch embedding: k16 s16 conv == one (T, p^nd*Cin) @ (., H) GEMM
    total += 2.0 * T * (patch_size**nd) * in_channels * H
    # transformer blocks: qkv (3), attention logits, attn @ V, out
    # projection, MLP in/out — all per layer
    per_layer = (
        4 * 2.0 * T * H * H  # q, k, v, out-proj
        + 2 * 2.0 * T * T * H  # scores QK^T + scores @ V (summed over heads)
        + 2 * 2.0 * T * H * mlp_dim  # MLP
    )
    total += num_layers * per_layer

    def deconv(level_in: int, ci: int, co: int) -> float:
        # k2 s2 transposed conv: every input voxel feeds 2^nd outputs
        return 2.0 * vox(level_in) * (2**nd) * ci * co

    def convblock(level: int, ci: int, co: int) -> float:
        return (_conv_flops(vox(level), 3, nd, ci, co)
                + _conv_flops(vox(level), 3, nd, co, co))

    # skip branches: enc1 at full res; enc2/3/4 progressive deconv chains
    total += convblock(0, in_channels, f)
    for tap_i, (n_up, feats) in enumerate(((3, 2 * f), (2, 4 * f), (1, 8 * f))):
        lvl = 4  # 1/16 resolution
        ci = H
        for _ in range(n_up):
            total += deconv(lvl, ci, feats)
            lvl -= 1
            total += convblock(lvl, feats, feats)
            ci = feats
    # decoder: deconv + concat + convblock, four stages up from 1/16
    ci = H
    for lvl_in, feats, skip_c in (
        (4, 8 * f, 8 * f),
        (3, 4 * f, 4 * f),
        (2, 2 * f, 2 * f),
        (1, f, f),
    ):
        total += deconv(lvl_in, ci, feats)
        total += convblock(lvl_in - 1, feats + skip_c, feats)
        ci = feats
    total += _conv_flops(vox(0), 1, nd, f, out_channels)  # head
    return total


def flagship_step_flops(
    batch: int,
    patch: Sequence[int],
    margin: int,
    num_classes: int,
    channels: Sequence[int] = (16, 32, 64, 128, 256),
    strides: Sequence[int] = (2, 2, 2, 2),
    num_res_units: int = 2,
    arch: str = "unet",
    aug_cfg=None,
) -> dict:
    """FLOPs of one training step at the flagship configuration.

    Returns ``{"model_fwd", "model_fwd_bwd", "augment", "step"}`` with
    ``step = model_fwd_bwd + augment`` (the JAX package's utilisation
    figure; on the card the port's is ``model_fwd_bwd``, see the module
    docstring). ``arch`` selects the analytic model count (unet / segresnet
    / unetr at their default configurations); ``aug_cfg`` is the
    AugmentConfig the step runs.
    """
    if arch == "segresnet":
        per_sample = segresnet_fwd_flops(patch, 1, num_classes)
    elif arch == "unetr":
        per_sample = unetr_fwd_flops(patch, 1, num_classes)
    else:
        per_sample = unet_fwd_flops(
            patch, 1, num_classes, channels, strides, num_res_units
        )
    fwd = batch * per_sample
    margin_shape = tuple(p + 2 * margin for p in patch)
    aug = augment_flops(batch, margin_shape, patch, aug_cfg=aug_cfg)
    return {
        "model_fwd": fwd,
        "model_fwd_bwd": 3.0 * fwd,
        "augment": aug,
        "step": 3.0 * fwd + aug,
    }
