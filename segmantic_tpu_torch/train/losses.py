"""Segmentation losses on channel-last logits.

Port of ``segmantic_tpu/train/losses.py``. Dice semantics match MONAI's
``DiceLoss(to_onehot_y=True, softmax=True)``: softmax over channels, one-hot
targets, per-(batch, class) sums over the spatial dims with
smooth_nr = smooth_dr = 1e-5, mean over batch and classes, background
included by default.

Probabilities are computed in f32 (f64 for f64 logits, on the CPU). The
production configuration (softmax + integer labels) is a
``torch.autograd.Function`` with the closed-form backward of the JAX
package's custom VJP: the forward keeps only the logits, the labels and the
per-(batch, class) sums, and the backward recomputes the softmax in one
sweep instead of holding the f32 probabilities across the boundary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fused_conv import at_least_f32

__all__ = ["dice_loss", "dice_loss_phase", "dice_ce_loss"]


def _onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).float()


def _sums(probs, onehot, include_background: bool):
    """Per-(batch, class) intersection and denominator over the spatial axes."""
    if not include_background:
        probs, onehot = probs[..., 1:], onehot[..., 1:]
    axes = tuple(range(1, probs.ndim - 1))
    inter = (probs * onehot).sum(axes)
    denom = probs.sum(axes) + onehot.sum(axes)
    return inter, denom


class _DiceInt(torch.autograd.Function):
    """Soft Dice of softmax(logits) against integer labels, closed-form
    backward (``losses._dice_int`` of the JAX package)."""

    @staticmethod
    def forward(ctx, logits, labels, include_background, smooth_nr, smooth_dr):
        probs = torch.softmax(at_least_f32(logits), dim=-1)
        inter, denom = _sums(probs, _onehot(labels, logits.shape[-1]), include_background)
        dice = (2.0 * inter + smooth_nr) / (denom + smooth_dr)
        ctx.save_for_backward(logits, labels, inter, denom)
        ctx.include_background = include_background
        ctx.smooth = (smooth_nr, smooth_dr)
        return (1.0 - dice).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, inter, denom = ctx.saved_tensors
        smooth_nr, smooth_dr = ctx.smooth
        # loss = mean over (n, c) of 1 - (2I + snr) / (D + sdr):
        #   dL/dI = -(g / cells) * 2 / (D + sdr)
        #   dL/dD = +(g / cells) * (2I + snr) / (D + sdr)^2
        inv = 1.0 / (denom + smooth_dr)
        scale = g / inter.numel()
        d_inter = -scale * 2.0 * inv
        d_denom = scale * (2.0 * inter + smooth_nr) * inv * inv
        if not ctx.include_background:  # class 0 received no gradient
            d_inter = F.pad(d_inter, (1, 0))
            d_denom = F.pad(d_denom, (1, 0))
        bshape = (logits.shape[0],) + (1,) * (logits.ndim - 2) + (logits.shape[-1],)
        d_inter, d_denom = d_inter.reshape(bshape), d_denom.reshape(bshape)
        # one sweep: recompute probs, dprobs = dI * onehot + dD, softmax vjp
        probs = torch.softmax(at_least_f32(logits), dim=-1)
        d_probs = d_inter * _onehot(labels, logits.shape[-1]) + d_denom
        inner = (probs * d_probs).sum(-1, keepdim=True)
        d_logits = (probs * (d_probs - inner)).to(logits.dtype)
        return d_logits, None, None, None, None


def _dice_reference(logits, labels, include_background, smooth_nr, smooth_dr,
                    apply_softmax):
    """Autograd path (one-hot labels or pre-softmaxed inputs)."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(at_least_f32(logits), dim=-1) if apply_softmax else logits
    if labels.ndim == logits.ndim - 1:
        onehot = _onehot(labels, num_classes)
    else:
        onehot = labels.float()
    inter, denom = _sums(probs, onehot, include_background)
    dice = (2.0 * inter + smooth_nr) / (denom + smooth_dr)
    return (1.0 - dice).mean()


def dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    include_background: bool = True,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
    apply_softmax: bool = True,
) -> torch.Tensor:
    """Soft Dice loss. logits (N, *spatial, C); labels (N, *spatial) integer
    or (N, *spatial, C) one-hot."""
    if apply_softmax and labels.ndim == logits.ndim - 1:
        return _DiceInt.apply(logits, labels, include_background, float(smooth_nr),
                              float(smooth_dr))
    return _dice_reference(logits, labels, include_background, float(smooth_nr),
                           float(smooth_dr), apply_softmax)


def dice_loss_phase(
    phase_logits: torch.Tensor,  # (N, *S/2, 8 * C) phase-major (models.unet)
    phase_labels: torch.Tensor,  # (N, *S/2, 8) int (space_to_depth of the labels)
    *,
    include_background: bool = True,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
    apply_softmax: bool = True,
) -> torch.Tensor:
    """:func:`dice_loss` on the UNet's phase-major logits.

    Dice sums are invariant to permuting voxels, so
    ``dice_loss_phase(s2d(logits), s2d(labels)) == dice_loss(logits, labels)``:
    the phases become one more spatial axis, (N, *S/2, 8, C), and the closed
    form of :func:`dice_loss` applies per phase voxel. (The JAX package's
    matmul-segmented formulation exists to keep the TPU's lanes dense; it
    computes the same sums and gradients.)"""
    n_phase = phase_labels.shape[-1]
    num_classes = phase_logits.shape[-1] // n_phase
    logits = phase_logits.reshape(phase_logits.shape[:-1] + (n_phase, num_classes))
    return dice_loss(logits, phase_labels, include_background=include_background,
                     smooth_nr=smooth_nr, smooth_dr=smooth_dr,
                     apply_softmax=apply_softmax)


def dice_ce_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    lambda_dice: float = 1.0,
    lambda_ce: float = 1.0,
) -> torch.Tensor:
    """Combined Dice + cross-entropy (mean over voxels of -sum onehot * logp)."""
    num_classes = logits.shape[-1]
    if labels.ndim == logits.ndim - 1:
        onehot = _onehot(labels, num_classes)
    else:
        onehot = labels.float()
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    ce = -(onehot * logp).sum(-1).mean()
    return lambda_dice * dice_loss(logits, labels) + lambda_ce * ce
