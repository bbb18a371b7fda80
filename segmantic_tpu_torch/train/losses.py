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
sweep instead of holding the f32 probabilities across the boundary. On
phase-major logits (the train step's case) both sweeps are the hand-written
kernels of ``ops/phase_dice.py`` on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import phase_dice
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
        #   dL/dI = -(g / cells) * 2 / (D + sdr)
        #   dL/dD = +(g / cells) * (2I + snr) / (D + sdr)^2
        d_inter, d_denom = _dice_cotangents(g, inter, denom, ctx.include_background,
                                            smooth_nr, smooth_dr)
        bshape = (logits.shape[0],) + (1,) * (logits.ndim - 2) + (logits.shape[-1],)
        d_inter, d_denom = d_inter.reshape(bshape), d_denom.reshape(bshape)
        # one sweep: recompute probs, dprobs = dI * onehot + dD, softmax vjp
        probs = torch.softmax(at_least_f32(logits), dim=-1)
        d_probs = d_inter * _onehot(labels, logits.shape[-1]) + d_denom
        inner = (probs * d_probs).sum(-1, keepdim=True)
        d_logits = (probs * (d_probs - inner)).to(logits.dtype)
        return d_logits, None, None, None, None


def _dice_cotangents(g, inter, denom, include_background, smooth_nr, smooth_dr):
    """dL/d(intersection) and dL/d(denominator), (B, C) each, of
    loss = mean over (n, c) of 1 - (2I + snr) / (D + sdr); class 0 padded
    back in (it received no gradient) where the background was excluded."""
    inv = 1.0 / (denom + smooth_dr)
    scale = g / inter.numel()
    d_inter = -scale * 2.0 * inv
    d_denom = scale * (2.0 * inter + smooth_nr) * inv * inv
    if not include_background:
        d_inter = F.pad(d_inter, (1, 0))
        d_denom = F.pad(d_denom, (1, 0))
    return d_inter, d_denom


class _DicePhase(torch.autograd.Function):
    """:class:`_DiceInt` on phase-major logits (B, *S/2, P * C) and labels
    (B, *S/2, P), from the two sweeps of ``ops/phase_dice.py``: the forward is
    ``dice_phase_sums`` plus the (B, C) Dice arithmetic, the backward the
    per-lane hot / cold values plus ``dice_phase_dx``
    (``losses._dice_phase_fwd`` / ``_dice_phase_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, xp, yp, include_background, smooth_nr, smooth_dr):
        # the kernels read dense channel-last rows; a conv's output may be a
        # permuted view (PyTorch's native convs return NCHW)
        xp = xp.contiguous()
        inter, prob_sum, count = phase_dice.dice_phase_sums(xp, yp)
        denom = prob_sum + count
        if not include_background:
            inter, denom = inter[:, 1:], denom[:, 1:]
        dice = (2.0 * inter + smooth_nr) / (denom + smooth_dr)
        ctx.save_for_backward(xp, yp, inter, denom)
        ctx.include_background = include_background
        ctx.smooth = (smooth_nr, smooth_dr)
        return (1.0 - dice).mean()

    @staticmethod
    def backward(ctx, g):
        xp, yp, inter, denom = ctx.saved_tensors
        d_inter, d_denom = _dice_cotangents(g, inter, denom, ctx.include_background,
                                            *ctx.smooth)
        # per-lane values, lane = phase * C + c. d_inter and d_denom have
        # opposite signs: they are summed in f32 before any select, or a
        # near-perfect Dice would cancel at the width of the logits
        n_phase = yp.shape[-1]
        hot = (d_inter + d_denom).repeat(1, n_phase)
        cold = d_denom.repeat(1, n_phase)
        return phase_dice.dice_phase_dx(xp, yp, hot, cold), None, None, None, None


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
    ``dice_loss_phase(s2d(logits), s2d(labels)) == dice_loss(logits, labels)``.
    The production case (softmax, integer labels) takes the two streaming
    sweeps of ``ops/phase_dice.py``, kernels on the card. (The JAX package's
    matmul-segmented formulation exists to keep the TPU's lanes dense; it
    computes the same sums and gradients.) Otherwise the phases become one
    more spatial axis, (N, *S/2, 8, C), of :func:`dice_loss`."""
    integer = not (phase_labels.dtype.is_floating_point or phase_labels.dtype == torch.bool)
    if apply_softmax and phase_labels.ndim == phase_logits.ndim and integer:
        return _DicePhase.apply(phase_logits, phase_labels, include_background,
                                float(smooth_nr), float(smooth_dr))
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
