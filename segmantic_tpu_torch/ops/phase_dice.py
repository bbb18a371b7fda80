"""The sums and the cotangent of the phase-major soft Dice, one sweep each.

Port of ``exp/pallas_dice_ab.py``: ``dice_phase_sums`` (per-(sample, class)
intersection, probability sum and label count of the softmax over each phase
voxel's class lanes) and ``dice_phase_dx`` (the Dice cotangent from per-lane
hot/cold values, the softmax recomputed in the same sweep). ``train/losses.py``
builds the loss and its backward from the two.

Phase-major logits ``xp`` (B, *S/2, P * C) hold P fine voxels of C class
logits per coarse voxel, lane = phase * C + c; ``yp`` (B, *S/2, P) holds their
integer labels. Both wrappers launch ``csrc/phase_dice.cu`` for CUDA tensors
and run their ``_plain`` version for CPU tensors (f32, or f64 for f64 logits).

The sums kernel's launch geometry is :func:`sums_plan`: a grid sized to the
card, each block a contiguous run of one sample's voxels, each thread striding
over the run by the block's width.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _cuda
from .fused_conv import at_least_f32

__all__ = ["dice_phase_sums", "dice_phase_sums_plain", "dice_phase_dx",
           "dice_phase_dx_plain", "sums_counter", "dx_counter", "SumsPlan", "sums_plan"]

sums_counter = _cuda.LaunchCounter("dice_phase_sums")
dx_counter = _cuda.LaunchCounter("dice_phase_dx")

MAX_CLASSES = 32  # the kernels keep one voxel's class lanes in registers
THREADS = 256  # kThreads of csrc/phase_dice.cu
_DX_VOXELS_PER_BLOCK = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _geometry(xp: torch.Tensor, yp: torch.Tensor):
    """(B, voxels per sample, P, C) after checking the two shapes agree."""
    n_phase = yp.shape[-1]
    lanes = xp.shape[-1]
    if xp.shape[:-1] != yp.shape[:-1] or lanes % n_phase:
        raise ValueError(f"phase logits {tuple(xp.shape)} and phase labels "
                         f"{tuple(yp.shape)} do not describe the same voxels")
    if yp.dtype.is_floating_point or yp.dtype == torch.bool:
        raise TypeError(f"phase labels must be integer class ids, got {yp.dtype}")
    return xp.shape[0], math.prod(yp.shape[1:]), n_phase, lanes // n_phase


def _probs_onehot(xp, yp, batch, n_phase, num_classes):
    """Softmax probabilities and the boolean one-hot, both (B, V, P, C)."""
    logits = at_least_f32(xp).reshape(batch, -1, n_phase, num_classes)
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(yp.reshape(batch, -1, n_phase).long(), num_classes).bool()
    return probs, onehot


def dice_phase_sums_plain(xp: torch.Tensor, yp: torch.Tensor):
    batch, _, n_phase, num_classes = _geometry(xp, yp)
    probs, onehot = _probs_onehot(xp, yp, batch, n_phase, num_classes)
    inter = torch.where(onehot, probs, 0.0).sum((1, 2))
    return inter, probs.sum((1, 2)), onehot.to(probs.dtype).sum((1, 2))


def dice_phase_dx_plain(xp, yp, hot, cold) -> torch.Tensor:
    batch, _, n_phase, num_classes = _geometry(xp, yp)
    probs, onehot = _probs_onehot(xp, yp, batch, n_phase, num_classes)
    lane = (batch, 1, n_phase, num_classes)
    d_probs = torch.where(onehot, hot.to(probs.dtype).reshape(lane),
                          cold.to(probs.dtype).reshape(lane))
    inner = (probs * d_probs).sum(-1, keepdim=True)
    return (probs * (d_probs - inner)).reshape(xp.shape).to(xp.dtype)


@dataclass(frozen=True)
class SumsPlan:
    """Launch geometry of the sums kernel for one (batch, voxels, classes)."""
    unroll: int            # voxels a thread loads before it computes
    blocks: int            # blocks per sample: the grid is (blocks, batch)
    voxels_per_block: int  # a multiple of THREADS * unroll; the last block is ragged


def lanes_padded(num_classes: int) -> int:
    """The class lanes a voxel takes in registers: a power of two, 2 .. 32."""
    return max(2, 1 << (num_classes - 1).bit_length())


@functools.lru_cache(maxsize=64)
def sums_plan(batch: int, nvox: int, num_classes: int, sms: int) -> SumsPlan:
    """One wave of blocks on a card of ``sms`` SMs: the kernel keeps three
    blocks of THREADS resident per SM up to 8 class lanes and one beyond, so
    the grid holds at most that many, shared evenly among the samples. A block
    takes whole rounds (THREADS * unroll voxels) of one sample, so every thread
    of a full block runs the unrolled loop only; the block epilogue is paid
    once per ``voxels_per_block / THREADS`` voxels of a thread."""
    cp = lanes_padded(num_classes)
    unroll = 4 if cp <= 8 else 2 if cp == 16 else 1  # SumsUnroll of the kernel
    resident = 3 if cp <= 8 else 1
    want = max(1, resident * sms // max(batch, 1))
    tile = THREADS * unroll
    vpb = -(-(-(-nvox // want)) // tile) * tile
    return SumsPlan(unroll, -(-nvox // vpb), vpb)


def _prepare(xp, yp):
    """Checks of a CUDA call; returns (uint8 labels, B, nvox, P, C, cp)."""
    batch, nvox, n_phase, num_classes = _geometry(xp, yp)
    if xp.dtype not in _DTYPES:
        raise TypeError(f"the Dice kernels take float32 or bfloat16 logits, got {xp.dtype}")
    if not 2 <= num_classes <= MAX_CLASSES:
        raise ValueError(
            f"the Dice kernels keep a voxel's class lanes in registers and take 2 to "
            f"{MAX_CLASSES} classes ({n_phase * MAX_CLASSES} lanes at {n_phase} phases); "
            f"got {num_classes}")
    _cuda.check_cuda(xp, "phase logits")
    if xp.data_ptr() % 16:
        raise ValueError("phase logits must be 16-byte aligned")
    yp = yp.to(torch.uint8).contiguous()  # class ids < 32 fit; a no-op for uint8 labels
    _cuda.check_cuda(yp, "phase labels")
    return yp, batch, nvox, n_phase, num_classes, lanes_padded(num_classes)


def dice_phase_sums(xp: torch.Tensor, yp: torch.Tensor):
    """-> (intersection, probability sum, label count), each (B, C) f32:
    sums over all voxels of a sample of p * onehot, p and onehot, with
    p = softmax over each voxel's C lanes in f32. Deterministic: block
    partials go to a workspace and are summed in a fixed order."""
    if xp.device.type == "cpu":
        return dice_phase_sums_plain(xp, yp)
    yp, batch, nvox, _, num_classes, cp = _prepare(xp, yp)
    plan = sums_plan(batch, nvox, num_classes,
                     torch.cuda.get_device_properties(xp.device).multi_processor_count)
    partial = torch.empty((batch, plan.blocks, 3, cp), dtype=torch.float32,
                          device=xp.device)
    out = torch.empty((3, batch, num_classes), dtype=torch.float32, device=xp.device)
    _cuda.launch("segk_dice_phase_sums", xp.data_ptr(), yp.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), _DTYPES[xp.dtype], batch, num_classes, cp, nvox,
                 plan.voxels_per_block, plan.blocks, plan.unroll)
    sums_counter.count += 1
    return out[0], out[1], out[2]


def dice_phase_dx(xp: torch.Tensor, yp: torch.Tensor, hot: torch.Tensor,
                  cold: torch.Tensor) -> torch.Tensor:
    """-> ``p * (d - sum_c p * d)`` in xp's shape and type, with ``d`` the
    per-lane value ``hot`` (B, P * C) on the label's lane and ``cold``
    elsewhere: the softmax-Dice cotangent, the softmax recomputed in f32."""
    if xp.device.type == "cpu":
        return dice_phase_dx_plain(xp, yp, hot, cold)
    yp, batch, nvox, n_phase, num_classes, cp = _prepare(xp, yp)
    lanes = n_phase * num_classes
    if hot.shape != (batch, lanes) or cold.shape != (batch, lanes):
        raise ValueError(f"hot and cold must be ({batch}, {lanes}), got "
                         f"{tuple(hot.shape)} and {tuple(cold.shape)}")
    hot = hot.to(torch.float32).contiguous()
    cold = cold.to(torch.float32).contiguous()
    _cuda.check_cuda(hot, "hot")
    _cuda.check_cuda(cold, "cold")
    dx = torch.empty_like(xp)
    _cuda.launch("segk_dice_phase_dx", xp.data_ptr(), yp.data_ptr(), hot.data_ptr(),
                 cold.data_ptr(), dx.data_ptr(), _DTYPES[xp.dtype], batch, num_classes,
                 n_phase, cp, nvox, _DX_VOXELS_PER_BLOCK, -(-nvox // _DX_VOXELS_PER_BLOCK))
    dx_counter.count += 1
    return dx
