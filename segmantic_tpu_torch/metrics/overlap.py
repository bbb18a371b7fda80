"""Overlap metrics: confusion matrix and per-class Dice.

Port of ``confusion_matrix`` and ``dice_from_confusion`` of
``segmantic_tpu/metrics/overlap.py``: one ``bincount`` over joint indices
gives the full K x K matrix in a single pass, on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["confusion_matrix", "dice_from_confusion"]


def confusion_matrix(num_classes: int, target: torch.Tensor,
                     prediction: torch.Tensor) -> torch.Tensor:
    """K x K int64 confusion matrix (rows = target, cols = prediction) on the
    tensors' device."""
    joint = target.long().reshape(-1) * num_classes + prediction.long().reshape(-1)
    counts = torch.bincount(joint, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def dice_from_confusion(cm) -> np.ndarray:
    """Per-class Dice from a (host) confusion matrix, 0 where a class is
    absent."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    denom = cm.sum(axis=0) + cm.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        dice = 2 * tp / denom
    return np.where(denom > 0, dice, 0.0)
