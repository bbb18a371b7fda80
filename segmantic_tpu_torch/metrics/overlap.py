"""Overlap metrics: confusion matrix, Dice, sensitivity/specificity/etc.

Port of ``segmantic_tpu/metrics/overlap.py``: one ``bincount`` over joint
indices gives the full K x K matrix in a single pass, on the tensors' device
(numpy in, numpy out); ``dice_metric`` is MONAI's ``DiceMetric`` on discrete
label maps; ``dice_from_confusion`` and ``confusion_matrix_metrics`` are
numpy copies.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["confusion_matrix", "dice_from_confusion", "dice_metric",
           "confusion_matrix_metrics"]


def confusion_matrix(num_classes: int, target, prediction):
    """K x K int64 confusion matrix (rows = target, cols = prediction).

    numpy arrays in give a numpy array out, as in the JAX package; tensors in
    give a tensor on the tensors' device."""
    if isinstance(target, np.ndarray):
        joint = target.astype(np.int64).ravel() * num_classes + np.asarray(
            prediction).astype(np.int64).ravel()
        counts = np.bincount(joint, minlength=num_classes * num_classes)
        return counts.reshape(num_classes, num_classes)
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


def dice_metric(prediction: torch.Tensor, target: torch.Tensor, num_classes: int,
                include_background: bool = False) -> torch.Tensor:
    """Mean Dice over classes for one case (discrete label maps), a 0-d f32
    tensor on the maps' device: a class absent from both maps is nan and left
    out of the mean (nan when every class is absent), background (class 0)
    only with ``include_background``."""
    cm = confusion_matrix(num_classes, target, prediction).to(torch.float32)
    tp = torch.diagonal(cm)
    denom = cm.sum(dim=0) + cm.sum(dim=1)
    dice = torch.where(denom > 0, 2 * tp / torch.clamp(denom, min=1),
                       torch.full_like(denom, float("nan")))
    if not include_background:
        dice = dice[1:]
    return torch.nanmean(dice)


def confusion_matrix_metrics(cm) -> Dict[str, np.ndarray]:
    """Per-class sensitivity / specificity / precision / accuracy / Dice from
    a K x K confusion matrix (the metric set the reference reports per case)."""
    cm = np.asarray(cm, np.float64)
    total = cm.sum()
    tp = np.diag(cm)
    fn = cm.sum(axis=1) - tp
    fp = cm.sum(axis=0) - tp
    tn = total - tp - fn - fp

    def safe(n, d):
        with np.errstate(divide="ignore", invalid="ignore"):
            r = n / d
        return np.where(d > 0, r, 0.0)

    return {
        "sensitivity": safe(tp, tp + fn),
        "specificity": safe(tn, tn + fp),
        "precision": safe(tp, tp + fp),
        "accuracy": safe(tp + tn, total),
        "dice": safe(2 * tp, 2 * tp + fp + fn),
    }
