"""Multi-model ensemble inference (mean / vote / select-best).

Port of ``segmantic_tpu/infer/ensemble.py`` with ``device``: each model runs
sliding-window inference (roi 96^d, overlap 0.5, Gaussian blending) on its
device over the shared preprocessed volume; combinations are
- ``mean``: logits weighted by the val-dice parsed from each checkpoint
  filename (the load-bearing filename convention),
- ``vote``: per-model argmax then majority vote,
- ``select_best``: per-tissue best model from a yaml mapping;
then nearest inversion back to the original grid and ``<stem>_seg.nii.gz``
output.
"""

from __future__ import annotations

import enum
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..train.checkpoint import parse_val_dice
from ..train.trainer import SegmentationModel, default_preprocessing, make_val_forward
from ..transforms import post as TP
from ..utils import config as config_io
from .sliding_window import sliding_window_inference

__all__ = ["EnsembleCombination", "ensemble_evaluate", "ensemble_creator"]


class EnsembleCombination(str, enum.Enum):
    mean = "mean"
    vote = "vote"
    select_best = "select_best"


def ensemble_evaluate(
    models: List[SegmentationModel],
    sample: dict,
    roi: Sequence[int],
    sw_batch_size: int = 4,
    overlap: float = 0.5,
    forwards: Optional[list] = None,
    mesh=None,
) -> dict:
    """Run every model on a preprocessed sample -> pred0..predN logits volumes
    (host f32, channel first), each model on its own device; with a ``mesh``
    the windows are shared over its data axis and every rank gets the same
    volumes."""
    image = np.moveaxis(sample["image"].numpy(), 0, -1)
    out = dict(sample)
    for i, model in enumerate(models):
        fwd = forwards[i] if forwards else make_val_forward(model.module)
        logits = sliding_window_inference(
            image, roi, sw_batch_size, fwd, overlap=overlap,
            num_classes=model.num_classes, device=model.device, mesh=mesh,
        )
        vol = sample["image"].with_data(
            np.moveaxis(logits.cpu().numpy(), -1, 0).astype(np.float32)
        )
        vol.applied_ops = []
        out[f"pred{i}"] = vol
    return out


def ensemble_creator(
    model_files: List[Path],
    test_images: List[Path],
    test_labels: Optional[List[Path]] = None,
    output_dir: Optional[Path] = None,
    tissue_dict: Optional[Dict[str, int]] = None,
    spacing: Sequence[float] = (),
    combination_mode: str = "select_best",
    candidate_per_tissue_path: Optional[Path] = None,
    gpu_ids: Sequence[int] = (),
    roi_size: Sequence[int] = (),
    overlap: float = 0.5,
    device="cuda",
) -> List[Path]:
    """Ensemble-predict over test images on ``device`` (the card unless the
    caller asks for the CPU; CUDA without a card raises); returns saved
    prediction paths."""
    mode = (
        combination_mode.value
        if isinstance(combination_mode, EnsembleCombination)
        else str(combination_mode)
    )
    if mode == "select_best":
        if candidate_per_tissue_path is None:
            raise ValueError(
                "When using the 'select_best'-mode, candidate_per_tissue_path "
                "needs to be specified."
            )
        if tissue_dict is None:
            raise ValueError("'select_best' mode requires a tissue list")

    models = [SegmentationModel.load(Path(p), device=device) for p in model_files]
    forwards = [make_val_forward(m.module) for m in models]
    num_classes = models[0].num_classes
    ensemble_keys = [f"pred{i}" for i in range(len(models))]
    nd = models[0].spatial_dims
    roi = list(roi_size) if roi_size else [96] * nd

    have_labels = test_labels is not None and len(test_labels) == len(test_images)
    keys = ["image", "label"] if have_labels else ["image"]
    pre = default_preprocessing(keys, spacing)

    if output_dir:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    # combination pipeline
    if mode == "mean":
        weights = []
        for p in model_files:
            w = parse_val_dice(Path(p))
            weights.append(w if w is not None else 1.0)
        combine = [
            TP.MeanEnsembled(keys=ensemble_keys, output_key="pred", weights=weights),
            TP.AsDiscreted(keys="pred", argmax=True),
        ]
    elif mode == "vote":
        combine = [
            TP.AsDiscreted(keys=ensemble_keys, argmax=True),
            TP.VoteEnsembled(
                keys=ensemble_keys, output_key="pred", num_classes=num_classes
            ),
        ]
    elif mode == "select_best":
        name_model_dict = config_io.load(Path(candidate_per_tissue_path))
        label_model_dict = {
            int(tissue_dict[name]): int(model_id)
            for name, model_id in name_model_dict.items()
        }
        combine = [
            TP.AsDiscreted(keys=ensemble_keys, argmax=True),
            TP.SelectBestEnsembled(
                keys=ensemble_keys,
                output_key="pred",
                label_model_dict=label_model_dict,
            ),
        ]
    else:
        raise ValueError(f"unknown combination mode {mode!r}")

    saved: List[Path] = []
    for case_i, image_path in enumerate(test_images):
        sample = {"image": Path(image_path)}
        if have_labels:
            sample["label"] = Path(test_labels[case_i])
        sample = pre(sample)
        work = ensemble_evaluate(
            models, sample, roi, overlap=overlap, forwards=forwards
        )
        for t in combine:
            work = t(work)
        work = TP.Invertd(keys="pred", ref_key="image", nearest=True)(work)
        if output_dir:
            TP.SaveImaged(
                keys="pred",
                output_dir=output_dir,
                output_postfix="seg",
                ref_key="image",
            )(work)
            saved.append(Path(work["pred"].meta["saved_to"]))
    return saved
