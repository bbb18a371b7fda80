"""Batch inference entry: preprocess -> sliding window -> invert -> save +
metrics.

Port of ``segmantic_tpu/infer/predict.py``: ``segment_volume``, the per-case
core the serving endpoint runs, and ``predict`` with the JAX signature plus
``device``: sliding window with roi = the model's training patch size and
sw-batch 4 on the card, inversion of the deterministic preprocessing (linear
on logits, then argmax), flat ``<stem>.nii.gz`` outputs, per-case Dice and
sensitivity / specificity / precision / accuracy from a confusion matrix
counted on the model's device, per-case confusion-matrix PNG, the
``mean_dice.txt`` dump and the totals table. Each case's
:class:`CaseResult` carries the seconds of its stages.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.nifti import read_volume
from ..metrics.overlap import confusion_matrix, confusion_matrix_metrics, dice_from_confusion
from ..parallel.mesh import is_main
from ..train.trainer import SegmentationModel, default_preprocessing, make_val_forward
from ..transforms import post as TP
from ..transforms.spatial import LoadImaged
from .sliding_window import sliding_window_inference

__all__ = ["CaseResult", "segment_volume", "predict"]


@dataclasses.dataclass
class CaseResult:
    image: Path
    saved_to: Optional[Path]
    dice: Optional[float] = None
    per_class_dice: Optional[np.ndarray] = None
    metrics: Optional[Dict[str, np.ndarray]] = None
    # host-clock seconds per stage: read, preprocessing, sliding_window
    # (upload, windows, blend, logits to the host), inversion, argmax,
    # metrics, write
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


class _Stages:
    """Adds the host-clock seconds since the last mark to ``seconds[name]``."""

    def __init__(self, seconds: Optional[Dict[str, float]]):
        self.seconds = seconds if seconds is not None else {}
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


def segment_volume(
    model: SegmentationModel,
    image,  # Path, Volume, or a {"image": ..., ["label": ...]} sample dict
    *,
    val_forward=None,
    pre=None,
    spacing: Sequence[float] = (),
    sw_batch_size: int = 4,
    overlap: float = 0.25,
    seconds: Optional[Dict[str, float]] = None,
    mesh=None,
    shard_volume: bool = False,
):
    """Segment one image on the model's device. Returns (label Volume on the
    original grid, preprocessed sample).

    ``pre`` is the preprocessing pipeline (default: ``default_preprocessing``
    over the sample's keys with ``spacing``); files are read before it runs.
    The volume is uploaded as bf16: exact when the forward computes in bf16
    (the default), since windows are cast to it anyway. A ``seconds`` dict
    gets the host-clock seconds of read, preprocessing, sliding_window,
    inversion and argmax added. ``mesh`` / ``shard_volume`` go to the sliding
    window (every rank of the mesh returns the same label volume)."""
    stages = _Stages(seconds)
    if val_forward is None:
        val_forward = make_val_forward(model.module)
    raw = image if isinstance(image, dict) else {"image": image}
    if pre is None:
        pre = default_preprocessing(list(raw.keys()), spacing)
    raw = LoadImaged(keys=list(raw.keys()))(raw)
    stages.mark("read")
    sample = pre(raw)
    stages.mark("preprocessing")

    img = np.moveaxis(sample["image"].numpy(), 0, -1)
    logits = sliding_window_inference(
        img, model.spatial_size, sw_batch_size, val_forward, overlap=overlap,
        num_classes=model.num_classes, device=model.device,
        wire_dtype=torch.bfloat16, mesh=mesh, shard_volume=shard_volume,
    )
    logits = np.moveaxis(logits.cpu().numpy(), -1, 0)  # (C, *spatial)
    stages.mark("sliding_window")

    # invert on logits (linear), then argmax -- the reference's order
    pred_vol = sample["image"].with_data(logits.astype(np.float32))
    pred_vol.applied_ops = []
    work = dict(sample)
    work["pred"] = pred_vol
    work = TP.Invertd(keys="pred", ref_key="image", nearest=False)(work)
    stages.mark("inversion")
    work = TP.AsDiscreted(keys="pred", argmax=True)(work)
    stages.mark("argmax")
    return work["pred"], sample


def predict(
    model_file: Path,
    test_images: List[Path],
    test_labels: Optional[List[Path]] = None,
    output_dir: Optional[Path] = None,
    tissue_dict: Optional[Dict[str, int]] = None,
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256),
    strides: Tuple[int, ...] = (2, 2, 2, 2),
    dropout: float = 0.0,
    spacing: Sequence[float] = (),
    gpu_ids: Sequence[int] = (),
    sw_batch_size: int = 4,
    overlap: float = 0.25,
    save_confusion_plots: bool = True,
    mesh=None,
    device="cuda",
) -> List[CaseResult]:
    """Run inference on test images on ``device`` (the card unless the caller
    asks for the CPU; CUDA without a card raises); returns per-case results.

    ``channels``/``strides``/``dropout``/``gpu_ids`` are accepted for config
    compatibility -- hyperparameters actually come from the checkpoint.
    ``mesh`` (:func:`..parallel.make_mesh`): each volume's windows are shared
    over its data axis; every rank computes the same results, and the first
    rank of each node (rank 0 on one node) writes the files and prints."""
    main = is_main(mesh)
    model = SegmentationModel.load(Path(model_file), device=device)
    num_classes = model.num_classes
    val_forward = make_val_forward(model.module)

    have_labels = test_labels is not None and len(test_labels) == len(test_images)
    keys = ["image", "label"] if have_labels else ["image"]
    pre = default_preprocessing(keys, spacing)

    if output_dir:
        output_dir = Path(output_dir)
        if main:
            output_dir.mkdir(parents=True, exist_ok=True)

    tissue_names = [str(i) for i in range(num_classes)]
    if tissue_dict:
        for name, idx in tissue_dict.items():
            if 0 <= idx < num_classes:
                tissue_names[idx] = name

    results: List[CaseResult] = []
    all_case_dices: List[float] = []
    total_cm = np.zeros((num_classes, num_classes), np.int64)

    for case_i, image_path in enumerate(test_images):
        raw = {"image": Path(image_path)}
        if have_labels:
            raw["label"] = Path(test_labels[case_i])
        result = CaseResult(image=Path(image_path), saved_to=None)
        pred, sample = segment_volume(
            model, raw, val_forward=val_forward, pre=pre,
            sw_batch_size=sw_batch_size, overlap=overlap, seconds=result.seconds, mesh=mesh,
        )
        stages = _Stages(result.seconds)

        if output_dir and main:
            work = dict(sample)
            work["pred"] = pred
            TP.SaveImaged(
                keys="pred", output_dir=output_dir, output_postfix="", ref_key="image"
            )(work)
            result.saved_to = Path(pred.meta["saved_to"])
            stages.mark("write")

        if have_labels:
            # compare in the ORIGINAL grid: the raw label (uninverted reference)
            true_lbl = read_volume(Path(test_labels[case_i])).numpy()[0].astype(np.int64)
            stages.mark("read")
            pred_lbl = pred.numpy()[0].astype(np.int64)
            cm = confusion_matrix(
                num_classes, torch.from_numpy(true_lbl).to(model.device),
                torch.from_numpy(pred_lbl).to(model.device)).cpu().numpy()
            total_cm += cm
            per_class = dice_from_confusion(cm)
            # classes in either map, as np.unique over both would give
            present = (cm.sum(axis=0) + cm.sum(axis=1)) > 0
            present[0] = False
            case_dice = float(per_class[present].mean()) if present.any() else 0.0
            metrics = confusion_matrix_metrics(cm)
            stages.mark("metrics")

            result.dice = case_dice
            result.per_class_dice = per_class
            result.metrics = metrics
            all_case_dices.append(case_dice)

            if main:
                print(f"case {image_path}: mean_dice={case_dice:.4f}")
                _print_table(
                    ["tissue"] + ["dice", "sensitivity", "precision"],
                    [
                        [tissue_names[c]]
                        + [
                            f"{per_class[c]:.4f}",
                            f"{metrics['sensitivity'][c]:.4f}",
                            f"{metrics['precision'][c]:.4f}",
                        ]
                        for c in range(1, num_classes)
                    ],
                )

            if output_dir and save_confusion_plots and main:
                from ..viz.plots import plot_confusion_matrix

                stem = Path(image_path).name.replace(".nii.gz", "").replace(".nii", "")
                plot_confusion_matrix(
                    cm, tissue_names, output_dir / f"{stem}_confusion.png", title=f"{stem}",
                )
                stages.mark("write")
        results.append(result)

    if have_labels:
        mean_dice = float(np.mean(all_case_dices)) if all_case_dices else 0.0
        if main:
            print(f"mean dice over {len(all_case_dices)} cases: {mean_dice:.4f}")
        if output_dir and main:
            (Path(output_dir) / "mean_dice.txt").write_text(
                "\n".join(f"{d:.6f}" for d in all_case_dices)
                + f"\nmean\t{mean_dice:.6f}\n"
            )
            totals = confusion_matrix_metrics(total_cm)
            _print_table(
                ["tissue", "dice", "sensitivity", "specificity", "precision", "accuracy"],
                [
                    [tissue_names[c]]
                    + [f"{totals[m][c]:.4f}" for m in ("dice", "sensitivity", "specificity", "precision", "accuracy")]
                    for c in range(1, num_classes)
                ],
            )
    return results


def _print_table(header: List[str], rows: List[List[str]], indent: str = "\t") -> None:
    print(indent + "\t".join(header).expandtabs(24))
    for row in rows:
        print(indent + "\t".join(str(x) for x in row).expandtabs(24))
