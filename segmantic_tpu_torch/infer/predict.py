"""Per-case inference: preprocess -> sliding window -> invert -> argmax.

Port of ``segmantic_tpu/infer/predict.py::segment_volume``, the core the
serving endpoint runs. The batch ``predict()`` with its label metrics and
plots is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..train.trainer import SegmentationModel, default_preprocessing, make_val_forward
from ..transforms import post as TP
from .sliding_window import sliding_window_inference


def segment_volume(
    model: SegmentationModel,
    image,  # Path, Volume, or a {"image": ...} sample dict
    *,
    val_forward=None,
    spacing: Sequence[float] = (),
    sw_batch_size: int = 4,
    overlap: float = 0.25,
):
    """Segment one image on the model's device. Returns (label Volume on the
    original grid, preprocessed sample).

    The volume is uploaded as bf16: exact when the forward computes in bf16
    (the default), since windows are cast to it anyway."""
    if val_forward is None:
        val_forward = make_val_forward(model.module)
    raw = image if isinstance(image, dict) else {"image": image}
    sample = default_preprocessing(list(raw.keys()), spacing)(raw)

    img = np.moveaxis(sample["image"].numpy(), 0, -1)
    logits = sliding_window_inference(
        img, model.spatial_size, sw_batch_size, val_forward, overlap=overlap,
        num_classes=model.num_classes, device=model.device,
        wire_dtype=torch.bfloat16,
    )
    logits = np.moveaxis(logits.cpu().numpy(), -1, 0)  # (C, *spatial)

    # invert on logits (linear), then argmax -- the reference's order
    pred_vol = sample["image"].with_data(logits.astype(np.float32))
    pred_vol.applied_ops = []
    work = dict(sample)
    work["pred"] = pred_vol
    work = TP.Invertd(keys="pred", ref_key="image", nearest=False)(work)
    work = TP.AsDiscreted(keys="pred", argmax=True)(work)
    return work["pred"], sample
