"""Vertebra-landmark dict-transforms (keypoint workloads).

Port of ``segmantic_tpu/detect/transforms.py`` (the reference's detect
transform library, reference: src/segmantic/detect/transforms.py:28-285):
json landmark load/save with name<->id mapping, physical-point<->voxel
embedding via the affine, per-channel heat-map peak extraction, bounding
boxes (numpy copies on the host), and class-centroid Gaussian heat maps
(sigma = 1.6 + 0.1 * (label - 1), scaled to [0, 1] then x gamma), which
:class:`VertHeatMap` smooths on ``device`` (default the card) through
``ops.gaussian.gaussian_smooth`` and returns on the host.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.volume import Volume
from ..ops._cuda import resolve_device
from ..ops.gaussian import gaussian_smooth
from ..transforms.base import MapTransform, Sample
from ..transforms.spatial import foreground_bbox

__all__ = ["LoadVert", "SaveVert", "EmbedVert", "ExtractVertPosition", "BoundingBoxd",
           "VertHeatMap"]

DEFAULT_POST_FIX = "meta_dict"

logger = logging.getLogger(__name__)


def _affine_of(obj, sample: Sample, key: str, postfix: str) -> np.ndarray:
    if isinstance(obj, Volume):
        return np.asarray(obj.affine)
    meta = sample.get(f"{key}_{postfix}", {})
    return np.asarray(meta.get("affine", np.eye(4)))


class LoadVert(MapTransform):
    """Load landmark positions from json: {name: [x,y,z]} → {id: np.array}."""

    def __init__(self, keys, meta_key_postfix: str = DEFAULT_POST_FIX):
        super().__init__(keys)
        self.meta_key_postfix = meta_key_postfix

    def __call__(self, sample: Sample) -> Sample:
        d = dict(sample)
        for key in self.present_keys(sample):
            filename = d[key]
            raw: Dict[str, list] = json.loads(Path(filename).read_text())
            try:
                id_map = {name: int(name) for name in raw}
            except ValueError:
                id_map = {name: i for i, name in enumerate(sorted(raw), start=1)}
            d[key] = {id_map[name]: np.asarray(raw[name]) for name in raw}
            d[f"{key}_{self.meta_key_postfix}"] = {
                "filename_or_obj": filename,
                "id_map": id_map,
            }
        return d


class SaveVert(MapTransform):
    """Save landmark dicts back to json (names restored from the id_map)."""

    def __init__(
        self,
        keys,
        meta_key_postfix: str = DEFAULT_POST_FIX,
        output_dir: Path = Path("./"),
        output_postfix: str = "trans",
        output_ext: str = ".json",
        separate_folder: bool = True,
        print_log: bool = True,
    ):
        super().__init__(keys)
        self.meta_key_postfix = meta_key_postfix
        self.output_dir = Path(output_dir)
        self.output_postfix = output_postfix
        self.output_ext = output_ext
        self.separate_folder = separate_folder
        self.print_log = print_log
        self._data_index = 0

    def _filename(self, subject: str) -> Path:
        stem = Path(subject).name
        for ext in (".json", ".nii.gz", ".nii"):
            if stem.endswith(ext):
                stem = stem[: -len(ext)]
        name = f"{stem}_{self.output_postfix}{self.output_ext}" if self.output_postfix else f"{stem}{self.output_ext}"
        folder = self.output_dir / stem if self.separate_folder else self.output_dir
        folder.mkdir(parents=True, exist_ok=True)
        return folder / name

    def __call__(self, sample: Sample) -> Sample:
        d = dict(sample)
        for key in self.present_keys(sample):
            meta = d.get(f"{key}_{self.meta_key_postfix}", {})
            subject = str(meta.get("filename_or_obj", self._data_index))
            self._data_index += 1
            filename = self._filename(subject)
            verts: Dict[int, np.ndarray] = d[key]
            id_map = meta.get("id_map", {str(i): i for i in verts})
            name_map = {v: k for k, v in id_map.items()}
            out = {name_map[i]: [float(x) for x in v] for i, v in verts.items()}
            filename.write_text(json.dumps(out))
            if self.print_log:
                logger.info("wrote %s", filename)
        return d


class EmbedVert(MapTransform):
    """Rasterize physical landmark points into the reference image grid."""

    def __init__(self, keys, ref_key: str, meta_key_postfix: str = DEFAULT_POST_FIX):
        super().__init__(keys)
        self.ref_key = ref_key
        self.meta_key_postfix = meta_key_postfix

    def __call__(self, sample: Sample) -> Sample:
        d = dict(sample)
        ref = d[self.ref_key]
        affine = _affine_of(ref, d, self.ref_key, self.meta_key_postfix)
        rot_inv = np.linalg.inv(affine[:3, :3])
        t = affine[:3, 3]

        ref_data = ref.numpy() if isinstance(ref, Volume) else np.asarray(ref)
        has_channel = isinstance(ref, Volume)

        for key in self.present_keys(sample):
            verts: Dict[int, np.ndarray] = d[key]
            out = np.zeros(ref_data.shape, dtype=np.int32)
            for label, p in verts.items():
                idx = np.round(rot_inv @ (np.asarray(p, np.float64) - t)).astype(int)
                if has_channel:
                    out[(0,) + tuple(idx)] = label
                else:
                    out[tuple(idx)] = label
            if isinstance(ref, Volume):
                d[key] = Volume(data=out, affine=affine.copy())
            else:
                d[key] = out
                d.setdefault(f"{key}_{self.meta_key_postfix}", {}).update(
                    {"affine": affine}
                )
        return d


class ExtractVertPosition(MapTransform):
    """Per-channel heat-map peak → physical coordinates via the affine."""

    def __init__(self, keys, threshold: float = 0.5, meta_key_postfix: str = DEFAULT_POST_FIX):
        super().__init__(keys)
        self.threshold = threshold
        self.meta_key_postfix = meta_key_postfix

    def __call__(self, sample: Sample) -> Sample:
        d = dict(sample)
        for key in self.present_keys(sample):
            img = d[key]
            data = img.numpy() if isinstance(img, Volume) else np.asarray(img)
            affine = _affine_of(img, d, key, self.meta_key_postfix)
            rot, t = affine[:3, :3], affine[:3, 3]
            vertices: Dict[int, np.ndarray] = {}
            for label in range(1, data.shape[0]):
                chan = data[label]
                peak = chan.max()
                if peak < self.threshold:
                    continue
                idx = np.unravel_index(int(np.argmax(chan)), chan.shape)
                p = np.asarray(idx, np.float64)
                vertices[label] = rot @ p + t
            d[key] = vertices
        return d


class BoundingBoxd(MapTransform):
    """Store the foreground bounding box of each key under result[bbox]."""

    def __init__(self, keys, result: str = "result", bbox: str = "bbox"):
        super().__init__(keys)
        self.result = result
        self.bbox = bbox

    def __call__(self, sample: Sample) -> Sample:
        d = dict(sample)
        for key in self.present_keys(sample):
            img = d[key]
            data = img.numpy() if isinstance(img, Volume) else np.asarray(img)
            if data.ndim == len(getattr(img, "spatial_shape", data.shape)):
                data = data[None]
            start, end = foreground_bbox(data)
            if d.get(self.result) is None:
                d[self.result] = {}
            d[self.result][self.bbox] = [list(start), list(end)]
        return d


class VertHeatMap(MapTransform):
    """Class-centroid Gaussian heat maps from a label volume.

    For each class c>0: center of mass (each coordinate's mean truncated by
    ``int``) -> 1.0 impulse -> Gaussian smoothing with sigma = 1.6 +
    0.1 * (c - 1) on ``device`` -> scaled to [0, 1] by its peak -> x gamma.
    Output is one-hot-shaped (len(label_names) + 1, *spatial) float32 on the
    host (a Volume for a Volume input). ``device`` defaults to the card and
    refuses without one; pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, keys, gamma: float = 1000.0, label_names: Optional[List[str]] = None,
                 device="cuda"):
        super().__init__(keys)
        self.gamma = gamma
        self.label_names = label_names or []
        self.device = resolve_device(device)

    def __call__(self, sample: Sample) -> Sample:
        d = dict(sample)
        for key in self.present_keys(sample):
            img = d[key]
            data = img.numpy() if isinstance(img, Volume) else np.asarray(img)
            lbl = data[0].astype(np.int64)  # (spatial)
            num_channels = len(self.label_names) + 1
            out = np.zeros((num_channels,) + lbl.shape, dtype=np.float32)

            for cls in np.unique(lbl):
                if cls == 0:
                    continue
                coords = np.where(lbl == cls)
                center = tuple(int(np.average(c)) for c in coords)
                impulse = torch.zeros((1,) + lbl.shape, dtype=torch.float32,
                                      device=self.device)
                impulse[(0,) + center] = 1.0
                sigma = 1.6 + (float(cls) - 1.0) * 0.1
                smooth = gaussian_smooth(impulse, sigma)[0]
                peak = smooth.max()
                if peak > 0:
                    smooth = smooth / peak
                out[int(cls)] = (smooth * self.gamma).cpu().numpy()

            if isinstance(img, Volume):
                d[key] = img.with_data(out)
            else:
                d[key] = out
        return d
