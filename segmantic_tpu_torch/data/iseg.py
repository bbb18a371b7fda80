"""iSEG HDF5 export (gzip datasets + tissue groups + decomposed affine).

Port of ``segmantic_tpu/data/iseg.py``, a numpy / h5py copy on the host
(format parity with the reference's exporter, reference:
src/segmantic/data/transforms.py:29-156): datasets ``Tissue/Source/Target``
(flattened, gzip-1), the affine decomposed into
``rotation/dimensions/offset/pixelsize``, per-tissue ``index`` + ``rgbo``
groups under ``Tissues`` plus ``bkg_rgbo``/``version``; the ``iSegSaver``
dict-transform tolerates a missing image or label key by substituting the
other. h5py is imported inside :func:`export_to_iseg`, so the module imports
without it.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..core.volume import Volume
from ..transforms.base import MapTransform, Sample

__all__ = ["voxel_sizes", "export_to_iseg", "iSegSaver"]

LabelInfo = Tuple[str, float, float, float]


def voxel_sizes(affine: np.ndarray) -> np.ndarray:
    """Voxel sizes in mm: column norms of the affine's linear part."""
    top_left = np.asarray(affine)[:-1, :-1]
    return np.sqrt(np.sum(top_left**2, axis=0))


def export_to_iseg(
    iseg_file_path,
    label_field: np.ndarray,
    image: np.ndarray,
    affine: np.ndarray,
    labels: Dict[int, LabelInfo],
) -> None:
    import h5py

    with h5py.File(iseg_file_path, "w") as f:
        f.create_dataset(
            "Tissue",
            dtype=np.uint16,
            data=np.asarray(label_field).ravel(),
            compression="gzip",
            compression_opts=1,
        )
        f.create_dataset(
            "Source",
            dtype=float,
            data=np.asarray(image, np.float64).ravel(),
            compression="gzip",
            compression_opts=1,
        )
        f.create_dataset(
            "Target",
            dtype=float,
            data=np.zeros(np.asarray(image).size),
            compression="gzip",
            compression_opts=1,
        )

        affine = np.asarray(affine, np.float64)
        f.create_dataset("rotation", dtype=float, data=affine[:-1, :-1].ravel())
        f.create_dataset("dimensions", dtype=float, data=np.asarray(image).shape)
        f.create_dataset("offset", dtype=float, data=affine[:-1, -1])
        f.create_dataset("pixelsize", dtype=float, data=voxel_sizes(affine))

        tissues = f.create_group("Tissues")
        for idx, info in labels.items():
            try:
                name, r, g, b = info
                group = tissues.create_group(name)
                group.create_dataset("index", dtype=np.int32, data=np.array([idx]))
                group.create_dataset(
                    "rgbo", dtype=float, data=np.array([r, g, b, 0.5])
                )
            except Exception as err:  # malformed entry: skip it, keep exporting
                print(
                    f"skipping tissue entry {idx}={info!r}: {err}",
                    file=sys.stderr,
                )
        tissues.create_dataset("bkg_rgbo", dtype=float, data=np.array([0, 0, 0, 0.5]))
        tissues.create_dataset("version", dtype=np.int32, data=np.array([0]))


class iSegSaver(MapTransform):
    """Dict-transform writing (image, label) Volumes to an iSEG .h5 file.

    Missing image → label substitutes (and vice versa). Output name follows
    the source filename: ``output_dir[/stem]/stem_<postfix>.h5``.
    """

    def __init__(
        self,
        keys,
        label_dict: Dict[int, LabelInfo],
        image_key: str = "image",
        label_key: str = "label",
        allow_missing_keys: bool = False,
        output_dir: Path = Path("./"),
        output_postfix: str = "trans",
        output_ext: str = ".h5",
        separate_folder: bool = True,
        print_log: bool = True,
    ):
        super().__init__(keys)
        self.label_dict = label_dict
        self.image_key = image_key
        self.label_key = label_key
        self.allow_missing_keys = allow_missing_keys
        self.output_dir = Path(output_dir)
        self.output_postfix = output_postfix
        self.output_ext = output_ext
        self.separate_folder = separate_folder
        self.print_log = print_log
        self._data_index = 0

    def _filename(self, subject: str) -> Path:
        stem = Path(str(subject)).name
        for ext in (".nii.gz", ".nii", ".h5"):
            if stem.endswith(ext):
                stem = stem[: -len(ext)]
        name = (
            f"{stem}_{self.output_postfix}{self.output_ext}"
            if self.output_postfix
            else f"{stem}{self.output_ext}"
        )
        folder = self.output_dir / stem if self.separate_folder else self.output_dir
        folder.mkdir(parents=True, exist_ok=True)
        return folder / name

    def __call__(self, sample: Sample) -> Sample:
        d = dict(sample)
        if not self.allow_missing_keys and any(k not in d for k in self.keys):
            raise RuntimeError(f"{type(self).__name__}: missing keys in data")
        if self.image_key not in d and self.label_key not in d:
            raise RuntimeError(
                f"{type(self).__name__}: neither {self.image_key} nor "
                f"{self.label_key} found in data"
            )

        image_key = self.image_key if self.image_key in d else self.label_key
        label_key = self.label_key if self.label_key in d else self.image_key
        image_vol: Volume = d[image_key]
        label_vol: Volume = d[label_key]

        image = np.squeeze(image_vol.numpy())
        label = np.squeeze(label_vol.numpy())
        if image.shape != label.shape:
            raise RuntimeError(
                f"{type(self).__name__}: image and label have different shape"
            )

        subject = image_vol.meta.get("filename", str(self._data_index))
        self._data_index += 1
        filename = self._filename(subject)
        export_to_iseg(
            filename,
            label_field=label,
            image=image,
            affine=image_vol.affine,
            labels=self.label_dict,
        )
        if self.print_log:
            print(f"wrote {filename}")
        return sample
