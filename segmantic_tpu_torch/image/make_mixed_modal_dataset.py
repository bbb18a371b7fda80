"""Mix two modalities into one training set by suffixing file stems.

Port of ``segmantic_tpu/image/make_mixed_modal_dataset.py`` (reference:
src/segmantic/image/make_mixed_modal_dataset.py:5-35): copies paired
image/label files from two modality dirs into a single dataset with
``_mdix0`` / ``_mdix1`` stem suffixes.
"""

from __future__ import annotations

import shutil
from pathlib import Path

from ..utils.file_iterators import find_matching_files

__all__ = ["copy_image_labels", "make_mixed_modal_dataset"]


def copy_image_labels(
    image_dir: Path,
    labels_dir: Path,
    output_image_dir: Path,
    output_labels_dir: Path,
    suffix: str,
    glob: str = "*.nii.gz",
    ext: str = ".nii.gz",
) -> int:
    """Copy matching image/label pairs adding ``suffix`` to the stems."""
    output_image_dir = Path(output_image_dir)
    output_labels_dir = Path(output_labels_dir)
    output_image_dir.mkdir(parents=True, exist_ok=True)
    output_labels_dir.mkdir(parents=True, exist_ok=True)

    pairs = find_matching_files(
        [Path(image_dir) / glob, Path(labels_dir) / glob], verbose=False
    )
    for image_file, label_file in pairs:
        stem = image_file.name.replace(ext, "")
        shutil.copyfile(image_file, output_image_dir / f"{stem}{suffix}{ext}")
        shutil.copyfile(label_file, output_labels_dir / f"{stem}{suffix}{ext}")
    return len(pairs)


def make_mixed_modal_dataset(
    modality0_image_dir: Path,
    modality0_labels_dir: Path,
    modality1_image_dir: Path,
    modality1_labels_dir: Path,
    output_image_dir: Path,
    output_labels_dir: Path,
) -> None:
    copy_image_labels(
        modality0_image_dir, modality0_labels_dir,
        output_image_dir, output_labels_dir, "_mdix0",
    )
    copy_image_labels(
        modality1_image_dir, modality1_labels_dir,
        output_image_dir, output_labels_dir, "_mdix1",
    )
