"""Tissue-label list files (iSEG format) and label mappings.

Port of ``segmantic_tpu/image/labels.py`` (the JAX package's module is
jax-free, but its package import pulls in jax): iSEG ``V7`` header, ``N<k>``
count, ``C r g b a name`` rows; label 0 is the implicit Background.
"""

from __future__ import annotations

import colorsys
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["build_tissue_mapping", "default_tissue_color", "save_tissue_list",
           "load_tissue_list", "load_tissue_colors", "load_decathlon_tissuelist"]

RGBTuple = Tuple[float, float, float]


def build_tissue_mapping(
    input_label_map: Dict[str, int], mapper: Callable[[str], str]
) -> Tuple[Dict[str, int], np.ndarray]:
    """Map tissue names through ``mapper``; return the new name->label dict and
    a uint16 LUT from old to new labels (Background stays label 0)."""
    mapped_names = sorted({mapper(name) for name in input_label_map})
    mapped_names.remove("Background")
    mapped_names = ["Background"] + mapped_names
    output_label_map = {name: i for i, name in enumerate(mapped_names)}

    lut = np.zeros((len(input_label_map),), dtype=np.uint16)
    for name, old_label in input_label_map.items():
        lut[old_label] = output_label_map[mapper(name)]
    return output_label_map, lut


def default_tissue_color(label: int, num_tissues: int) -> RGBTuple:
    """Deterministic HLS color wheel for tissue ``label`` (1-based)."""
    if label <= 0:
        raise ValueError("Background (label=0) is implicit and not written to file")
    hue = min(label / (2.0 * num_tissues) + (label % 2) * 0.5, 1.0)
    return colorsys.hls_to_rgb(hue, 0.5, 1.0)


def save_tissue_list(
    tissue_label_map: Dict[str, int],
    tissue_list_file_name: Path,
    tissue_color_map: Optional[Callable[[str], RGBTuple]] = None,
) -> None:
    """Write an iSEG-format tissue list (labels must be 1..N, no duplicates)."""
    num_tissues = max(tissue_label_map.values())
    by_label: Dict[int, str] = {}
    for name, label in tissue_label_map.items():
        if label in by_label:
            raise KeyError("duplicate labels found in 'tissue_label_map'")
        by_label[label] = name

    lines = ["V7", f"N{num_tissues}"]
    for label in range(1, num_tissues + 1):
        name = by_label[label]
        if tissue_color_map is not None:
            r, g, b = tissue_color_map(name)
        else:
            r, g, b = default_tissue_color(label, num_tissues)
        lines.append(f"C{r:.2f} {g:.2f} {b:.2f} {0.5:.2f} {name}")
    Path(tissue_list_file_name).write_text("\n".join(lines) + "\n")


def load_tissue_list(file_name: Path) -> Dict[str, int]:
    """Load an iSEG-format tissue list -> {name: label} incl. Background=0."""
    tissue_label_map = {"Background": 0}
    for line in Path(file_name).read_text().splitlines():
        if line.startswith("C"):
            name = line.strip().rsplit(" ", 1)[-1].rstrip()
            if name in tissue_label_map:
                raise KeyError(f"duplicate label '{name}' found in '{file_name}'")
            tissue_label_map[name] = len(tissue_label_map)
    return tissue_label_map


def load_tissue_colors(file_name: Path) -> Dict[int, RGBTuple]:
    """Load {label: (r,g,b)} from an iSEG tissue list (Background is black)."""
    colors: Dict[int, RGBTuple] = {0: (0.0, 0.0, 0.0)}
    for line in Path(file_name).read_text().splitlines():
        if line.startswith("C"):
            r, g, b = (float(v) for v in line[1:].split(" ")[:3])
            colors[len(colors)] = (r, g, b)
    return colors


def load_decathlon_tissuelist(file_name: Path) -> Dict[str, int]:
    """Tissue labels from a decathlon-style datalist json's 'labels' key."""
    labels: Dict[str, str] = json.loads(Path(file_name).read_text())["labels"]
    labels.setdefault("0", "Background")
    labels["0"] = "Background"
    return {name: int(label) for label, name in labels.items()}
