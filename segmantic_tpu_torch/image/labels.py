"""Tissue-label list files (iSEG format) and decathlon label maps.

Port of ``load_tissue_list`` and ``load_decathlon_tissuelist`` of
``segmantic_tpu/image/labels.py`` (the JAX package's module is jax-free, but
its package import pulls in jax): label 0 is the implicit Background.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

__all__ = ["load_tissue_list", "load_decathlon_tissuelist"]


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


def load_decathlon_tissuelist(file_name: Path) -> Dict[str, int]:
    """Tissue labels from a decathlon-style datalist json's 'labels' key."""
    labels: Dict[str, str] = json.loads(Path(file_name).read_text())["labels"]
    labels.setdefault("0", "Background")
    labels["0"] = "Background"
    return {name: int(label) for label, name in labels.items()}
