"""Visualization: tissue colormaps + annotated confusion-matrix plots.

Port of ``segmantic_tpu/viz/plots.py`` (matplotlib and numpy, the same
code): colormaps built from iSEG tissue files or random HLS hues, and
per-case row-normalized confusion-matrix PNGs with tissue-name axes.
matplotlib is optional: without it the colormaps raise and
``plot_confusion_matrix`` writes nothing and warns. ``predict()`` imports
this module only when it saves confusion plots.
"""

from __future__ import annotations

import colorsys
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..image.labels import load_tissue_colors

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap

    _HAS_MPL = True
except ImportError:  # pragma: no cover
    _HAS_MPL = False

__all__ = ["make_tissue_cmap", "make_random_cmap", "plot_confusion_matrix"]


def make_tissue_cmap(tissue_list_file: Path):
    """Colormap with one entry per tissue from an iSEG tissue file."""
    if not _HAS_MPL:
        raise RuntimeError("matplotlib unavailable")
    colors = load_tissue_colors(tissue_list_file)
    return ListedColormap([colors[i] for i in sorted(colors)])


def make_random_cmap(num_classes: int, seed: int = 0):
    """Random HLS colormap (background black, deterministic given seed)."""
    if not _HAS_MPL:
        raise RuntimeError("matplotlib unavailable")
    rng = np.random.default_rng(seed)
    cols = [(0.0, 0.0, 0.0)]
    for _ in range(num_classes - 1):
        h, l, s = rng.uniform(0, 1), rng.uniform(0.35, 0.75), rng.uniform(0.6, 1.0)
        cols.append(colorsys.hls_to_rgb(h, l, s))
    return ListedColormap(cols)


def plot_confusion_matrix(
    cm: np.ndarray,
    target_names: Sequence[str],
    file_name: Path,
    title: str = "Confusion matrix",
    normalize: bool = True,
    cmap: Optional[str] = None,
) -> None:
    """Save an annotated confusion-matrix PNG (row-normalized by default)."""
    if not _HAS_MPL:
        warnings.warn(f"matplotlib unavailable: {file_name} not written")
        return
    cm = np.asarray(cm, np.float64)
    if normalize:
        row = cm.sum(axis=1, keepdims=True)
        cm = np.divide(cm, row, out=np.zeros_like(cm), where=row > 0)

    n = len(target_names)
    fig, ax = plt.subplots(figsize=(max(6, n * 0.6), max(5, n * 0.5)))
    im = ax.imshow(cm, interpolation="nearest", cmap=cmap or "Blues")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(target_names, rotation=45, ha="right", fontsize=8)
    ax.set_yticklabels(target_names, fontsize=8)
    ax.set_ylabel("True label")
    ax.set_xlabel("Predicted label")

    threshold = cm.max() * 0.6 if cm.size else 0.5
    fmt = "{:.2f}" if normalize else "{:.0f}"
    if n <= 30:
        for i in range(n):
            for j in range(n):
                ax.text(
                    j,
                    i,
                    fmt.format(cm[i, j]),
                    ha="center",
                    va="center",
                    fontsize=6,
                    color="white" if cm[i, j] > threshold else "black",
                )
    fig.tight_layout()
    Path(file_name).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(file_name, dpi=120)
    plt.close(fig)
