from .plots import make_random_cmap, make_tissue_cmap, plot_confusion_matrix

__all__ = ["make_random_cmap", "make_tissue_cmap", "plot_confusion_matrix"]
