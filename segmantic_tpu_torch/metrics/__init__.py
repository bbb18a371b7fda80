from .distance import hausdorff_pointwise_distance, hausdorff_surface_distance
from .overlap import confusion_matrix, confusion_matrix_metrics, dice_metric

__all__ = [
    "confusion_matrix",
    "dice_metric",
    "confusion_matrix_metrics",
    "hausdorff_surface_distance",
    "hausdorff_pointwise_distance",
]
