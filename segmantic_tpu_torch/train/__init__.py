from . import augment, checkpoint, losses, optim
from .trainer import SegmentationModel, TrainResult, train

__all__ = [
    "augment",
    "checkpoint",
    "losses",
    "optim",
    "SegmentationModel",
    "TrainResult",
    "train",
]
