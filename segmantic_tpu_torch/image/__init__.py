from . import labels, modality, processing, utils

__all__ = ["labels", "modality", "processing", "utils"]
