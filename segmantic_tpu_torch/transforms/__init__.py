from .base import Compose, MapTransform, RandMapTransform
from .registry import TRANSFORM_REGISTRY, build_transform, register_transform
from . import intensity, intensity_ops, post, spatial

__all__ = [
    "Compose",
    "MapTransform",
    "RandMapTransform",
    "TRANSFORM_REGISTRY",
    "build_transform",
    "register_transform",
    "intensity",
    "intensity_ops",
    "post",
    "spatial",
]
