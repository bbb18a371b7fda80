from .transforms import (
    BoundingBoxd,
    EmbedVert,
    ExtractVertPosition,
    LoadVert,
    SaveVert,
    VertHeatMap,
)

__all__ = [
    "BoundingBoxd",
    "EmbedVert",
    "ExtractVertPosition",
    "LoadVert",
    "SaveVert",
    "VertHeatMap",
]
