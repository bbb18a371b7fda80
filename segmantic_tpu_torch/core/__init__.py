from . import orientation
from .volume import Volume

__all__ = ["Volume", "orientation"]
