from . import config, file_iterators, schema
from .json import PathEncoder

__all__ = ["config", "schema", "file_iterators", "PathEncoder"]
