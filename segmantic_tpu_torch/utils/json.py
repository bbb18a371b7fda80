"""JSON helpers (reference: src/segmantic/utils/json.py:6-10)."""

import json
import pathlib
from typing import Any


class PathEncoder(json.JSONEncoder):
    """JSON encoder that stringifies pathlib paths."""

    def default(self, obj: Any) -> Any:
        if isinstance(obj, pathlib.PurePath):
            return str(obj)
        return super().default(obj)
