"""Config file (yaml/json) load/dump helpers.

Behavioral parity with the reference's config plumbing
(reference: src/segmantic/utils/config.py:9-32): format is chosen by file
suffix, ``dump`` without a file pretty-prints yaml to stdout.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Optional

import yaml


def _is_json(path: Path) -> bool:
    return Path(path).suffix.lower() == ".json"


def load(config_file: Path) -> Any:
    """Load a yaml or json config file (format by suffix)."""
    config_file = Path(config_file)
    return loads(config_file.read_text(), is_json=_is_json(config_file))


def loads(text: str, is_json: bool = False) -> Any:
    if is_json:
        return json.loads(text)
    return yaml.safe_load(text)


def dump(obj: Any, config_file: Optional[Path] = None) -> None:
    """Write config to yaml/json file; without a file, print yaml to stdout."""
    if config_file is None:
        yaml.safe_dump(obj, stream=sys.stdout, sort_keys=False)
        return
    config_file = Path(config_file)
    config_file.write_text(dumps(obj, is_json=_is_json(config_file)))


def dumps(obj: Any, is_json: bool = False) -> str:
    if is_json:
        return json.dumps(obj, indent=4)
    return yaml.safe_dump(obj, stream=None, sort_keys=False)
