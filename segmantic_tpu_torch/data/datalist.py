"""Decathlon/MSD datalist reader (MONAI ``load_decathlon_datalist``
equivalent).

Port of ``segmantic_tpu/data/datalist.py`` (numpy-free, the same code): loads
a section of an MSD-style json datalist, normalizing entries to dicts and
resolving relative paths against the json's directory. The ``predict`` and
``ensemble-predict`` subcommands read their cases with it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

__all__ = ["load_decathlon_datalist"]


def load_decathlon_datalist(
    datalist_path: Path,
    data_list_key: str = "test",
    base_dir: Optional[Path] = None,
) -> List[Dict[str, Path]]:
    datalist_path = Path(datalist_path)
    data = json.loads(datalist_path.read_text())
    if data_list_key not in data:
        raise KeyError(f"{datalist_path} has no section {data_list_key!r}")
    base = Path(base_dir) if base_dir else datalist_path.parent

    def resolve(p: Union[str, Path]) -> Path:
        p = Path(p)
        return p if p.is_absolute() else base / p

    out: List[Dict[str, Path]] = []
    for entry in data[data_list_key]:
        if isinstance(entry, (str, Path)):
            out.append({"image": resolve(entry)})
        else:
            out.append({k: resolve(v) for k, v in entry.items()})
    return out
