"""Device selection from a ``gpu_ids`` list.

Port of ``segmantic_tpu/utils/device.py`` (the config surface's ``gpu_ids``
keys; reference: src/segmantic/seg/utils.py:4-12, where ``gpu_ids=[-1]`` is
the CPU). The JAX function falls back to the CPU when there is no
accelerator; this one never does: ``[-1]`` or ``[]`` is the explicit request
for the CPU, and any other id without a card raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops._cuda import resolve_device

__all__ = ["make_device"]


def make_device(gpu_ids: Sequence[int] = (0,)) -> torch.device:
    """Map a gpu_ids-style list to a ``torch.device``: ``[-1]`` or ``[]`` is
    the CPU, any other first id ``cuda:<min(id, count - 1)>``; raises without
    a card."""
    ids = list(gpu_ids)
    if not ids or ids[0] < 0:
        return torch.device("cpu")
    resolve_device("cuda")  # raises without a card
    return torch.device("cuda", min(int(ids[0]), torch.cuda.device_count() - 1))
