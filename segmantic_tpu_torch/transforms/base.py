"""Dict-sample transform pipeline core: ``MapTransform`` and ``Compose``.

Port of the deterministic half of ``segmantic_tpu/transforms/base.py``:
samples are dicts ``{"image": Volume, "label": Volume}``, a transform maps
selected keys, and ``Compose`` runs transforms in order. The random
transforms (``RandMapTransform``, fan-out) belong to training and are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Union

Sample = Dict[str, Any]


class MapTransform:
    """Deterministic dict-transform over selected keys."""

    def __init__(self, keys: Union[str, Sequence[str]]):
        self.keys: List[str] = [keys] if isinstance(keys, str) else list(keys)

    def __call__(self, sample: Sample) -> Sample:
        raise NotImplementedError

    def present_keys(self, sample: Sample) -> List[str]:
        return [k for k in self.keys if k in sample]


class Compose:
    """Sequential pipeline of deterministic transforms."""

    def __init__(self, transforms: Iterable[Any]):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, sample: Sample) -> Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample
