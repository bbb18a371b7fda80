"""Dict-sample transform pipeline core: ``MapTransform``, ``RandMapTransform``
and ``Compose``.

Port of ``segmantic_tpu/transforms/base.py`` (numpy and stdlib only, so the
same code): samples are dicts ``{"image": Volume, "label": Volume}``, a
transform maps selected keys, and randomness is explicit: every random
transform draws from the ``numpy.random.Generator`` that :class:`Compose`
threads through, so a pipeline replays bit for bit from a seed.
``Compose.split_deterministic()`` splits at the first random transform into
the prefix that is run once per volume and cached and the suffix that runs
per step; a transform that returns a list fans one sample out to several
(one volume to N patches).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

Sample = Dict[str, Any]


class MapTransform:
    """Deterministic dict-transform over selected keys."""

    def __init__(self, keys: Union[str, Sequence[str]]):
        self.keys: List[str] = [keys] if isinstance(keys, str) else list(keys)

    def __call__(self, sample: Sample) -> Union[Sample, List[Sample]]:
        raise NotImplementedError

    def present_keys(self, sample: Sample) -> List[str]:
        return [k for k in self.keys if k in sample]


class RandMapTransform(MapTransform):
    """Random dict-transform; called with an explicit RNG."""

    is_random = True

    def __init__(self, keys: Union[str, Sequence[str]], prob: float = 1.0):
        super().__init__(keys)
        self.prob = float(prob)

    def __call__(  # type: ignore[override]
        self, sample: Sample, rng: np.random.Generator
    ) -> Union[Sample, List[Sample]]:
        raise NotImplementedError

    def should_apply(self, rng: np.random.Generator) -> bool:
        return bool(rng.random() < self.prob)


def _is_random(t: Any) -> bool:
    return getattr(t, "is_random", False)


class Compose:
    """Sequential pipeline; transforms returning a list fan out (one volume →
    N patches, like MONAI's RandCropByLabelClasses)."""

    def __init__(self, transforms: Iterable[Any], rng: Optional[np.random.Generator] = None):
        self.transforms = [t for t in transforms if t is not None]
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def __call__(
        self, sample: Sample, rng: Optional[np.random.Generator] = None
    ) -> Union[Sample, List[Sample]]:
        rng = rng if rng is not None else self.rng
        items: List[Sample] = [sample]
        fanned_out = False
        for t in self.transforms:
            next_items: List[Sample] = []
            for item in items:
                out = t(item, rng) if _is_random(t) else t(item)
                if isinstance(out, list):
                    next_items.extend(out)
                    fanned_out = True
                else:
                    next_items.append(out)
            items = next_items
        return items if fanned_out else items[0]

    def split_deterministic(self) -> "tuple[Compose, Compose]":
        """Split at the first random transform → (cacheable prefix, random suffix)."""
        idx = len(self.transforms)
        for i, t in enumerate(self.transforms):
            if _is_random(t):
                idx = i
                break
        return (
            Compose(self.transforms[:idx], rng=self.rng),
            Compose(self.transforms[idx:], rng=self.rng),
        )

    def flatten(self) -> "Compose":
        flat: List[Any] = []
        for t in self.transforms:
            if isinstance(t, Compose):
                flat.extend(t.flatten().transforms)
            else:
                flat.append(t)
        return Compose(flat, rng=self.rng)
