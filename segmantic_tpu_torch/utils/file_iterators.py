"""File discovery and stem-matching helpers.

Behavioral parity with the reference's file plumbing
(reference: src/segmantic/utils/file_iterators.py:9-119), reimplemented as
simple generator-backed iterables: multi-glob stem pairing
(:func:`find_matching_files`) plus three small directory iterators used by
the ops scripts.
"""

from __future__ import annotations

from os import PathLike
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple


def _split_glob(pattern: Path) -> Tuple[Path, str, str]:
    """Split an absolute glob pattern into (root, relative glob, suffix).

    The suffix is everything after the last ``*`` in the file name — the part
    stripped off to form the matching key (e.g. ``image_*.nii.gz`` →
    suffix ``.nii.gz``).
    """
    pattern = Path(pattern)
    root = Path(pattern.anchor)
    rel = str(pattern.relative_to(root))
    suffix = pattern.name.rsplit("*")[-1]
    return root, rel, suffix


def _glob_keyed(pattern: Path) -> Dict[str, Path]:
    """Glob an absolute pattern and key each hit by its suffix-stripped name."""
    root, rel, suffix = _split_glob(Path(pattern))
    return {p.name.replace(suffix, ""): p for p in root.glob(rel)}


def find_matching_files(
    input_globs: List[Path], verbose: bool = True
) -> List[List[Path]]:
    """Pair files across N glob patterns by shared stem.

    The key for each file is its name with the glob's trailing suffix removed.
    The first pattern defines the key universe; only keys matched by every
    pattern yield a tuple.
    """
    per_pattern = [_glob_keyed(p) for p in input_globs]
    anchor = per_pattern[0]

    if verbose:
        for hits in per_pattern[1:]:
            for key in sorted(set(hits) - set(anchor)):
                print(f"dropping {hits[key]}: key {key!r} has no anchor file")

    tuples = [
        [hits[key] for hits in per_pattern]
        for key in anchor
        if all(key in hits for hits in per_pattern)
    ]
    if verbose:
        print(
            f"{len(tuples)} complete tuple(s) from {len(anchor)} anchor file(s) "
            f"across {len(input_globs)} pattern(s)"
        )
    return tuples


class FileIterator:
    """Iterate over files in a directory matching ``glob``.

    Optionally skip files whose name contains ``skip_string``.
    """

    def __init__(
        self,
        directory: PathLike,
        glob: str = "*.nii.gz",
        skip_string: Optional[str] = None,
    ):
        self.directory = Path(directory)
        self.glob = glob
        self.skip_string = skip_string

    def __iter__(self) -> Iterator[Path]:
        for p in sorted(self.directory.glob(self.glob)):
            if not p.is_file():
                continue
            if self.skip_string is not None and self.skip_string in p.name:
                continue
            yield p


class UniqueFileIterator:
    """Iterate over files present in directory1 but absent from directory2."""

    def __init__(
        self,
        directory1: PathLike,
        directory2: PathLike,
        glob1: str = "*.nii.gz",
        glob2: str = "*.nii.gz",
    ):
        self.directory1 = Path(directory1)
        self.directory2 = Path(directory2)
        self.glob1 = glob1
        self.glob2 = glob2

    def __iter__(self) -> Iterator[Path]:
        names2 = {p.name for p in self.directory2.glob(self.glob2) if p.is_file()}
        for p in sorted(self.directory1.glob(self.glob1)):
            if p.is_file() and p.name not in names2:
                yield p


class MatchingFileIterator:
    """Iterate over (file1, file2) pairs where file2's name contains file1's stem."""

    def __init__(
        self,
        directory1: PathLike,
        directory2: PathLike,
        glob1: str = "*.nii.gz",
    ):
        self.directory1 = Path(directory1)
        self.directory2 = Path(directory2)
        self.glob1 = glob1
        self.suffix = glob1.rsplit("*")[-1]

    def __iter__(self) -> Iterator[Tuple[Path, Path]]:
        for file1 in sorted(self.directory1.glob(self.glob1)):
            if not file1.is_file():
                continue
            stem = file1.name.replace(self.suffix, "")
            for file2 in sorted(self.directory2.glob(f"*{stem}*{self.suffix}")):
                if file2.is_file():
                    yield file1, file2
                    break
