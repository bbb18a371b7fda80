"""Image/label pair datasets: glob pairing, MSD/nnUNet datalists, k-fold.

Pure path/json logic — behavioral parity with the reference's data layer
(reference: src/segmantic/seg/dataset.py:14-222): directory-glob stem
pairing, shuffled train/val split, MSD-style multi-file datalist json with
glob support, k-fold materialization. The k-fold split reproduces sklearn
``KFold`` fold sizing (first ``n % k`` folds get one extra sample) without
the sklearn dependency.

Split semantics (load-bearing for seeded reproducibility, so they are pinned
by tests rather than borrowed): shuffle with ``random.Random(seed)``, cap at
``max_files`` when positive, validation takes ``int(valid_split * n)`` cases
from the front of the shuffled list with a floor of one case whenever there
is more than one file and the split fraction is nonzero.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..utils.file_iterators import find_matching_files
from ..utils.json import PathEncoder

DataDict = Dict[str, Path]

_TRAIN, _VAL, _TEST = "training", "validation", "test"


def _expand_datalist_entry(entry: Dict[str, str], base_dir: Path) -> List[DataDict]:
    """Turn one datalist entry into concrete image/label pairs.

    An entry whose image path is absolute is used as-is; otherwise both
    fields are treated as glob expressions relative to ``base_dir`` and the
    sorted match lists are zipped together.
    """
    if Path(entry["image"]).is_absolute():
        images: List[Path] = [Path(entry["image"])]
        labels: List[Path] = [Path(entry["label"])]
    else:
        images = sorted(base_dir.glob(entry["image"]))
        labels = sorted(base_dir.glob(entry["label"]))
    if len(images) != len(labels):
        raise ValueError(
            f"datalist entry {entry} expands to {len(images)} images but "
            f"{len(labels)} labels"
        )
    return [{"image": i, "label": l} for i, l in zip(images, labels)]


def create_data_dict(
    list_to_convert: List[Dict[str, str]],
    data_dir: Path,
    data_dicts: List[DataDict],
) -> List[DataDict]:
    """Expand every glob entry of a datalist section into ``data_dicts``."""
    for entry in list_to_convert:
        data_dicts.extend(_expand_datalist_entry(entry, data_dir))
    return data_dicts


def kfold_split(n: int, num_splits: int) -> List[tuple]:
    """(train_idx, val_idx) pairs; sklearn KFold fold sizing, no shuffle."""
    base, extra = divmod(n, num_splits)
    bounds = [0]
    for i in range(num_splits):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    out = []
    for i in range(num_splits):
        val = list(range(bounds[i], bounds[i + 1]))
        train = list(range(0, bounds[i])) + list(range(bounds[i + 1], n))
        out.append((train, val))
    return out


def _pair_stems(image: Path, label: Path) -> Tuple[str, str]:
    """Lower-cased stems with any ``.nii`` remnant stripped, for pair checks."""
    return (
        image.stem.replace(".nii", "").lower(),
        label.stem.replace(".nii", "").lower(),
    )


class PairedDataSet:
    """Paired image/label dataset with train/val/test splits.

    Splits are kept in a single ``{"training": [...], "validation": [...],
    "test": [...]}`` mapping; the accessor methods mirror the reference API.
    """

    def __init__(
        self,
        image_dir: Optional[Path] = None,
        image_glob: str = "*.nii.gz",
        labels_dir: Optional[Path] = None,
        labels_glob: str = "*.nii.gz",
        *,
        valid_split: float = 0.2,
        shuffle: bool = True,
        random_seed: Optional[int] = None,
        max_files: int = 0,
    ):
        self._splits: Dict[str, List[DataDict]] = {_TRAIN: [], _VAL: [], _TEST: []}
        cases = self.create_data_dict(image_dir, image_glob, labels_dir, labels_glob)
        self._assign_splits(
            cases,
            valid_split=valid_split,
            shuffle=shuffle,
            random_seed=random_seed,
            max_files=max_files,
        )

    # -- accessors ----------------------------------------------------------
    def training_files(self) -> Sequence[DataDict]:
        return self._splits[_TRAIN]

    def validation_files(self) -> Sequence[DataDict]:
        return self._splits[_VAL]

    def test_files(self) -> Sequence[DataDict]:
        return self._splits[_TEST]

    # -- construction -------------------------------------------------------
    @classmethod
    def from_files(
        cls,
        training: Sequence[DataDict],
        validation: Sequence[DataDict] = (),
        test: Sequence[DataDict] = (),
    ) -> "PairedDataSet":
        """Build a dataset directly from explicit split lists."""
        ds = cls()
        ds._splits = {
            _TRAIN: list(training),
            _VAL: list(validation),
            _TEST: list(test),
        }
        return ds

    def _assign_splits(
        self,
        cases: List[DataDict],
        *,
        valid_split: float,
        shuffle: bool,
        random_seed: Optional[int] = None,
        max_files: int = 0,
    ) -> None:
        if shuffle:
            random.Random(random_seed).shuffle(cases)
        n = len(cases) if max_files <= 0 else min(len(cases), max_files)
        n_val = int(valid_split * n)
        if n_val == 0 and n > 1 and valid_split > 0:
            n_val = 1  # tiny datasets still get one validation case
        self._splits[_VAL] = cases[:n_val]
        self._splits[_TRAIN] = cases[n_val:n]

    def check_matching_filenames(self) -> None:
        """Require image/label stems to contain one another (pairing sanity)."""
        for case in list(self.training_files()) + list(self.validation_files()):
            img_stem, lbl_stem = _pair_stems(case["image"], case["label"])
            if img_stem not in lbl_stem and lbl_stem not in img_stem:
                raise RuntimeError(
                    f"image {case['image']} and label {case['label']} do not "
                    f"look like a matching pair (stems {img_stem!r} / {lbl_stem!r})"
                )

    def dump_dataset(self) -> str:
        """Serialize splits as an MSD-style datalist json string."""
        payload = {
            _TRAIN: self._splits[_TRAIN],
            _VAL: self._splits[_VAL],
            _TEST: [case["image"] for case in self._splits[_TEST]],
        }
        return json.dumps(payload, cls=PathEncoder)

    @staticmethod
    def create_data_dict(
        image_dir: Optional[Path] = None,
        image_glob: str = "*.nii.gz",
        labels_dir: Optional[Path] = None,
        labels_glob: str = "*.nii.gz",
    ) -> List[DataDict]:
        """Pair files from two directories by shared stem."""
        if image_dir is None or labels_dir is None:
            return []
        image_dir, labels_dir = Path(image_dir), Path(labels_dir)
        for d in (image_dir, labels_dir):
            if not d.is_dir():
                raise NotADirectoryError(f"{d} is not a directory")
        if Path(image_glob).is_absolute():
            image_glob = str(Path(image_glob).relative_to(image_dir))
        if Path(labels_glob).is_absolute():
            labels_glob = str(Path(labels_glob).relative_to(labels_dir))
        matches = find_matching_files(
            [image_dir / image_glob, labels_dir / labels_glob], verbose=False
        )
        return [{"image": img, "label": lbl} for img, lbl in matches]

    @staticmethod
    def kfold_crossval(
        num_splits: int,
        data_dicts: List[DataDict],
        output_dir: Path,
        test_data_dicts: Optional[List[DataDict]] = None,
        shuffle: bool = True,
        random_seed: Optional[int] = None,
    ) -> List[Path]:
        """Materialize k folds as ``fold_<k>.json`` datalists in output_dir."""
        if shuffle:
            random.Random(random_seed).shuffle(data_dicts)
        output_dir = Path(output_dir)
        output_dir.mkdir(exist_ok=True, parents=True)

        paths: List[Path] = []
        for k, (train_idx, val_idx) in enumerate(
            kfold_split(len(data_dicts), num_splits)
        ):
            fold = PairedDataSet.from_files(
                training=[data_dicts[i] for i in train_idx],
                validation=[data_dicts[i] for i in val_idx],
                test=test_data_dicts or (),
            )
            path = output_dir / f"fold_{k}.json"
            path.write_text(fold.dump_dataset())
            paths.append(path)
        return paths

    @staticmethod
    def load_from_json(
        datalist_paths: Union[Path, str, List[Path]],
    ) -> "PairedDataSet":
        """Load (and combine) MSD/nnUNet-style datalist json files.

        'training'/'validation' entries may be concrete paths or glob
        expressions relative to the json's directory; 'test' is a plain list
        of image paths.
        """
        if isinstance(datalist_paths, (Path, str)):
            datalist_paths = [datalist_paths]

        splits: Dict[str, List[DataDict]] = {_TRAIN: [], _VAL: [], _TEST: []}
        for json_path in (Path(p) for p in datalist_paths):
            base = json_path.parent
            doc = json.loads(json_path.read_text())
            for section in (_TRAIN, _VAL):
                for entry in doc[section]:
                    splits[section].extend(_expand_datalist_entry(entry, base))
            for item in doc.get(_TEST, []):
                # entries may be plain image paths or {"image": ..., "label": ...}
                fields = {"image": item} if isinstance(item, (str, Path)) else dict(item)
                splits[_TEST].append(
                    {
                        k: (Path(v) if Path(v).is_absolute() else base / v)
                        for k, v in fields.items()
                    }
                )

        return PairedDataSet.from_files(
            training=splits[_TRAIN], validation=splits[_VAL], test=splits[_TEST]
        )
