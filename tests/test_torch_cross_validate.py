"""The port's ``cross_validate`` against the JAX package's, and once end to
end.

Both functions run with ``subprocess.Popen`` replaced by a recorder whose
``wait()`` returns 0 (the k-fold shuffle seeded the same way for both): the
``datafolds/*.json`` and every ``<scenario>/<fold>/config.yml`` are
byte-identical, the launched commands differ only in the package name, and
``SEGMANTIC_FOLD_SLOT`` is set the same way at ``max_parallel`` 1 and 2. Then
the port alone trains a tiny 3D model on the CPU in two fold subprocesses at
once and evaluates every checkpoint with its ``predict``.

A fold trains on every card: with ``fold_ranks`` set to count 4 cards, a
scenario on the card launches ``python -m torch.distributed.run --standalone
--nproc-per-node 4`` in front of the JAX launch's module and arguments; at
one card, and for a ``device: cpu`` scenario, the launch is the JAX one but
for the package. With the count set to 2 for the CPU, two folds train on two
gloo CPU ranks each through that torchrun launch and are evaluated.
"""

from __future__ import annotations

import json
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from segmantic_tpu.train import cross_validate as jcv
from segmantic_tpu_torch.image.labels import save_tissue_list
from segmantic_tpu_torch.train import cross_validate as pcv
from segmantic_tpu_torch.utils import config
from tests.test_torch_predict import write_case

REPO = Path(__file__).resolve().parent.parent


class _Recorder:
    """Stands in for ``subprocess.Popen``: records the launch, exits 0."""

    launched: list = []

    def __init__(self, args, cwd=None, env=None):
        _Recorder.launched.append(
            {"args": list(args), "cwd": cwd, "slot": env["SEGMANTIC_FOLD_SLOT"],
             "pythonpath": env["PYTHONPATH"].split(":")[0]})

    def wait(self):
        return 0


@pytest.fixture()
def dataset(tmp_path):
    for i in range(5):
        write_case(tmp_path / "data", f"case{i}", (16, 16, 16), i, spacing=(1.0, 1.0, 1.0))
    save_tissue_list({"A": 1, "B": 2}, tmp_path / "tissues.txt")
    cfg = tmp_path / "configs"
    cfg.mkdir()
    config.dump({"num_classes": 3, "max_epochs": 1, "spatial_size": [16, 16, 16]},
                cfg / "small.yml")
    config.dump({"num_classes": 3, "max_epochs": 2, "device": "cpu",
                 "image_dir": "dropped"}, cfg / "other.json")
    (cfg / "notes.txt").write_text("not a config")
    return tmp_path


def _run(fn, data: Path, out: Path, max_parallel: int, **kw):
    _Recorder.launched = []
    fn(image_dir=data / "data" / "image", labels_dir=data / "data" / "label",
       tissue_list=data / "tissues.txt", output_dir=out, config_files_dir=data / "configs",
       num_splits=2, max_parallel=max_parallel, **kw)
    files = {p.relative_to(out).as_posix(): p.read_bytes()
             for p in sorted(out.rglob("*")) if p.is_file()}
    return files, _Recorder.launched


@pytest.mark.parametrize("max_parallel", [1, 2])
def test_folds_configs_and_launches_match_jax(dataset, monkeypatch, max_parallel):
    monkeypatch.setattr(subprocess, "Popen", _Recorder)
    seeded = random.Random
    monkeypatch.setattr(random, "Random", lambda seed=None: seeded(7))
    out = dataset / "cv"
    want_files, want_runs = _run(jcv.cross_validate, dataset, out, max_parallel)
    shutil.rmtree(out)
    got_files, got_runs = _run(pcv.cross_validate, dataset, out, max_parallel, device="cpu")

    assert sorted(got_files) == sorted(want_files) == [
        "datafolds/fold_0.json", "datafolds/fold_1.json", "other/0/config.yml",
        "other/1/config.yml", "small/0/config.yml", "small/1/config.yml"]
    for name in want_files:
        assert got_files[name] == want_files[name], name
    fold = config.loads(got_files["other/1/config.yml"].decode())
    assert fold["datalist"] == str(out / "datafolds" / "fold_1.json")
    assert fold["output_dir"] == str(out / "other" / "1") and "image_dir" not in fold

    assert len(got_runs) == len(want_runs) == 4
    for g, w in zip(got_runs, want_runs):
        assert g["args"][2] == "segmantic_tpu_torch.commands.unet_cli"
        assert w["args"][2] == "segmantic_tpu.commands.unet_cli"
        assert g["args"][:2] + g["args"][3:] == w["args"][:2] + w["args"][3:]
        assert g["cwd"] == w["cwd"] and g["slot"] == w["slot"]
        assert g["pythonpath"] == w["pythonpath"] == str(REPO)
    assert [r["slot"] for r in got_runs] == (
        ["0", "0", "0", "0"] if max_parallel == 1 else ["0", "1", "0", "1"])


def test_cross_validate_returns_each_fold_run(dataset, monkeypatch):
    monkeypatch.setattr(subprocess, "Popen", _Recorder)
    _Recorder.launched = []
    runs = pcv.cross_validate(
        image_dir=dataset / "data" / "image", labels_dir=dataset / "data" / "label",
        tissue_list=dataset / "tissues.txt", output_dir=dataset / "cv",
        config_files_dir=dataset / "configs", num_splits=2, device="cpu")
    assert [(r.fold_dir.relative_to(dataset / "cv").as_posix(), r.returncode) for r in runs] \
        == [("other/0", 0), ("other/1", 0), ("small/0", 0), ("small/1", 0)]
    assert all(r.train_seconds >= 0 and r.eval_seconds >= 0 for r in runs)
    assert [r.argv for r in runs] == [a["args"] for a in _Recorder.launched]


def test_cross_validate_end_to_end_on_the_cpu(tmp_path):
    """Two folds of a tiny 3D UNet trained in two subprocesses at once
    (``device: cpu`` in the scenario config), then ``predict`` on the CPU with
    every checkpoint of each fold on the held-out test case."""
    data = tmp_path / "data"
    for i in range(4):
        write_case(data, f"case{i}", (16, 16, 16), 20 + i, spacing=(1.0, 1.0, 1.0))
    write_case(tmp_path / "test", "held_out", (18, 16, 16), 30, spacing=(1.0, 1.0, 1.0))
    save_tissue_list({"A": 1, "B": 2}, tmp_path / "tissues.txt")
    cfg = tmp_path / "configs"
    cfg.mkdir()
    config.dump({"num_classes": 3, "spatial_size": [16, 16, 16], "channels": [4, 8],
                 "strides": [2], "num_res_units": 1, "max_epochs": 1, "batch_size": 1,
                 "num_samples": 2, "mixed_precision": False, "val_roi_size": [16, 16, 16],
                 "device": "cpu"}, cfg / "tiny.yml")
    out = tmp_path / "cv"
    runs = pcv.cross_validate(
        image_dir=data / "image", labels_dir=data / "label", tissue_list=tmp_path / "tissues.txt",
        output_dir=out, config_files_dir=cfg, test_image_dir=tmp_path / "test" / "image",
        test_labels_dir=tmp_path / "test" / "label", num_splits=2, max_parallel=2,
        device="cpu")
    assert [r.returncode for r in runs] == [0, 0]
    for fold in range(2):
        fold_out = out / "tiny" / str(fold)
        ckpts = [p for p in fold_out.glob("*.ckpt") if p.name != "last.ckpt"]
        assert ckpts and (fold_out / "last.ckpt").exists(), f"fold {fold}"
        assert (fold_out / "history.json").exists()
        # predict wrote the held-out case's labels and its mean Dice
        pred = fold_out / "held_out.nii.gz"
        assert pred.exists() and (fold_out / "mean_dice.txt").exists()
        lines = (fold_out / "mean_dice.txt").read_text().splitlines()
        assert len(lines) == 2 and lines[-1].startswith("mean\t")
        assert np.isfinite(float(lines[0]))


@pytest.mark.parametrize("cards", [1, 4])
def test_a_fold_on_the_card_launches_torchrun_on_every_card(dataset, monkeypatch, cards):
    """``small.yml`` trains on the card (the schema's default device),
    ``other.json`` on the CPU; the card count is set, not read."""
    monkeypatch.setattr(subprocess, "Popen", _Recorder)
    seeded = random.Random
    monkeypatch.setattr(random, "Random", lambda seed=None: seeded(7))
    monkeypatch.setattr(pcv, "fold_ranks", lambda device: cards if device == "cuda" else 1)
    out = dataset / "cv"
    _, want_runs = _run(jcv.cross_validate, dataset, out, 2)
    shutil.rmtree(out)
    _, got_runs = _run(pcv.cross_validate, dataset, out, 2, device="cpu")
    assert len(got_runs) == len(want_runs) == 4
    for g, w in zip(got_runs, want_runs):
        on_card = Path(g["cwd"]).parent.name == "small"
        head = w["args"][:2]
        if on_card and cards > 1:
            head = head + ["torch.distributed.run", "--standalone", "--nproc-per-node",
                           str(cards), "-m"]
        assert g["args"] == head + ["segmantic_tpu_torch.commands.unet_cli"] + w["args"][3:]
        assert g["cwd"] == w["cwd"] and g["slot"] == w["slot"]


def test_fold_ranks_counts_visible_cards_on_the_card_and_one_on_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert pcv.fold_ranks("cuda") == 3
    # a named card trains alone: its ranks would all land on that card
    assert pcv.fold_ranks("cuda:0") == pcv.fold_ranks("cuda:1") == 1
    assert pcv.fold_ranks("cpu") == 1


def test_a_fold_on_two_cpu_ranks_trains_and_is_evaluated(tmp_path, monkeypatch):
    """The count set to 2 for a ``device: cpu`` scenario: each fold's
    ``train-config`` runs under torchrun on two gloo CPU ranks (both folds at
    once, each torchrun on its own free port), then ``predict`` in this
    process evaluates every checkpoint."""
    monkeypatch.setattr(pcv, "fold_ranks", lambda device: 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    launched, real = [], subprocess.Popen

    def popen(args, **kw):
        launched.append(list(args))
        return real(args, **kw)

    monkeypatch.setattr(subprocess, "Popen", popen)
    data = tmp_path / "data"
    for i in range(4):
        write_case(data, f"case{i}", (16, 16, 16), 20 + i, spacing=(1.0, 1.0, 1.0))
    write_case(tmp_path / "test", "held_out", (18, 16, 16), 30, spacing=(1.0, 1.0, 1.0))
    save_tissue_list({"A": 1, "B": 2}, tmp_path / "tissues.txt")
    cfg = tmp_path / "configs"
    cfg.mkdir()
    config.dump({"num_classes": 3, "spatial_size": [16, 16, 16], "channels": [4, 8],
                 "strides": [2], "num_res_units": 1, "max_epochs": 1, "batch_size": 2,
                 "num_samples": 2, "mixed_precision": False, "val_roi_size": [16, 16, 16],
                 "device": "cpu"}, cfg / "tiny.yml")
    out = tmp_path / "cv"
    runs = pcv.cross_validate(
        image_dir=data / "image", labels_dir=data / "label", tissue_list=tmp_path / "tissues.txt",
        output_dir=out, config_files_dir=cfg, test_image_dir=tmp_path / "test" / "image",
        test_labels_dir=tmp_path / "test" / "label", num_splits=2, max_parallel=2,
        device="cpu")
    assert [r.returncode for r in runs] == [0, 0]
    assert [a[2:7] for a in launched] == [
        ["torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m"]] * 2
    for fold in range(2):
        fold_out = out / "tiny" / str(fold)
        assert [p for p in fold_out.glob("*.ckpt") if p.name != "last.ckpt"], f"fold {fold}"
        assert len(json.loads((fold_out / "history.json").read_text())) == 1
        assert (fold_out / "held_out.nii.gz").exists()
        lines = (fold_out / "mean_dice.txt").read_text().splitlines()
        assert len(lines) == 2 and np.isfinite(float(lines[0]))
