"""K-fold cross-validation meta-trainer.

Port of ``segmantic_tpu/train/cross_validate.py`` with ``device``:
materialize fold datalists, then for each scenario config x fold rewrite the
config (datalist = fold json, fresh output dir) and run training in a
SUBPROCESS (``python -m segmantic_tpu_torch.commands.unet_cli train-config``)
for isolation, then run the port's ``predict`` on ``device`` in this process
with every produced checkpoint on the held-out test directory. Each scenario
config names its own training ``device`` (the port's ``train-config`` schema
has it; the card by default).

A fold trains on every card of the host, as the JAX fold subprocess takes
every local chip: where its scenario trains on the card (``device: cuda``,
the default) and :func:`fold_ranks` counts N > 1 cards, the subprocess is ``python -m
torch.distributed.run --standalone --nproc-per-node N -m
segmantic_tpu_torch.commands.unet_cli train-config -c <fold>/config.yml``
(``--standalone`` takes a free port, so folds in flight at once do not
collide); with one card, a named card (``device: cuda:k``) or ``device:
cpu`` it is the plain process above.

``max_parallel > 1`` keeps that many fold subprocesses in flight at once;
each gets ``SEGMANTIC_FOLD_SLOT=<0..max_parallel-1>`` so a launcher can pin
slots to disjoint devices (e.g. ``CUDA_VISIBLE_DEVICES`` per slot in a
wrapper); with the default of 1 the flow is sequential. On N > 1 cards each
fold in flight takes all N, so every card holds ``max_parallel`` ranks at
once; scenarios that name their cards (``device: cuda:k``) train one card
each instead. The JAX function
only prints whether each training succeeded; this one also returns, for
each fold run, its exit code and its training and evaluation seconds.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess as sp
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

from ..data.dataset import PairedDataSet
from ..image.labels import load_tissue_list
from ..ops._cuda import resolve_device
from ..utils import config

__all__ = ["FoldRun", "cross_validate", "fold_ranks"]


@dataclasses.dataclass
class FoldRun:
    """One scenario x fold: its output dir, the training subprocess's exit
    code, host-clock seconds from launch to exit and of the evaluation, and
    the command line that launched the training."""

    fold_dir: Path
    returncode: int
    train_seconds: float
    eval_seconds: float
    argv: List[str]


def fold_ranks(device: str) -> int:
    """The processes a fold trains on: every visible card for a scenario on
    the card, ``cuda`` (``torch.cuda.device_count()``, which honours
    ``CUDA_VISIBLE_DEVICES``); one for a named card (``cuda:k``) or the CPU."""
    import torch

    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" and device.index is None else 1


def cross_validate(
    image_dir: Path,
    labels_dir: Path,
    tissue_list: Path,
    output_dir: Path,
    config_files_dir: Path,
    test_image_dir: Optional[Path] = None,
    test_labels_dir: Optional[Path] = None,
    num_splits: int = 7,
    gpu_ids: Sequence[int] = (0,),
    max_parallel: int = 1,
    device: str = "cuda",
) -> List[FoldRun]:
    resolve_device(device)  # refuse a missing card before any fold is trained
    print("Cross-validating")
    output_dir = Path(output_dir)
    output_dir.mkdir(exist_ok=True, parents=True)

    tissue_dict = load_tissue_list(Path(tissue_list))
    print(tissue_dict)

    data_dicts = PairedDataSet.create_data_dict(
        image_dir=Path(image_dir), labels_dir=Path(labels_dir)
    )
    test_data_dicts = []
    if test_image_dir and test_labels_dir:
        test_data_dicts = PairedDataSet.create_data_dict(
            image_dir=Path(test_image_dir), labels_dir=Path(test_labels_dir)
        )

    fold_paths: List[Path] = PairedDataSet.kfold_crossval(
        num_splits=num_splits,
        data_dicts=data_dicts,
        output_dir=output_dir / "datafolds",
        test_data_dicts=test_data_dicts,
    )

    # materialize every scenario x fold job up front
    jobs: List[tuple] = []  # (fold output dir with config.yml inside, its device)
    for config_file in sorted(Path(config_files_dir).iterdir()):
        if config_file.suffix not in (".json", ".yml", ".yaml"):
            continue
        is_json = config_file.suffix.lower() == ".json"

        scenario_dir = output_dir / config_file.name.rsplit(".", 1)[0]
        scenario_dir.mkdir(exist_ok=True)

        for count, fold_path in enumerate(fold_paths):
            fold_out = scenario_dir / str(count)
            fold_out.mkdir(exist_ok=True)

            data = config.loads(config_file.read_text(), is_json=is_json)
            data["datalist"] = str(fold_path)
            data.pop("image_dir", None)
            data.pop("labels_dir", None)
            data["output_dir"] = str(fold_out)

            (fold_out / "config.yml").write_text(config.dumps(data, is_json=False))
            jobs.append((fold_out, data.get("device", "cuda")))

    def launch(fold_out: Path, fold_device: str, slot: int) -> tuple:
        """Start the fold's training: (the process, its command line)."""
        print(f"start training: {fold_out}")
        repo_root = str(Path(__file__).resolve().parent.parent.parent)
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        env["SEGMANTIC_FOLD_SLOT"] = str(slot)
        ranks = fold_ranks(fold_device)
        torchrun = (["torch.distributed.run", "--standalone", "--nproc-per-node",
                     str(ranks), "-m"] if ranks > 1 else [])
        argv = [
            sys.executable,
            "-m",
            *torchrun,
            "segmantic_tpu_torch.commands.unet_cli",
            "train-config",
            "-c",
            str(fold_out / "config.yml"),
        ]
        return sp.Popen(argv, cwd=os.fspath(fold_out), env=env), argv

    def evaluate(fold_out: Path) -> None:
        if not (test_image_dir and test_labels_dir):
            return
        test_images = sorted(Path(test_image_dir).glob("*.nii.gz"))
        test_labels = sorted(Path(test_labels_dir).glob("*.nii.gz"))
        if len(test_images) != len(test_labels):
            raise ValueError("test image/label count mismatch")
        from ..infer.predict import predict

        for ckpt in sorted(
            p for p in fold_out.glob("*.ckpt") if p.name != "last.ckpt"
        ):
            print(f"start prediction: {ckpt}")
            predict(
                model_file=ckpt,
                output_dir=fold_out,
                test_images=test_images,
                test_labels=test_labels,
                tissue_dict=tissue_dict,
                spacing=[1, 1, 1],
                gpu_ids=gpu_ids,
                device=device,
            )

    # bounded pool: up to max_parallel trainings in flight; evaluation runs
    # in this process as each fold's training drains (FIFO keeps the
    # max_parallel=1 flow sequential)
    width = max(1, int(max_parallel))
    queue = list(jobs)
    running: List[tuple] = []  # ((Popen, argv), fold_out, slot, launch time)
    free_slots = list(range(width))
    runs: List[FoldRun] = []
    while queue or running:
        while queue and free_slots:
            slot = free_slots.pop(0)
            fold_out, fold_device = queue.pop(0)
            running.append((launch(fold_out, fold_device, slot), fold_out, slot,
                            time.perf_counter()))
        (proc, argv), fold_out, slot, t0 = running.pop(0)
        rc = proc.wait()
        t1 = time.perf_counter()
        free_slots.append(slot)
        print(f"training finished : {rc == 0}")
        evaluate(fold_out)
        runs.append(FoldRun(fold_out, rc, t1 - t0, time.perf_counter() - t1, argv))
    return runs
