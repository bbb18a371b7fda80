"""The launch the CLI's help names, on the CPU: ``torchrun --nproc-per-node 2
-m segmantic_tpu_torch.commands.unet_cli train-config -c cfg.json`` with
``"device": "cpu"`` (``python -m torch.distributed.run --standalone``). Each
rank's ``train()`` starts its gloo process group from torchrun's environment
(``parallel.initialize_distributed``), both ranks finish, and rank 0 alone
writes the run's files and prints its epochs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from tests.test_torch_parallel_ranks import REPO
from tests.test_torch_train import phantoms  # noqa: F401  (the module fixture)


def test_torchrun_train_config_on_two_cpu_ranks(phantoms, tmp_path):  # noqa: F811
    root, _, _ = phantoms
    out = tmp_path / "run"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "image_dir": str(root / "image"), "labels_dir": str(root / "label"),
        "output_dir": str(out), "num_classes": 4, "spatial_size": [16, 16, 16],
        "channels": [4, 8, 16], "strides": [2, 2], "mixed_precision": False,
        "val_roi_size": [16, 16, 16], "max_epochs": 2, "batch_size": 2,
        "num_samples": 2, "device": "cpu"}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "segmantic_tpu_torch.commands.unet_cli", "train-config", "-c", str(cfg)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("epoch 0: train_loss=") == 1  # rank 0 alone prints
    history = json.loads((out / "history.json").read_text())
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in history)
    assert (out / "last.ckpt").exists() and (out / "Dataset.json").exists()
