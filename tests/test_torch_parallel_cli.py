"""The launches the CLI's help names, on the CPU, with ``"device": "cpu"``:

- one node: ``torchrun --nproc-per-node 2 -m segmantic_tpu_torch.commands.
  unet_cli train-config -c cfg.json`` (``python -m torch.distributed.run
  --standalone``). Each rank's ``train()`` starts its gloo process group from
  torchrun's environment (``parallel.initialize_distributed``), both ranks
  finish, and rank 0 alone writes the run's files and prints its epochs;
- two nodes: two torchrun agents (``--nnodes 2 --node-rank {0,1}
  --nproc-per-node 1``) meeting at one c10d rendezvous on localhost, each
  running ``train-config`` on its own config (the same run but for
  ``output_dir``). Both finish two epochs, the first rank of each node writes
  its node's files, and both histories are finite and equal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from tests.test_torch_parallel_ranks import REPO, TORCHRUN_ENV
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
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
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


def test_torchrun_train_config_on_two_nodes(phantoms, tmp_path):  # noqa: F811
    import socket

    root, _, _ = phantoms
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    agents = []
    for node in range(2):
        cfg = tmp_path / f"cfg{node}.json"
        cfg.write_text(json.dumps({
            "image_dir": str(root / "image"), "labels_dir": str(root / "label"),
            "output_dir": str(tmp_path / f"node{node}"), "num_classes": 4,
            "spatial_size": [16, 16, 16], "channels": [4, 8, 16], "strides": [2, 2],
            "mixed_precision": False, "val_roi_size": [16, 16, 16], "max_epochs": 2,
            "batch_size": 2, "num_samples": 2, "device": "cpu"}))
        agents.append(subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node-rank",
             str(node), "--nproc-per-node", "1", "--rdzv-backend", "c10d",
             "--rdzv-endpoint", f"127.0.0.1:{port}", "-m",
             "segmantic_tpu_torch.commands.unet_cli", "train-config", "-c", str(cfg)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [a.communicate(timeout=300)[0] for a in agents]
    finally:
        for a in agents:
            a.kill()
    for a, out in zip(agents, outs):
        assert a.returncode == 0, out[-3000:]
        assert out.count("epoch 1: train_loss=") == 1  # the node's first rank prints
    histories = []
    for node in range(2):
        out = tmp_path / f"node{node}"
        assert (out / "last.ckpt").exists() and (out / "Dataset.json").exists()
        histories.append(json.loads((out / "history.json").read_text()))
    assert [h["epoch"] for h in histories[0]] == [0, 1]
    for a, b in zip(*histories):
        for key in ("train_loss", "val_loss", "val_dice", "lr"):
            assert np.isfinite(a[key]) and a[key] == b[key], key
