"""Serving path of the PyTorch port vs the JAX package, end to end on the CPU.

Checkpoints in the ``STPUCKP1`` format move both ways between the packages;
preprocessing is the same numpy code; one small non-RAS NIfTI segmented by
the port's ``InferenceSession(device="cpu")`` and by the JAX one lands on the
same grid and affine with labels agreeing on >= 99.9% of voxels (both
forwards in f32, so only summation order differs); the HTTP server answers;
the port serves with JAX blocked from import; CUDA is never silently
replaced by the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
import threading
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu.io.nifti import read_volume, write_volume
from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu.serve import InferenceSession as JaxSession
from segmantic_tpu.train import checkpoint as jax_ckpt
from segmantic_tpu.train.trainer import SegmentationModel as JaxModel
from segmantic_tpu.train.trainer import default_preprocessing as jax_pre
from segmantic_tpu.train.trainer import make_val_forward as jax_val_forward
from segmantic_tpu_torch.serve import InferenceSession, make_server
from segmantic_tpu_torch.train import checkpoint, msgpack as port_msgpack
from segmantic_tpu_torch.train.trainer import (
    SegmentationModel, default_preprocessing, make_val_forward,
)
from tests.test_torch_unet_slice import _flax_variables

REPO = Path(__file__).resolve().parent.parent
HPARAMS = dict(num_classes=3, num_channels=1, spatial_dims=3, spatial_size=[16, 16, 16],
               channels=[4, 8], strides=[2], dropout=0.0, act="PRELU",
               num_res_units=1, norm="BATCH", arch="unet", arch_params={})


def _flax_module():
    return FlaxUNet(spatial_dims=3, in_channels=1, out_channels=3, channels=(4, 8),
                    strides=(2,), num_res_units=1)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint written by the JAX package."""
    path = tmp_path_factory.mktemp("ckpt") / "model.ckpt"
    jax_ckpt.save_checkpoint(path, _flax_variables(_flax_module(), seed=11), HPARAMS,
                             metrics={"val_dice": 0.5})
    return path


def _nifti(path: Path, seed: int = 0) -> bytes:
    """A non-RAS (LPS) volume with a foreground box, so orientation and
    crop are both inverted."""
    rng = np.random.default_rng(seed)
    img = np.zeros((20, 18, 12), np.float32)
    img[2:19, 1:16, 1:11] = rng.standard_normal((17, 15, 10))
    aff = affine_from_spacing_origin((1.0, 1.2, 1.5), (5.0, -3.0, 2.0))
    aff[:2] *= -1  # LPS
    write_volume(path, Volume(data=img[None], affine=aff))
    return path.read_bytes()


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_msgpack_codec_matches_msgpack_package():
    obj = {"a": [0, 1, 127, 128, 255, 65535, 2**32, -1, -32, -33, -2**40],
           "b": 1.5, "c": None, "d": True, "e": False, "f": "x" * 40,
           "g": b"\x00" * 300, "h": {"nested": [[], {}]}, "i": "y" * 70000}
    assert port_msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert port_msgpack.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_checkpoint_jax_to_port(ckpt):
    want = jax_ckpt.load_checkpoint(ckpt)
    got = checkpoint.load_checkpoint(ckpt)
    assert got["hparams"] == want["hparams"] and got["metrics"] == want["metrics"]
    flat = dict(_flatten(got["variables"]))
    for key, leaf in _flatten(want["variables"]):
        assert flat[key].dtype == leaf.dtype
        np.testing.assert_array_equal(flat[key], leaf)


def test_checkpoint_port_to_jax(ckpt, tmp_path):
    model = SegmentationModel.load(ckpt, device="cpu")
    out = tmp_path / "port.ckpt"
    model.save(out, metrics={"val_dice": 0.25})
    back = jax_ckpt.load_checkpoint(out)
    assert back["hparams"] == HPARAMS and back["metrics"] == {"val_dice": 0.25}
    orig = dict(_flatten(jax_ckpt.load_checkpoint(ckpt)["variables"]))
    got = dict(_flatten(back["variables"]))
    assert got.keys() == orig.keys()
    for key in orig:
        np.testing.assert_array_equal(got[key], orig[key])
    assert set(back["variables"]) == {"params", "batch_stats"}


def test_default_preprocessing_matches_jax(tmp_path):
    path = tmp_path / "img.nii.gz"
    _nifti(path, seed=1)
    got = default_preprocessing(["image"])({"image": path})["image"]
    want = jax_pre(["image"])({"image": path})["image"]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.affine, want.affine)
    assert [op["op"] for op in got.applied_ops] == [op["op"] for op in want.applied_ops]


def _jax_session(ckpt_path, sw_batch_size):
    """The JAX package's session, built from the checkpoint's variables
    without flax's (slow, eager) init; its segment_bytes is the real one."""
    loaded = jax_ckpt.load_checkpoint(ckpt_path)
    module = _flax_module()
    session = JaxSession.__new__(JaxSession)
    session.model = JaxModel(module=module, variables=loaded["variables"],
                             hparams=loaded["hparams"])
    session.val_forward = jax_val_forward(module, jnp.float32)
    session.spacing, session.sw_batch_size, session.overlap = [], sw_batch_size, 0.25
    session._lock = threading.Lock()
    return session


def test_segment_bytes_matches_jax_session(ckpt, tmp_path):
    payload = _nifti(tmp_path / "in.nii.gz", seed=2)
    port = InferenceSession(ckpt, sw_batch_size=2, device="cpu")
    port.val_forward = make_val_forward(port.model.module, torch.float32)
    ref = _jax_session(ckpt, sw_batch_size=2)
    (tmp_path / "port.nii.gz").write_bytes(port.segment_bytes(payload))
    (tmp_path / "jax.nii.gz").write_bytes(ref.segment_bytes(payload))
    got, want = read_volume(tmp_path / "port.nii.gz"), read_volume(tmp_path / "jax.nii.gz")
    assert got.spatial_shape == want.spatial_shape == (20, 18, 12)
    np.testing.assert_allclose(got.affine, want.affine, atol=1e-6)
    np.testing.assert_allclose(got.affine, read_volume(tmp_path / "in.nii.gz").affine,
                               atol=1e-4)
    agree = float((got.numpy() == want.numpy()).mean())
    assert agree >= 0.999, agree
    assert set(np.unique(got.numpy())) <= {0, 1, 2}


def test_http_round_trip(ckpt, tmp_path):
    session = InferenceSession(ckpt, sw_batch_size=2, device="cpu")
    srv = make_server(session, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/v1/health", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(f"{base}/v1/info", timeout=60) as r:
            assert json.loads(r.read())["num_classes"] == 3
        req = urllib.request.Request(f"{base}/v1/segment",
                                     data=_nifti(tmp_path / "in.nii.gz", seed=3),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            (tmp_path / "out.nii.gz").write_bytes(r.read())
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    pred = read_volume(tmp_path / "out.nii.gz")
    assert pred.spatial_shape == (20, 18, 12)
    assert set(np.unique(pred.numpy())) <= {0, 1, 2}


def test_serves_with_jax_blocked(ckpt, tmp_path):
    """A process in which ``import jax`` (and flax, optax) fails still loads
    the checkpoint and answers one request."""
    payload = tmp_path / "in.nii.gz"
    _nifti(payload, seed=4)
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None  # import raises ImportError
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from segmantic_tpu_torch.serve import InferenceSession
        session = InferenceSession(Path({str(ckpt)!r}), sw_batch_size=2, device="cpu")
        out = session.segment_bytes(Path({str(payload)!r}).read_bytes())
        loaded = [m for m in ("jax", "flax", "optax") if sys.modules.get(m) is not None]
        print("OK", len(out), loaded)
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK") and res.stdout.strip().endswith("[]")


def test_cuda_without_cuda_raises(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceSession(ckpt, device="cuda")


def test_cli_serve_defaults_to_cuda():
    from click.testing import CliRunner

    from segmantic_tpu_torch.commands.unet_cli import app

    res = CliRunner().invoke(app, ["serve", "--help"])
    assert res.exit_code == 0
    assert "--device" in res.output and "cuda" in res.output


def test_unported_archs_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SegmentationModel.create(num_classes=2, arch="segresnet")
