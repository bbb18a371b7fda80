"""``segmantic-i2i-torch`` (``segmantic_tpu_torch/commands/i2i_cli.py``) against
the JAX package's ``segmantic-i2i``, end to end through ``CliRunner``
(the twins of ``tests/test_i2i_pipeline.py``'s CLI tests).

Both CLIs train on the same stem-matched NIfTI pairs with ``--device cpu``
for the port; the port's networks start from the JAX init (flax's ``init``
with the CLI's seed, handed over through the trainers' seams). Held: the
same lines of output (dataset summary, every logged step within 1e-4
relative), the same checkpoint hparams (windows, slice axis), the generator
parameters within the tolerance of ``tests/test_torch_i2i_train.py``, and
``translate`` of one checkpoint by both CLIs within 1e-5 of the intensity
window, with the input's geometry. Also: the options and defaults of each
subcommand equal the JAX CLI's plus ``--device`` (default ``cuda``), which
refuses where CUDA is not available.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from segmantic_tpu.commands.i2i_cli import app as japp
from segmantic_tpu.core.volume import Volume, affine_from_spacing_origin
from segmantic_tpu.i2i import models as jm
from segmantic_tpu.io.nifti import read_volume, write_volume
from segmantic_tpu.train.checkpoint import load_checkpoint
from segmantic_tpu_torch.commands.i2i_cli import app as tapp
from segmantic_tpu_torch.i2i import models as tm
from segmantic_tpu_torch.i2i import train as ttrain

BASE, BLOCKS, STEPS, LR = 4, 1, 3, 2e-4
_LOSS = re.compile(r"(\w+)=(-?[0-9.]+)")


def _load(module, params):
    state = tm.from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, params)})
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return module


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jax_init(module, shape):
    """flax's init as the JAX trainers call it (key of seed 0; the values of
    the first batch do not enter a parameter)."""
    return module.init(jax.random.key(0), np.zeros(shape, np.float32))["params"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("i2i_cli")
    aff = affine_from_spacing_origin((1.0, 1.2, 2.0))
    for i in range(2):
        rng = np.random.default_rng(i)
        t1 = rng.uniform(0, 800, (12, 12, 4)).astype(np.float32)
        write_volume(root / f"case{i}_t1.nii.gz", Volume(t1[None], aff))
        write_volume(root / f"case{i}_t2.nii.gz", Volume((1000.0 - t1)[None], aff))
        write_volume(root / f"domA_{i}.nii.gz", Volume(t1[None], aff))
        write_volume(root / f"other{i}_B.nii.gz",
                     Volume(rng.uniform(0, 400, (12, 12, 4)).astype(np.float32)[None], aff))
    return root


def _logged(output: str):
    """The CLI's output with each logged loss parsed: (lines without numbers,
    [{name: value}])."""
    steps = [dict((k, float(v)) for k, v in _LOSS.findall(line))
             for line in output.splitlines() if " step " in line]
    return [line for line in output.splitlines() if " step " not in line
            and "checkpoint" not in line], steps


def _same_logs(want: str, got: str):
    (wl, ws), (gl, gs) = _logged(want), _logged(got)
    assert gl == wl and len(gs) == len(ws) == STEPS
    for w, g in zip(ws, gs):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-4), k


def _same_params(want_tree, got_tree):
    w, g = dict(_flat(want_tree)), dict(_flat(got_tree))
    assert set(g) == set(w)
    for path, arr in w.items():
        assert np.abs(g[path] - arr).max() <= 1e-5 * np.abs(arr).max() + STEPS * 2.5 * LR, path


def _train(monkeypatch, data, out, command, extra):
    args = [command, "-r", str(out), "--steps", str(STEPS), "--base-features", str(BASE),
            "--n-blocks", str(BLOCKS), "--log-every", "1", "--lr", str(LR)] + extra
    jres = CliRunner().invoke(japp, args)
    assert jres.exit_code == 0, jres.output
    gen = jm.ResnetGenerator(out_channels=1, base_features=BASE, n_blocks=BLOCKS)
    disc = jm.PatchDiscriminator(base_features=BASE)
    batch = 4 if command == "pix2pix" else 2

    def pix2pix(src0, dst0, base_features, n_blocks, seed, device):
        g = _load(tm.ResnetGenerator(1, 1, BASE, BLOCKS, 2), _jax_init(gen, src0.shape))
        d = _load(tm.PatchDiscriminator(2, BASE, spatial_dims=2),
                  _jax_init(disc, src0.shape[:-1] + (2,)))
        return g.to(device), d.to(device)

    def cyclegan(a0, b0, base_features, n_blocks, seed, device):
        nets = {k: _load(tm.ResnetGenerator(1, 1, BASE, BLOCKS, 2), _jax_init(gen, a0.shape))
                for k in ("gen_ab", "gen_ba")}
        nets.update({k: _load(tm.PatchDiscriminator(1, BASE, spatial_dims=2),
                              _jax_init(disc, a0.shape)) for k in ("disc_a", "disc_b")})
        return {k: v.to(device) for k, v in nets.items()}

    monkeypatch.setattr(ttrain, "_init_pix2pix", pix2pix)
    monkeypatch.setattr(ttrain, "_init_cyclegan", cyclegan)
    tres = CliRunner().invoke(tapp, [args[0], "-r", str(out.with_name(out.name + "_port"))]
                              + args[3:] + ["--batch-size", str(batch), "--device", "cpu"])
    assert tres.exit_code == 0, tres.output
    return jres.output, tres.output


def test_pix2pix_and_translate_end_to_end(data, tmp_path, monkeypatch):
    pairs = ["-s", str(data / "*_t1.nii.gz"), "-t", str(data / "*_t2.nii.gz")]
    jout, tout = _train(monkeypatch, data, tmp_path / "run", "pix2pix",
                        pairs + ["--batch-size", "4"])
    _same_logs(jout, tout)
    jckpt = tmp_path / "run" / "pix2pix_generator.ckpt"
    tckpt = tmp_path / "run_port" / "pix2pix_generator.ckpt"
    jc, tc = load_checkpoint(jckpt), load_checkpoint(tckpt)
    assert tc["hparams"] == jc["hparams"]
    assert tc["hparams"]["slice_axis"] == 2 and len(tc["hparams"]["target_window"]) == 2
    _same_params(jc["variables"]["params"], tc["variables"]["params"])

    src = data / "case0_t1.nii.gz"
    outs = {}
    for name, app, extra in (("jax", japp, []), ("port", tapp, ["--device", "cpu"])):
        res = CliRunner().invoke(app, ["translate", "-m", str(jckpt), "-i", str(src),
                                       "-r", str(tmp_path / f"tr_{name}")] + extra)
        assert res.exit_code == 0, res.output
        (out,) = list((tmp_path / f"tr_{name}").glob("*.nii.gz"))
        assert out.name == "case0_t1_translated.nii.gz"
        outs[name] = read_volume(out)
    lo, hi = tc["hparams"]["target_window"]
    vin = read_volume(src)
    assert outs["port"].spatial_shape == vin.spatial_shape == (12, 12, 4)
    np.testing.assert_array_equal(outs["port"].affine, outs["jax"].affine)
    got = outs["port"].numpy()
    assert lo - 1e-3 <= got.min() and got.max() <= hi + 1e-3
    assert np.abs(got - outs["jax"].numpy()).max() <= 1e-5 * (hi - lo)


def test_cyclegan_end_to_end(data, tmp_path, monkeypatch):
    domains = ["-s", str(data / "domA_*.nii.gz"), "-t", str(data / "other*_B.nii.gz")]
    jout, tout = _train(monkeypatch, data, tmp_path / "cg", "cyclegan",
                        domains + ["--batch-size", "2"])
    _same_logs(jout, tout)
    jc = load_checkpoint(tmp_path / "cg" / "cyclegan_generators.ckpt")
    tc = load_checkpoint(tmp_path / "cg_port" / "cyclegan_generators.ckpt")
    assert tc["hparams"] == jc["hparams"] and tc["hparams"]["model"] == "cyclegan"
    for which in ("gen_ab", "gen_ba"):
        _same_params(jc["variables"]["params"][which], tc["variables"]["params"][which])
    res = CliRunner().invoke(tapp, ["translate", "-m", str(tmp_path / "cg_port" /
                                                         "cyclegan_generators.ckpt"),
                                    "-i", str(data / "other0_B.nii.gz"), "--direction", "ba",
                                    "--raw-tanh", "-r", str(tmp_path / "tr"), "--device", "cpu"])
    assert res.exit_code == 0, res.output
    out = read_volume(tmp_path / "tr" / "other0_B_translated.nii.gz")
    assert out.spatial_shape == (12, 12, 4) and np.abs(out.numpy()).max() <= 1.0


@pytest.mark.parametrize("command", ["pix2pix", "cyclegan", "translate"])
def test_options_are_the_jax_ones_plus_device(command):
    def options(app):
        return {p.name: (p.default, p.required, p.multiple) for p in app.commands[command].params}

    want, got = options(japp), options(tapp)
    assert got.pop("device") == ("cuda", False, False)
    assert got == want


def test_device_defaults_to_the_card_and_refuses_without_one(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(tapp, ["pix2pix", "-s", str(data / "*_t1.nii.gz"),
                                    "-t", str(data / "*_t2.nii.gz"), "-r", str(tmp_path / "x"),
                                    "--steps", "1", "--base-features", "4", "--n-blocks", "1"])
    assert res.exit_code != 0
    assert "CUDA is not available" in str(res.exception)
    assert not (tmp_path / "x").exists()
