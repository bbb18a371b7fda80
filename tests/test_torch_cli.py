"""The port's ``segmantic-unet-torch`` evaluation subcommands against the JAX
CLI's: ``predict``, ``ensemble-predict`` and ``cross-validate`` take the JAX
options plus ``--device``, ``cross-validate --print-defaults`` gives the JAX
keys plus ``device``, and ``predict --device cpu`` on a datalist writes what
the function call writes.
"""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
from click.testing import CliRunner

from segmantic_tpu.commands.unet_cli import app as japp
from segmantic_tpu_torch.commands.unet_cli import app
from segmantic_tpu_torch.infer.predict import predict
from segmantic_tpu_torch.io.nifti import read_volume
from segmantic_tpu_torch.utils import config
from tests.test_torch_predict import jax_checkpoint, write_case


def _options(cli, command):
    res = CliRunner().invoke(cli, [command, "--help"])
    assert res.exit_code == 0, res.output
    return set(re.findall(r"(?<![\w-])(--?[a-z][\w-]*)", res.output.split("Options:")[1]))


@pytest.mark.parametrize("command", ["predict", "ensemble-predict", "cross-validate"])
def test_help_lists_the_jax_options_plus_device(command):
    got, want = _options(app, command), _options(japp, command)
    if command == "cross-validate":  # the device is a config key there
        assert got == want
    else:
        assert got == want | {"--device"}
        assert "cuda" in CliRunner().invoke(app, [command, "--help"]).output


@pytest.mark.parametrize("suffix", [".yml", ".json"])
def test_cross_validate_print_defaults_is_the_jax_schema_plus_device(tmp_path, suffix):
    for cli, name in ((app, "port"), (japp, "jax")):
        res = CliRunner().invoke(cli, ["cross-validate", "-c", str(tmp_path / f"{name}{suffix}"),
                                       "--print-defaults"])
        assert res.exit_code == 0, res.output
    got, want = config.load(tmp_path / f"port{suffix}"), config.load(tmp_path / f"jax{suffix}")
    assert list(got) == list(want) + ["device"] and got["device"] == "cuda"
    assert {k: got[k] for k in want} == want


def test_cross_validate_rejects_unknown_keys(tmp_path):
    config.dump({"bogus_key": 1}, tmp_path / "bad.yml")
    res = CliRunner().invoke(app, ["cross-validate", "-c", str(tmp_path / "bad.yml")])
    assert res.exit_code != 0 and isinstance(res.exception, ValueError)


def test_predict_command_writes_what_the_function_writes(tmp_path):
    ckpt = jax_checkpoint(tmp_path / "model.ckpt", seed=4)
    cases = [write_case(tmp_path, f"d{i}", (18, 16, 14), 40 + i) for i in range(2)]
    datalist = tmp_path / "datalist.json"
    datalist.write_text(json.dumps({
        "labels": {"0": "Background", "1": "A", "2": "B"},
        "test": [{"image": f"image/d{i}.nii.gz", "label": f"label/d{i}.nii.gz"}
                 for i in range(2)]}))
    res = CliRunner().invoke(app, ["predict", "-d", str(datalist), "-m", str(ckpt),
                                   "-r", str(tmp_path / "cli"), "--spacing", "1.2",
                                   "--spacing", "1.2", "--spacing", "1.2", "--device", "cpu"])
    assert res.exit_code == 0, res.output
    predict(ckpt, [c[0] for c in cases], [c[1] for c in cases], output_dir=tmp_path / "call",
            tissue_dict={"Background": 0, "A": 1, "B": 2}, spacing=[1.2, 1.2, 1.2],
            device="cpu")
    names = sorted(p.name for p in (tmp_path / "call").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "cli").iterdir()) == [
        "d0.nii.gz", "d0_confusion.png", "d1.nii.gz", "d1_confusion.png", "mean_dice.txt"]
    assert (tmp_path / "cli" / "mean_dice.txt").read_text() == \
        (tmp_path / "call" / "mean_dice.txt").read_text()
    for i in range(2):
        np.testing.assert_array_equal(read_volume(tmp_path / "cli" / f"d{i}.nii.gz").numpy(),
                                      read_volume(tmp_path / "call" / f"d{i}.nii.gz").numpy())
    assert "tissue" in res.output and "A " in res.output  # names from the datalist labels
