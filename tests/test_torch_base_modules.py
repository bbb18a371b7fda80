"""The port's own host-side base modules against the JAX package's.

``segmantic_tpu_torch`` imports nothing of ``segmantic_tpu``: it keeps its own
copies of the numpy-only modules it needs (``core/volume``,
``core/orientation``, ``io/nifti``, ``utils/*``, ``data/dataset``,
``data/datalist``, ``image/labels``, the ``native`` resampler binding,
``image/processing.py``, ``transforms/base.py``,
``transforms/registry.py``, ``viz/plots``, and since the rest of the package was
ported ``image/{modality,utils,make_mixed_modal_dataset}.py``,
``data/iseg.py``, ``metrics/distance.py``, ``utils/flops.py``, the host
transforms of ``detect/transforms.py`` and the native bindings). Here each copy gets the same inputs as its
original and must give the same results (exactly: the same numpy code), the
newer copies' functions and classes have the originals' code (their syntax
trees equal, docstrings aside; results are compared in
``test_torch_image_prep.py``, ``test_torch_distance.py``,
``test_torch_detect.py``, ``test_torch_flops.py``, ``test_torch_sampler.py``),
NIfTI files written by one package are read by the other, and every module of
the port imports in a process where ``segmantic_tpu`` and ``jax`` are blocked.
"""

from __future__ import annotations

import json
import os
import pkgutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import segmantic_tpu_torch
from segmantic_tpu import native as jnative
from segmantic_tpu.core import orientation as jorient
from segmantic_tpu.core import volume as jvolume
from segmantic_tpu.data import datalist as jdatalist
from segmantic_tpu.data import dataset as jdataset
from segmantic_tpu.image import labels as jlabels
from segmantic_tpu.image import processing as jprocessing
from segmantic_tpu.io import nifti as jnifti
from segmantic_tpu.transforms import base as jbase
from segmantic_tpu.transforms import registry as jregistry
from segmantic_tpu.utils import config as jconfig
from segmantic_tpu.utils import file_iterators as jfiles
from segmantic_tpu.utils import schema as jschema
from segmantic_tpu.utils.json import PathEncoder as JPathEncoder
from segmantic_tpu.viz import plots as jplots
from segmantic_tpu_torch import native
from segmantic_tpu_torch.core import orientation as orient
from segmantic_tpu_torch.core import volume
from segmantic_tpu_torch.data import datalist, dataset
from segmantic_tpu_torch.image import labels, processing
from segmantic_tpu_torch.io import nifti
from segmantic_tpu_torch.ops.resample import resample_affine_np
from segmantic_tpu_torch.transforms import base, registry
from segmantic_tpu_torch.transforms.spatial import Spacingd
from segmantic_tpu_torch.utils import config, file_iterators, schema
from segmantic_tpu_torch.utils.json import PathEncoder
from segmantic_tpu_torch.viz import plots
from tests.test_torch_native_sync import one_native_library

REPO = Path(__file__).resolve().parent.parent


def _oblique_affine(rng):
    """Spacing, a flip, an axis swap and a small rotation: not axis aligned."""
    aff = volume.affine_from_spacing_origin((0.8, 1.1, 1.5), (10.0, -20.0, 5.0))
    t = 0.1
    rot = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1.0]])
    aff[:3, :3] = rot @ aff[:3, :3][:, [1, 0, 2]] * np.array([-1.0, 1.0, 1.0])
    return aff


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
def test_nifti_round_trip_each_way(tmp_path, dtype, suffix):
    """A file written by either package is read by both to the same voxels
    and affine; both packages write the same bytes."""
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((1, 7, 9, 11)) * 50).astype(dtype)
    aff = _oblique_affine(rng)
    by_port, by_jax = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    nifti.write_volume(by_port, volume.Volume(data=data, affine=aff))
    jnifti.write_volume(by_jax, jvolume.Volume(data=data, affine=aff.copy()))
    for path in (by_port, by_jax):
        got, want = nifti.read_volume(path), jnifti.read_volume(path)
        assert got.data.dtype == want.data.dtype == dtype
        np.testing.assert_array_equal(got.data, data)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)
        np.testing.assert_allclose(got.affine, aff, atol=1e-5)
    if suffix == ".nii":  # the JAX package may gzip with its native codec
        assert by_port.read_bytes() == by_jax.read_bytes()
    arr, aff2 = nifti.read_nifti(by_jax)
    jarr, jaff2 = jnifti.read_nifti(by_jax)
    np.testing.assert_array_equal(arr, jarr)
    np.testing.assert_array_equal(aff2, jaff2)


def test_volume_matches():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    aff = _oblique_affine(rng)
    got, want = volume.Volume(data=data, affine=aff), jvolume.Volume(data=data, affine=aff)
    for name in ("spatial_shape", "spacing", "origin", "ndim", "num_channels"):
        if hasattr(want, name):
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(
        volume.affine_from_spacing_origin((1.0, 2.0, 3.0), (4.0, 5.0, 6.0)),
        jvolume.affine_from_spacing_origin((1.0, 2.0, 3.0), (4.0, 5.0, 6.0)))
    assert sorted(n for n in dir(volume.Volume) if not n.startswith("_")) == sorted(
        n for n in dir(jvolume.Volume) if not n.startswith("_"))


@pytest.mark.parametrize("target", ["RAS", "LPS", "PIR", "SAL"])
def test_orientation_ops_match(target):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((1, 5, 6, 7)).astype(np.float32)
    aff = _oblique_affine(rng)
    assert orient.axcodes(aff) == jorient.axcodes(aff)
    np.testing.assert_array_equal(orient.io_orientation(aff), jorient.io_orientation(aff))
    assert orient.parse_axcodes(target) == jorient.parse_axcodes(target)
    got_d, got_a, perm, flips = orient.reorient_to_axcodes(data, aff, target)
    want_d, want_a, jperm, jflips = jorient.reorient_to_axcodes(data, aff, target)
    assert (perm, flips) == (jperm, jflips) == orient.orientation_ops(aff, 3, target)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_a, want_a)
    assert orient.axcodes(got_a) == tuple(target)
    back, back_aff = orient.invert_orientation(got_d, perm, flips, aff)
    jback, jback_aff = jorient.invert_orientation(want_d, jperm, jflips, aff)
    np.testing.assert_array_equal(back, jback)
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(back_aff, jback_aff)
    again, _ = orient.inverse_orientation_op(got_d, got_a, aff, target)
    jagain, _ = jorient.inverse_orientation_op(want_d, want_a, aff, target)
    np.testing.assert_array_equal(again, jagain)
    np.testing.assert_array_equal(again, data)


@pytest.fixture()
def paired_files(tmp_path):
    for sub, stems in (("image", ["a", "b", "c", "d", "e", "f", "orphan"]),
                       ("label", ["a", "b", "c", "d", "e", "f"])):
        (tmp_path / sub).mkdir()
        for stem in stems:
            (tmp_path / sub / f"{stem}.nii.gz").write_bytes(b"x")
    return tmp_path


def test_paired_dataset_pairs_and_splits_like_the_original(paired_files):
    kw = dict(image_dir=paired_files / "image", labels_dir=paired_files / "label",
              valid_split=0.34, random_seed=5)
    got, want = dataset.PairedDataSet(**kw), jdataset.PairedDataSet(**kw)
    for split in ("training_files", "validation_files", "test_files"):
        assert list(getattr(got, split)()) == list(getattr(want, split)()), split
    assert len(got.training_files()) + len(got.validation_files()) == 6  # orphan dropped
    for case in got.training_files():
        assert Path(case["image"]).name == Path(case["label"]).name
    assert json.loads(got.dump_dataset()) == json.loads(want.dump_dataset())
    assert dataset.kfold_split(7, 3) == jdataset.kfold_split(7, 3)
    # a datalist written by one package is loaded by the other
    doc = paired_files / "datalist.json"
    doc.write_text(want.dump_dataset())
    loaded = dataset.PairedDataSet.load_from_json(doc)
    assert list(loaded.training_files()) == list(
        jdataset.PairedDataSet.load_from_json(doc).training_files())


def test_utils_match(paired_files, tmp_path):
    globs = [paired_files / "image" / "*.nii.gz", paired_files / "label" / "*.nii.gz"]
    assert file_iterators.find_matching_files(globs, verbose=False) == \
        jfiles.find_matching_files(globs, verbose=False)

    def fn(a: int, out: Path = Path("x"), files: Path = None, n: int = 3):
        pass

    assert schema.default_args_from_signature(fn) == jschema.default_args_from_signature(fn)
    args = {"a": 1, "out": "y", "files": ["p", "q"]}
    assert schema.validate_against_signature(args, fn) == \
        jschema.validate_against_signature(args, fn) == \
        {"a": 1, "out": Path("y"), "files": [Path("p"), Path("q")]}
    with pytest.raises(ValueError, match="Unexpected argument"):
        schema.validate_against_signature({"typo": 1}, fn)
    obj = {"a": [1, 2.5], "b": {"c": "d"}, "e": None}
    for is_json in (True, False):
        text = config.dumps(obj, is_json=is_json)
        assert text == jconfig.dumps(obj, is_json=is_json)
        assert config.loads(text, is_json=is_json) == obj
    for name in ("cfg.json", "cfg.yml"):
        config.dump(obj, tmp_path / name)
        assert config.load(tmp_path / name) == jconfig.load(tmp_path / name) == obj
    doc = {"p": Path("a/b")}
    assert json.dumps(doc, cls=PathEncoder) == json.dumps(doc, cls=JPathEncoder)


@pytest.fixture(scope="module")
def native_library():
    """Both packages' loaders on one finished library (built through the
    port's atomic loader; a failure the JAX loader cached at collection
    cleared): ``test_torch_native_sync.one_native_library``."""
    return one_native_library()


@pytest.mark.parametrize("order", [0, 1])
def test_native_resampler_matches_numpy_and_the_original(order, native_library):
    """``Spacingd._resample`` asks ``native.available()`` and takes the native
    resampler or the numpy one by that answer; both give the same volume
    (1e-4 absolute: float32 coordinates in the library, float64 in numpy).
    The original library binding gives the same volume: the fixture holds
    its loader to the port's library."""
    rng = np.random.default_rng(3)
    data = rng.standard_normal((1, 9, 10, 11)).astype(np.float32)
    m = np.concatenate([np.diag([0.7, 0.9, 1.2]), [[0.3], [-0.2], [0.5]]], axis=1)  # (3, 4)
    plain = resample_affine_np(data, m, (12, 11, 9), order=order)
    got = Spacingd._resample(data, m, (12, 11, 9), order)
    assert got.shape == plain.shape and got.dtype == plain.dtype
    if not native_library:
        np.testing.assert_array_equal(got, plain)
        return
    np.testing.assert_array_equal(got, native.resample_affine(data, m, (12, 11, 9), order=order))
    np.testing.assert_array_equal(got, jnative.resample_affine(data, m, (12, 11, 9), order=order))
    if order == 1:
        np.testing.assert_allclose(got, plain, atol=1e-4)
    else:  # nearest picks may differ only where a coordinate lands on a tie
        assert (got != plain).mean() < 0.01


def test_native_build_is_atomic_under_concurrent_loaders(tmp_path):
    """Six processes, started in two waves, on a ``native/`` without the
    library, with a compiler that writes its output in two parts a second
    apart (as a slow linker would): one builds it (under the lock, linked to
    a temporary name and renamed into place), and every one loads it, the
    second wave too, which finds the build under way; no temporary file is
    left."""
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in ("Makefile", "segmantic_native.cpp"):
        (native_dir / name).write_bytes((REPO / "native" / name).read_bytes())
    slow_cxx = tmp_path / "slow-cxx"
    slow_cxx.write_text(textwrap.dedent("""\
        #!/bin/sh
        out=""; prev=""
        for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
        g++ "$@" -o "$out.whole" || exit 1
        head -c 4096 "$out.whole" > "$out"; sleep 1; cat "$out.whole" > "$out"
        rm -f "$out.whole"
    """))
    slow_cxx.chmod(0o755)
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(REPO)!r})
        from segmantic_tpu_torch import native
        d = Path({str(native_dir)!r})
        native._NATIVE_DIR, native._BUILD_LOCK = d, d / ".build.lock"
        native._LIB_PATH = d / "libsegmantic_native.so"
        print(native.available())
    """)
    env = dict(os.environ, CXX=str(slow_cxx))
    procs = []
    for wave in range(2):
        procs += [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True, env=env)
                  for _ in range(3)]
        deadline = time.monotonic() + 120
        while wave == 0 and time.monotonic() < deadline and not any(
                p.name.endswith((".so", ".tmp")) for p in native_dir.iterdir()):
            time.sleep(0.05)  # the second wave starts once the first is linking
    outs = [p.communicate(timeout=600) for p in procs]
    assert [o.strip() for o, _ in outs] == ["True"] * 6, [e for _, e in outs]
    assert sorted(p.name for p in native_dir.iterdir()) == [
        ".build.lock", "Makefile", "libsegmantic_native.so", "segmantic_native.cpp"]


def test_native_unavailable_takes_the_numpy_resampler(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "resample_affine",
                        lambda *a, **k: pytest.fail("native resampler called"))
    data = np.random.default_rng(4).standard_normal((1, 6, 6, 6)).astype(np.float32)
    m = np.eye(3, 4)
    np.testing.assert_array_equal(Spacingd._resample(data, m, (6, 6, 6), 1),
                                  resample_affine_np(data, m, (6, 6, 6), order=1))


@pytest.mark.parametrize("shape,target", [((5, 6, 7), (8, 6, 9)), ((5, 6), (7, 7)),
                                          ((9, 9, 9), (4, 4, 4))])
def test_pad_matches(shape, target):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2, *shape)).astype(np.float32)
    aff = _oblique_affine(rng)
    got = processing.pad(volume.Volume(data=data, affine=aff), target, value=-1.0)
    want = jprocessing.pad(jvolume.Volume(data=data, affine=aff.copy()), target, value=-1.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.affine, want.affine)


@pytest.mark.parametrize("key,base_dir", [("test", None), ("training", None),
                                          ("test", "elsewhere")])
def test_datalist_copy_matches(tmp_path, key, base_dir):
    doc = tmp_path / "sub" / "datalist.json"
    doc.parent.mkdir()
    doc.write_text(json.dumps({
        "training": [{"image": "img/a.nii.gz", "label": "lbl/a.nii.gz"},
                     {"image": str(tmp_path / "abs.nii.gz"), "label": "lbl/b.nii.gz"}],
        "test": ["img/c.nii.gz", {"image": "img/d.nii.gz"}]}))
    base = tmp_path / base_dir if base_dir else None
    got = datalist.load_decathlon_datalist(doc, data_list_key=key, base_dir=base)
    assert got == jdatalist.load_decathlon_datalist(doc, data_list_key=key, base_dir=base)
    assert got[0]["image"].parent.parent == (base or doc.parent)
    with pytest.raises(KeyError, match="no section 'validation'"):
        datalist.load_decathlon_datalist(doc, data_list_key="validation")


def test_labels_copy_matches(tmp_path):
    tissues = {"Background": 0, "Bone": 1, "Fat": 2, "Skin": 3, "Bone_marrow": 4}
    mapper = lambda name: name.split("_")[0]  # noqa: E731
    got_map, got_lut = labels.build_tissue_mapping(tissues, mapper)
    want_map, want_lut = jlabels.build_tissue_mapping(tissues, mapper)
    assert got_map == want_map and got_lut.dtype == want_lut.dtype == np.uint16
    np.testing.assert_array_equal(got_lut, want_lut)
    for label in range(1, 5):
        assert labels.default_tissue_color(label, 4) == jlabels.default_tissue_color(label, 4)
    with pytest.raises(ValueError):
        labels.default_tissue_color(0, 4)
    named = {k: v for k, v in tissues.items() if v}
    labels.save_tissue_list(named, tmp_path / "port.txt")
    jlabels.save_tissue_list(named, tmp_path / "jax.txt")
    labels.save_tissue_list(named, tmp_path / "gray.txt", lambda name: (0.5, 0.5, 0.5))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    for name in ("port.txt", "gray.txt"):
        path = tmp_path / name
        assert labels.load_tissue_list(path) == jlabels.load_tissue_list(path) == tissues
        assert labels.load_tissue_colors(path) == jlabels.load_tissue_colors(path)
    assert labels.load_tissue_colors(tmp_path / "gray.txt")[3] == (0.5, 0.5, 0.5)
    with pytest.raises(KeyError, match="duplicate"):
        labels.save_tissue_list({"A": 1, "B": 1}, tmp_path / "dup.txt")


def test_plots_copy_matches(tmp_path):
    labels.save_tissue_list({"A": 1, "B": 2, "C": 3}, tmp_path / "tissues.txt")
    np.testing.assert_array_equal(plots.make_tissue_cmap(tmp_path / "tissues.txt").colors,
                                  jplots.make_tissue_cmap(tmp_path / "tissues.txt").colors)
    np.testing.assert_array_equal(plots.make_random_cmap(6, seed=3).colors,
                                  jplots.make_random_cmap(6, seed=3).colors)
    cm = np.array([[50, 2, 0], [3, 20, 1], [0, 0, 0]])
    plots.plot_confusion_matrix(cm, ["bg", "A", "B"], tmp_path / "port" / "cm.png", title="x")
    jplots.plot_confusion_matrix(cm, ["bg", "A", "B"], tmp_path / "jax" / "cm.png", title="x")
    for side in ("port", "jax"):
        assert (tmp_path / side / "cm.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plots_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setattr(plots, "_HAS_MPL", False)
    for call in (lambda: plots.make_random_cmap(3), lambda: plots.make_tissue_cmap("x")):
        with pytest.raises(RuntimeError, match="matplotlib unavailable"):
            call()
    with pytest.warns(UserWarning, match="matplotlib unavailable"):
        plots.plot_confusion_matrix(np.eye(2), ["a", "b"], tmp_path / "cm.png")
    assert not (tmp_path / "cm.png").exists()


class _Fan:
    """A random stand-in transform: fans a sample out to ``n`` with one draw each."""

    is_random = True

    def __init__(self, n):
        self.n = n

    def __call__(self, sample, rng):
        return [dict(sample, draw=float(rng.random()), copy=i) for i in range(self.n)]


@pytest.mark.parametrize("mod", [base, jbase], ids=["port", "jax"])
def test_compose_copy_behaves_as_the_original(mod):
    tag = lambda s: dict(s, tagged=True)  # noqa: E731
    pipe = mod.Compose([tag, None, mod.Compose([_Fan(2), _Fan(3)])],
                       rng=np.random.default_rng(7))
    flat = pipe.flatten()
    assert len(pipe.transforms) == 2 and len(flat.transforms) == 3 and flat.rng is pipe.rng
    out = flat({"x": 1}, np.random.default_rng(1))
    ref = np.random.default_rng(1)
    firsts = [ref.random() for _ in range(2)]
    assert len(out) == 6 and all(o["tagged"] for o in out)
    assert [o["copy"] for o in out] == [0, 1, 2, 0, 1, 2]
    assert out[0]["draw"] not in firsts  # the second fan-out overwrote the first's draw
    det, rand = flat.split_deterministic()
    assert det.transforms == [tag] and len(rand.transforms) == 2
    assert mod.Compose([tag])({"x": 1}) == {"x": 1, "tagged": True}
    assert mod.MapTransform("a").keys == ["a"]
    assert mod.MapTransform(["a", "b"]).present_keys({"b": 0, "c": 1}) == ["b"]
    assert mod.RandMapTransform("a", 0.3).prob == 0.3 and mod.RandMapTransform.is_random


def test_registry_copy_resolves_values_as_the_original():
    context = {"image_key": "img", "size": [4, "@n"], "n": 7}
    for value in ("@image_key", "@size", "$n * 2 + size[0]", "plain", 3.5,
                  {"a": "@n", "b": ["$n - 1", ("x", "@image_key")]},
                  "$import math; math.floor(2.5) + n"):
        assert registry._resolve_value(value, context) == jregistry._resolve_value(value, context)
    assert registry._resolve_value("@size", context) == [4, 7]
    assert registry._eval_expr("import os.path; os.path.basename('a/b')", {}) == "b"
    with pytest.raises(NameError):  # no builtins beyond the context
        registry._eval_expr("open('x')", {})
    assert registry.build_transform("$n + 1", context) == 8
    assert registry._resolve_target("pathlib.PurePosixPath") is jregistry._resolve_target(
        "pathlib.PurePosixPath")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        segmantic_tpu_torch.__path__, "segmantic_tpu_torch."))


def test_every_port_module_imports_with_jax_and_segmantic_tpu_blocked():
    names = _port_modules()
    for pkg in ("core.volume", "io.nifti", "utils.config", "data.dataset", "native",
                "ops.fused_shear", "ops.phase_dice", "ops.shear_resample", "train.augment",
                "image.processing", "transforms.registry", "transforms.intensity",
                "transforms.base", "data.datalist", "image.labels", "viz.plots",
                "metrics.overlap", "infer.predict", "infer.ensemble",
                "train.cross_validate", "commands.unet_cli", "models.segresnet",
                "models.unetr", "infer.sliding_window", "i2i.models", "i2i.data",
                "i2i.train", "commands.i2i_cli", "ops.resample", "ops.gaussian",
                "detect.transforms", "metrics.distance", "image.modality", "image.utils",
                "image.make_mixed_modal_dataset", "data.iseg", "utils.flops",
                "utils.device", "parallel.mesh", "parallel.comm"):
        assert f"segmantic_tpu_torch.{pkg}" in names
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "flax", "optax", "segmantic_tpu"):
            sys.modules[name] = None  # import raises ImportError
        sys.path.insert(0, {str(REPO)!r})
        for name in {names!r}:
            importlib.import_module(name)
        loaded = [m for m, mod in sys.modules.items() if mod is not None
                  and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "segmantic_tpu")]
        print("OK", loaded)
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "OK []"


def test_no_port_source_imports_the_jax_package():
    """No ``import`` statement of the port, the smoke script or the profile
    script names ``segmantic_tpu`` or jax (comments and citations may)."""
    import ast

    files = list((REPO / "segmantic_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "profile_train_step.py"]
    banned = {"segmantic_tpu", "jax", "jaxlib", "flax", "optax"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not roots & banned, f"{path.relative_to(REPO)}:{node.lineno}"


def _definitions(path: Path):
    """Top-level functions and classes of a module, as syntax trees without
    their docstrings (comments are not in the tree)."""
    import ast

    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            for sub in ast.walk(node):
                body = getattr(sub, "body", None)
                if (isinstance(sub, (ast.FunctionDef, ast.ClassDef)) and body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    sub.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
    return out


# the port's numpy copies and what differs in them on purpose
_COPIES = {
    "image/modality.py": set(), "image/processing.py": set(), "image/utils.py": set(),
    "image/make_mixed_modal_dataset.py": set(), "data/iseg.py": set(),
    "metrics/distance.py": set(), "utils/flops.py": set(),
    # the heat map smooths on a torch device
    "detect/transforms.py": {"VertHeatMap"},
    # bf16 as uint16 bits (no ml_dtypes); the loader builds atomically
    "native.py": {"crop_patches_3d", "_load"},
}


@pytest.mark.parametrize("rel", sorted(_COPIES))
def test_copied_modules_keep_the_originals_code(rel):
    got = _definitions(REPO / "segmantic_tpu_torch" / rel)
    want = _definitions(REPO / "segmantic_tpu" / rel)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    same = {n for n in want if got[n] == want[n]}
    assert set(want) - same == _COPIES[rel], sorted(set(want) - same)
