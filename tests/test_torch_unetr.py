"""The port's UNETR against the JAX package's.

A tiny UNETR (hidden 32, 4 layers, 4 heads, MLP 64, feature size 8, 3
classes, 32^3 input, as ``tests/models/test_unetr.py``) gets a flax variables
tree filled from a numpy seed, bridged into the torch modules; both packages
run on the same numpy inputs:

- the forward in f32 against the JAX module with lane packing on and off
  (``SEGMANTIC_UNETR_PACK``; the port's ``UNETR(pack=True)`` and
  ``pack=False``), and the unpacked graph in bf16 (against the f32
  reference, as the JAX bf16 forward is judged); every parameter gradient of
  the Dice loss, unpacked (the packed graph's: ``test_torch_unetr_pack.py``);
- the transformer block's pieces (LayerNorm eps 1e-6, the attention, flax's
  tanh GELU) through the block against ``TransformerBlock``;
- a checkpoint written by either package's saver read by the other's
  reader, the variables bit-equal, the tree of the JAX module's ``init``;
- ``train(arch="unetr", device="cpu")`` for two epochs, and the refusals: no
  ``spatial_size``, a validation roi other than it, another input size;
- ``predict`` label maps against the JAX ``segment_volume`` (both forwards
  in f32).

The JAX model is built over the filled variables, not by its ``create``,
whose initialisers compile one by one (~45 s on the CPU).

Tolerances: f32 1e-4 absolute + 1e-3 relative; bf16 2e-2 * max|ref|;
gradients (in f64) 1e-3 * max|g| of each tensor; label maps >= 99.9% equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmantic_tpu.infer.predict as jpredict
import segmantic_tpu_torch.infer.predict as ppredict
from segmantic_tpu.models import unetr as junetr
from segmantic_tpu.train import checkpoint as jckpt
from segmantic_tpu.train import losses as jl
from segmantic_tpu.train.trainer import SegmentationModel as JaxModel
from segmantic_tpu_torch.models import unetr as punetr
from segmantic_tpu_torch.models.unet import from_flax_variables, to_flax_variables
from segmantic_tpu_torch.train import losses, trainer
from segmantic_tpu_torch.train.trainer import SegmentationModel
from segmantic_tpu.io.nifti import read_volume
from tests.test_torch_predict import f32_forwards, write_case
from tests.test_torch_train import phantoms  # noqa: F401 (a fixture)
from tests.test_torch_unet_train import TOL, _assert_grads_close

TINY = dict(hidden_size=32, num_layers=4, num_heads=4, mlp_dim=64, feature_size=8)
CFG = dict(in_channels=1, out_channels=3, **TINY)
SIZE = (32, 32, 32)
SHAPE = (2,) + SIZE + (1,)


def _variables(module, x, seed, **kw):
    """The flax variables tree (shapes traced by ``module.init(key, x, **kw)``,
    not run) filled from a numpy seed: lecun-scale kernels, scales near 1,
    non-trivial biases."""
    shapes = jax.eval_shape(lambda k: module.init(k, jnp.asarray(x), **kw),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        n = rng.standard_normal(leaf.shape)
        if name == "kernel":
            v = n / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.2 * np.abs(n)
        elif name == "pos_embed":
            v = 0.02 * n
        else:
            v = 0.1 * n
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _bridge(variables, pack: bool = True):
    model = punetr.UNETR(spatial_size=SIZE, pack=pack, **CFG)
    state = from_flax_variables(jax.tree_util.tree_map(np.asarray, variables))
    assert set(state) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model.eval()


@pytest.fixture(scope="module")
def case():
    module = junetr.UNETR(**CFG)
    rng = np.random.default_rng(21)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    labels = rng.integers(0, 3, SHAPE[:4]).astype(np.int32)
    return module, _variables(module, x, 22, training=False), x, labels


# the JAX ``SegmentationModel.create(num_classes=3, spatial_size=SIZE,
# arch="unetr", arch_params=TINY)`` hyperparameters
HPARAMS = {"num_classes": 3, "num_channels": 1, "spatial_dims": 3, "spatial_size": list(SIZE),
           "channels": [16, 32, 64, 128, 256], "strides": [2, 2, 2, 2], "dropout": 0.0,
           "act": "PRELU", "num_res_units": 2, "norm": "BATCH", "arch": "unetr",
           "arch_params": TINY}


@pytest.fixture(scope="module")
def jax_model(case):
    """The JAX package's model bundle over the filled variables (its
    ``create`` would run flax's initialisers, each compiled on its own: ~45 s
    on the CPU for this model)."""
    module, variables, _, _ = case
    return JaxModel(module=module, variables=variables, hparams=dict(HPARAMS))


@pytest.fixture(scope="module")
def ckpt(jax_model, tmp_path_factory):
    """A UNETR checkpoint written by the JAX package's saver."""
    path = tmp_path_factory.mktemp("unetr") / "unetr.ckpt"
    jckpt.save_checkpoint(path, jax_model.variables, jax_model.hparams,
                          metrics={"val_dice": 0.5})
    return path


@pytest.mark.parametrize("pack", ["on", "off"])
def test_forward_matches_flax_f32_packed_or_not(case, monkeypatch, pack):
    module, variables, x, _ = case
    monkeypatch.setenv("SEGMANTIC_UNETR_PACK", pack)
    assert junetr.pack_on() == (pack == "on")
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, training=False))(
        variables, jnp.asarray(x)))
    model = _bridge(variables, pack=pack == "on")
    assert model.pack == (pack == "on")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == SHAPE[:4] + (3,)
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_bf16_within_bf16_rounding_of_flax(case, monkeypatch):
    """The bf16 forward against the flax module's f32 output, 2e-2 *
    max|ref|: the JAX package's own bf16 forward lies 1.8% of max|ref| from
    it at these weights (the logits' largest values are ~4.6, where a bf16 ulp
    is 0.03: two bf16 forwards differ by up to 3 ulps there)."""
    module, variables, x, _ = case
    monkeypatch.setenv("SEGMANTIC_UNETR_PACK", "off")
    fwd = jax.jit(lambda v, x: module.apply(v, x, training=False))
    want = np.asarray(fwd(variables, jnp.asarray(x)))
    jax16 = np.asarray(fwd(variables, jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    with torch.no_grad():
        got = _bridge(variables, pack=False)(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    limit = 2e-2 * np.abs(want).max()
    assert np.abs(jax16 - want).max() <= limit
    assert np.abs(got.float().numpy() - want).max() <= limit


def test_gradients_match_flax(case, monkeypatch):
    """Every parameter gradient of the Dice loss in f64 (the plain versions
    take f64 on the CPU; JAX under ``jax.enable_x64``): in f32 both packages'
    gradients of the tensors that feed a norm are dominated by summation
    order, each as far from the f64 gradient as from the other."""
    module, variables, x, labels = case
    monkeypatch.setenv("SEGMANTIC_UNETR_PACK", "off")

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        variables["params"])

        def loss_fn(p):
            out = module.apply({"params": p}, jnp.asarray(x, jnp.float64), training=True)
            return jl.dice_loss(out, jnp.asarray(labels))

        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
    model = _bridge(variables, pack=False).double().train().requires_grad_(True)
    loss = losses.dice_loss(model(torch.from_numpy(x).double()), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    grads = to_flax_variables({k: p.grad for k, p in model.named_parameters()})["params"]
    _assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_transformer_block_matches_flax(dtype):
    """LayerNorm (eps 1e-6), the attention (query scaled by 1/sqrt(head_dim),
    softmax in f32), the MLP with flax's tanh GELU; bf16 in, bf16 out."""
    block = junetr.TransformerBlock(hidden=32, heads=4, mlp_dim=64)
    z = np.random.default_rng(23).standard_normal((2, 8, 32)).astype(np.float32)
    variables = _variables(block, z, 24)
    want = np.asarray(block.apply(variables, jnp.asarray(z, dtype))).astype(np.float32)
    port = punetr.TransformerBlock(32, 4, 64)
    state = from_flax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": {"b": variables["params"]}}))
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in state.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(z).to(getattr(torch, jnp.dtype(dtype).name)))
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        assert got.dtype == torch.bfloat16
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_input_checks(case):
    """Packed (the default) the model emits the phase-major logits on
    request and the trainer's phase Dice takes them; unpacked it refuses."""
    _, variables, x, _ = case
    model = _bridge(variables)
    with pytest.raises(ValueError, match="position embedding"):
        model(torch.zeros(1, 48, 32, 32, 1))
    with pytest.raises(ValueError, match="divisible by patch"):
        model(torch.zeros(1, 40, 32, 32, 1))
    assert model.phase_top_ok()
    with torch.no_grad():
        assert model(torch.from_numpy(x), phase_logits=True).shape == (2, 16, 16, 16, 24)
    unpacked = _bridge(variables, pack=False)
    assert not unpacked.phase_top_ok()
    with pytest.raises(ValueError, match="phase logits"):
        unpacked(torch.from_numpy(x), phase_logits=True)
    with pytest.raises(ValueError, match="patch_size=16"):
        punetr.UNETR(spatial_size=SIZE, patch_size=8, **CFG)
    with pytest.raises(ValueError, match="requires spatial_size"):
        SegmentationModel.create(num_classes=3, arch="unetr", device="cpu")


def test_hparams_are_the_jax_packages():
    port = SegmentationModel.create(num_classes=3, spatial_size=SIZE, arch="unetr",
                                    arch_params=TINY, device="cpu")
    assert port.hparams == HPARAMS


def test_checkpoints_round_trip_both_ways(case, jax_model, ckpt, tmp_path):
    """The JAX checkpoint loads into the port with every variable bit-equal;
    the port's checkpoint reads back through the JAX package's reader the
    same, and its tree has the shapes the JAX module's ``init`` gives (what
    the JAX ``SegmentationModel.load`` checks it against)."""
    module, _, x, _ = case
    port = SegmentationModel.load(ckpt, device="cpu")
    assert isinstance(port.module, punetr.UNETR) and port.module.spatial_size == SIZE
    assert port.spatial_size == list(SIZE)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(port.variables["params"]))
    assert flat_w.keys() == flat_g.keys() and port.variables["batch_stats"] == {}
    for path, leaf in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], leaf)
    port.save(tmp_path / "port.ckpt")
    back = jckpt.load_checkpoint(tmp_path / "port.ckpt")
    assert back["hparams"] == HPARAMS and back["variables"]["batch_stats"] == {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(back["variables"]["params"]):
        np.testing.assert_array_equal(np.asarray(leaf), flat_w[path])
    template = jax.eval_shape(lambda k: module.init(k, jnp.asarray(x[:1]), training=False),
                              jax.random.key(0))["params"]
    shapes = jax.tree_util.tree_map(np.shape, back["variables"]["params"])
    assert shapes == jax.tree_util.tree_map(lambda a: a.shape, template)


def test_train_two_epochs_on_cpu_and_its_refusals(phantoms, tmp_path):  # noqa: F811
    root, _, _ = phantoms
    kw = dict(image_dir=root / "image", labels_dir=root / "label", num_classes=4,
              spatial_size=SIZE, arch="unetr", arch_params=TINY, max_epochs=2,
              batch_size=2, num_samples=2, device="cpu", seed=0)
    with pytest.raises(ValueError, match="val_roi_size"):
        trainer.train(output_dir=tmp_path / "roi", **kw)  # the default roi is 160^3
    with pytest.raises(ValueError, match="val_roi_size"):
        trainer.train(output_dir=tmp_path / "roi", val_roi_size=(16, 16, 16), **kw)
    result = trainer.train(output_dir=tmp_path / "run", val_roi_size=SIZE, **kw)
    assert len(result.history) == 2
    assert all(np.isfinite(v) for rec in result.history for v in rec.values())
    assert (tmp_path / "run" / "last.ckpt").exists() and result.best_checkpoint.exists()
    assert jckpt.load_checkpoint(tmp_path / "run" / "last.ckpt")["hparams"]["arch"] == "unetr"


def test_predict_label_maps_match_jax(jax_model, ckpt, tmp_path, monkeypatch):
    """The port's ``predict`` on the JAX checkpoint against the JAX
    package's ``segment_volume`` on the same model, both forwards in f32,
    both packed (each package's default)."""
    monkeypatch.setenv("SEGMANTIC_UNETR_PACK", "on")
    images, labels = zip(*(write_case(tmp_path / "data", f"c{i}", shape, i)
                           for i, shape in enumerate([(36, 30, 28), (40, 34, 33)])))
    f32_forwards(monkeypatch, jpredict, ppredict)
    got = ppredict.predict(ckpt, list(images), list(labels), output_dir=tmp_path / "port",
                           sw_batch_size=2, device="cpu")
    for g, image, label in zip(got, images, labels):
        want, _ = jpredict.segment_volume(jax_model, {"image": image, "label": label},
                                          sw_batch_size=2)
        saved = read_volume(g.saved_to)
        assert saved.spatial_shape == want.spatial_shape
        assert float((saved.numpy() == want.numpy()).mean()) >= 0.999
