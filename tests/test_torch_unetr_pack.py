"""The port's lane-packed UNETR against the JAX package's.

Packed (``UNETR(pack=True)``, the port's default, as
``SEGMANTIC_UNETR_PACK=on`` is the JAX package's), UNETR runs its narrow
regions, full resolution at C = f and half resolution at C = 2f, in subpixel
phase space. The model is the JAX package's own pack test's
(``tests/models/test_unetr_pack.py``: 32^3, hidden 64, 4 layers, 4 heads,
MLP 128, feature size 8, 3 classes) over a flax variables tree filled from a
numpy seed (``test_torch_unetr._variables``); inputs come from numpy seeds.

- ``subpixel_phase_conv_k2``, ``phase_pointwise_conv`` and ``phase_concat``
  against ``segmantic_tpu.ops.fast_conv``'s, 2D and 3D: bit-equal in f32 on
  integer-valued inputs (every partial sum is exact, so no summation order
  can round), and within 1e-6 on normal ones (the two libraries sum the
  products in their own orders);
- the packed forward and its phase logits against the JAX module packed,
  f32 (1e-4 absolute + 1e-3 relative, the JAX pack test's tolerance), and
  bf16 (as far from the f32 reference as the JAX package's packed bf16
  forward, plus one bf16 ulp of max|ref|);
- the port packed against the port unpacked (forward, gradients), the JAX
  variables loading unchanged into both, a checkpoint round trip, and the
  evaluation paths (``make_val_forward``, ``InferenceSession``,
  ``ensemble_creator``) running the packed forward on the phase-space convs
  and giving full-resolution logits.

The gradients and the train step against JAX's are in
``test_torch_unetr_pack_train.py`` (each file under a minute).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.models import unetr as junetr
from segmantic_tpu.ops import fast_conv as jfc
from segmantic_tpu_torch.infer.ensemble import ensemble_creator
from segmantic_tpu_torch.models import unetr as punetr
from segmantic_tpu_torch.models.unet import Conv, UNet, from_flax_variables, to_flax_variables
from segmantic_tpu_torch.ops import fast_conv as pfc
from segmantic_tpu_torch.ops import phase_conv
from segmantic_tpu_torch.serve import InferenceSession
from segmantic_tpu_torch.train import losses, trainer
from segmantic_tpu_torch.train.trainer import SegmentationModel
from tests.test_torch_predict import write_case
from tests.test_torch_unet_train import TOL, _assert_grads_close, _flat
from tests.test_torch_unetr import _variables

ARCH = dict(hidden_size=64, num_layers=4, num_heads=4, mlp_dim=128, feature_size=8)
CFG = dict(in_channels=1, out_channels=3, **ARCH)
SIZE = (32, 32, 32)
SHAPE = (2,) + SIZE + (1,)


@pytest.fixture(scope="module")
def case():
    module = junetr.UNETR(**CFG)
    rng = np.random.default_rng(31)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    labels = rng.integers(0, 3, SHAPE[:4]).astype(np.int32)
    return module, _variables(module, x, 32, training=False), x, labels


@pytest.fixture
def packed_jax(monkeypatch):
    monkeypatch.setenv("SEGMANTIC_UNETR_PACK", "on")
    assert junetr.pack_on()


def _bridge(variables, pack: bool = True):
    model = punetr.UNETR(spatial_size=SIZE, pack=pack, **CFG)
    state = from_flax_variables(jax.tree_util.tree_map(np.asarray, variables))
    assert set(state) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model.eval()


def _phase_args(name, nd, rng, draw):
    g = 2**nd
    sp = (2,) + (5,) * nd
    if name == "subpixel_phase_conv_k2":
        return draw(rng, sp + (6,)), draw(rng, (2,) * nd + (6, 4))
    if name == "phase_pointwise_conv":
        return draw(rng, sp + (g * 6,)), draw(rng, (1,) * nd + (6, 4)), draw(rng, (4,))
    return draw(rng, sp + (g * 6,)), draw(rng, sp + (g * 3,))


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("name", ["subpixel_phase_conv_k2", "phase_pointwise_conv",
                                  "phase_concat"])
def test_phase_function_matches_jax(name, nd):
    rng = np.random.default_rng(33 + nd)
    ints = _phase_args(name, nd, rng,
                       lambda r, s: r.integers(-8, 9, s).astype(np.float32))
    want = np.asarray(getattr(jfc, name)(*map(jnp.asarray, ints)))
    got = getattr(pfc, name)(*map(torch.from_numpy, ints))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    normal = _phase_args(name, nd, rng,
                         lambda r, s: r.standard_normal(s).astype(np.float32))
    want = np.asarray(getattr(jfc, name)(*map(jnp.asarray, normal)))
    got = getattr(pfc, name)(*map(torch.from_numpy, normal)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_subpixel_k2_is_the_conv_transpose(case):
    """``depth_to_space`` of the phase tensor is the module's plain kernel-2
    deconv (``ConvTranspose`` through ``F.conv_transpose3d``)."""
    _, variables, _, _ = case
    deconv = _bridge(variables).decoder3_up
    x = torch.from_numpy(np.random.default_rng(34).standard_normal(
        (2, 4, 4, 4, 32)).astype(np.float32))
    with torch.no_grad():
        plain = deconv.deconv(x)
        ph = deconv(x)
    assert deconv.phase_out and ph.shape == (2, 4, 4, 4, 8 * 16)
    np.testing.assert_allclose(pfc.depth_to_space(ph, 16).numpy(), plain.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_one_channel_phase_conv_takes_the_full_resolution_view(case, monkeypatch):
    """A phase-space 3^3 conv from one true channel (the input layer) takes
    the values of the plain conv of the full-resolution view, to 1e-6 (only
    the summation order differs), on the phase conv (kernels 3-6 on the card,
    whose few-channel bodies beat cuDNN on that view): called once, on the
    one-channel phase tensor, and its gradient reaches the kernel."""
    _, variables, x, _ = case
    conv = _bridge(variables).encoder1.conv_0
    calls = _count_phase_convs(monkeypatch)
    xt = torch.from_numpy(x)
    got = conv(pfc.space_to_depth(xt), phase=True)
    assert calls == [(2, 16, 16, 16, 8)] and got.shape == (2, 16, 16, 16, 8 * 8)
    with torch.no_grad():
        want = pfc.space_to_depth(conv(xt))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    conv.weight.requires_grad_(True)
    conv(pfc.space_to_depth(xt), phase=True).sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.abs().sum() > 0


def test_one_to_one_phase_conv_stays_on_the_phase_kernel(monkeypatch):
    """A one-class UNet's phase-space top stage (its residual unit 1 -> 1)
    runs its convs on the phase conv too, with the values of the plain conv
    of the full-resolution view."""
    model = UNet(out_channels=1, channels=(4, 8), strides=(2,), num_res_units=1,
                 generator=torch.Generator().manual_seed(35)).eval()
    assert model.phase_top_ok()
    calls = _count_phase_convs(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(36).standard_normal(
        (1, 8, 8, 8, 1)).astype(np.float32))
    with torch.no_grad():
        assert model(x).shape == (1, 8, 8, 8, 1)
    assert calls and all(shape == (1, 4, 4, 4, 8) for shape in calls)
    conv = next(m for m in model.modules()
                if isinstance(m, Conv) and tuple(m.weight.shape) == (1, 1, 3, 3, 3))
    p = pfc.space_to_depth(torch.from_numpy(np.random.default_rng(37).standard_normal(
        (1, 8, 8, 8, 1)).astype(np.float32)))
    with torch.no_grad():
        got = conv(p, phase=True)
        want = pfc.space_to_depth(conv(pfc.depth_to_space(p, 1)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_packed_forward_and_phase_logits_match_jax(case, packed_jax):
    module, variables, x, _ = case
    fwd = jax.jit(lambda v, x: module.apply(v, x, training=False))
    fwd_phase = jax.jit(lambda v, x: module.apply(v, x, training=False, phase_logits=True))
    want, want_phase = (np.asarray(f(variables, jnp.asarray(x))) for f in (fwd, fwd_phase))
    model = _bridge(variables)
    assert model.pack and model.phase_top_ok() and module.phase_top_ok()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        got_phase = model(torch.from_numpy(x), phase_logits=True)
    assert got.shape == SHAPE[:4] + (3,) and got_phase.shape == (2, 16, 16, 16, 24)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_phase.numpy(), want_phase, **TOL)


def test_packed_bf16_forward_is_as_close_as_the_jax_packed_bf16(case, packed_jax):
    """Two bf16 forwards of one graph differ by their rounding: the port's
    packed bf16 logits lie no further from the f32 reference than the JAX
    package's packed bf16 logits do, plus one bf16 ulp at max|ref|."""
    module, variables, x, _ = case
    fwd = jax.jit(lambda v, x: module.apply(v, x, training=False))
    want = np.asarray(fwd(variables, jnp.asarray(x)))
    jax16 = np.asarray(fwd(variables, jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    with torch.no_grad():
        got = _bridge(variables)(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got.float().numpy() - want).max() <= np.abs(jax16 - want).max() + ulp


def _port_grads(variables, x, labels, pack=True):
    model = _bridge(variables, pack=pack).double().train().requires_grad_(True)
    out = model(torch.from_numpy(x).double(), phase_logits=pack)
    lab = torch.from_numpy(labels)
    loss = (losses.dice_loss_phase(out, pfc.space_to_depth(lab[..., None])) if pack
            else losses.dice_loss(out, lab))
    loss.backward()
    return loss.item(), to_flax_variables({k: p.grad for k, p in model.named_parameters()})


def test_packed_matches_unpacked_port(case):
    """The two graphs of the port: the same logits in f32 and the same
    gradients in f64 (the phase Dice on the phase logits against the plain
    Dice on the full-resolution ones)."""
    _, variables, x, labels = case
    with torch.no_grad():
        on = _bridge(variables)(torch.from_numpy(x))
        off = _bridge(variables, pack=False)(torch.from_numpy(x))
    np.testing.assert_allclose(on.numpy(), off.numpy(), **TOL)
    loss_on, g_on = _port_grads(variables, x, labels)
    loss_off, g_off = _port_grads(variables, x, labels, pack=False)
    np.testing.assert_allclose(loss_on, loss_off, atol=1e-10)
    _assert_grads_close(g_on["params"], g_off["params"])


def test_jax_variables_load_unchanged_into_both(case, tmp_path):
    """One parameter tree for both graphs: the JAX variables bridge into
    each unchanged and back bit-equal, and a checkpoint the packed port
    saves loads into a packed module (the default) with the same tree."""
    _, variables, _, _ = case
    on, off = _bridge(variables), _bridge(variables, pack=False)
    assert on.state_dict().keys() == off.state_dict().keys()
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, variables["params"])))
    for model in (on, off):
        got = dict(_flat(to_flax_variables(model.state_dict())["params"]))
        assert got.keys() == want.keys()
        for key, leaf in want.items():
            np.testing.assert_array_equal(got[key], leaf)
    hparams = {"num_classes": 3, "spatial_size": list(SIZE), "arch": "unetr",
               "arch_params": ARCH}
    port = SegmentationModel.create(seed=0, device="cpu", **hparams)
    port.module.load_state_dict(on.state_dict())
    port.save(tmp_path / "m.ckpt")
    back = SegmentationModel.load(tmp_path / "m.ckpt", device="cpu")
    assert back.module.pack
    for k, v in on.state_dict().items():
        torch.testing.assert_close(back.module.state_dict()[k], v, rtol=0, atol=0)


def _count_phase_convs(monkeypatch):
    calls = []
    real = phase_conv.phase_conv_plain
    monkeypatch.setattr(phase_conv, "phase_conv_plain",
                        lambda p, w, *a, **k: calls.append(tuple(p.shape)) or real(p, w, *a, **k))
    return calls


def test_eval_paths_run_the_packed_forward(case, tmp_path, monkeypatch):
    """``make_val_forward`` (bf16), ``InferenceSession`` and
    ``ensemble_creator`` on a packed checkpoint: each window's forward runs
    8 phase-space convs on the phase conv (the one-channel input conv
    included), builds no autograd graph, and the logits and label maps are
    full resolution."""
    _, variables, x, _ = case
    model = SegmentationModel.create(num_classes=3, spatial_size=SIZE, arch="unetr",
                                     arch_params=ARCH, device="cpu")
    model.module.load_state_dict(_bridge(variables).state_dict())
    ckpt = tmp_path / "unetr.ckpt"
    model.save(ckpt)
    calls = _count_phase_convs(monkeypatch)
    logits = trainer.make_val_forward(model.module)(torch.from_numpy(x))
    assert logits.shape == SHAPE[:4] + (3,) and logits.dtype == torch.float32
    assert logits.grad_fn is None and len(calls) == 8
    image, label = write_case(tmp_path / "data", "c0", (36, 30, 28), 0)
    del calls[:]
    session = InferenceSession(ckpt, sw_batch_size=2, device="cpu")
    assert session.model.module.pack
    session.segment_bytes(image.read_bytes())
    assert calls and len(calls) % 8 == 0
    del calls[:]
    saved = ensemble_creator([ckpt, ckpt], [image], [label], output_dir=tmp_path / "ens",
                             combination_mode="mean", roi_size=SIZE, device="cpu")
    assert calls and len(calls) % 8 == 0 and len(saved) == 1
