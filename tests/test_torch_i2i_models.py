"""The port's i2i models (``segmantic_tpu_torch/i2i/models.py``) against the
JAX package's flax modules.

A tiny generator (base 8, 2 blocks) in 2D (2 x 32^2) and 3D (1 x 16^3) and a
tiny PatchGAN discriminator (base 8, 3 layers) get a flax variables tree
filled from a numpy seed, bridged into the torch modules, and both packages
run on the same numpy inputs:

- the forward in f32 within 1e-5 * max|ref|;
- every parameter gradient of a scalar loss (the output against a fixed
  random tensor), ``jax.grad`` in f32 against the port in f64, per tensor
  within 1e-4 * max(max|g| of that tensor, 1e-2 * the largest of all): the
  floor takes in the conv biases in front of an InstanceNorm, whose true
  gradient is zero and whose f32 gradient is rounding noise;
- ``InstanceNorm`` alone, a constant channel among its inputs;
- the XLA-SAME convs and the SAME conv-transpose of i2i at even and odd
  sizes against ``nn.Conv`` / ``nn.ConvTranspose``;
- the bridge: the tree equals ``init``'s (names and shapes), and it comes
  back bit-equal from the torch ``state_dict``.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.i2i import models as jm
from segmantic_tpu_torch.i2i import models as tm
from segmantic_tpu_torch.models.unet import Conv, ConvTranspose

BASE = 8
SHAPES = {2: (2, 32, 32, 1), 3: (1, 16, 16, 16, 1)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def filled_variables(module, x, seed: int):
    """The flax variables of ``module`` at input ``x`` (shapes traced, not
    run) filled from a numpy seed: lecun-scale kernels, non-trivial biases
    and norm scales."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), x)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape)
        name = path[-1].key
        if name == "kernel":
            v = n / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.2 * np.abs(n)
        else:
            v = 0.1 * n
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_module(kind: str, nd: int, c_in: int):
    if kind == "generator":
        return tm.ResnetGenerator(c_in, 1, BASE, 2, nd)
    return tm.PatchDiscriminator(c_in, BASE, spatial_dims=nd)


def flax_module(kind: str):
    if kind == "generator":
        return jm.ResnetGenerator(out_channels=1, base_features=BASE, n_blocks=2)
    return jm.PatchDiscriminator(base_features=BASE)


def bridged(kind, nd, variables, c_in, dtype=torch.float32):
    model = port_module(kind, nd, c_in)
    state = tm.from_flax_variables(variables)
    assert set(state) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model.to(dtype)


@pytest.fixture(scope="module", params=[(k, nd) for k in ("generator", "discriminator")
                                        for nd in (2, 3)], ids=lambda p: f"{p[0]}-{p[1]}d")
def case(request):
    kind, nd = request.param
    rng = np.random.default_rng(31 + nd)
    shape = SHAPES[nd]
    if kind == "discriminator":
        shape = shape[:-1] + (2,)  # pix2pix's D sees (source, image)
    x = rng.standard_normal(shape).astype(np.float32)
    module = flax_module(kind)
    variables = filled_variables(module, x, seed=40 + nd)
    apply = jax.jit(module.apply)
    return kind, nd, x, module, variables, apply


def _close(got, want, frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


def test_tree_equals_init_and_round_trips(case):
    """The bridged tree has ``init``'s names and shapes (``Conv_0`` ...
    ``Conv_3``, ``InstanceNorm_0`` ... ``InstanceNorm_4``, ``ResnetBlock_k``,
    ``ConvTranspose_0`` / ``_1``; the discriminator's ``Conv_0`` ... ``Conv_4``
    and ``InstanceNorm_0`` ... ``_2``), and comes back bit-equal."""
    kind, nd, x, module, variables, _ = case
    model = bridged(kind, nd, variables, x.shape[-1])
    back = tm.to_flax_variables(model.state_dict())
    want = dict(_flat(variables["params"]))
    got = dict(_flat(back["params"]))
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and np.array_equal(got[path], arr), path
    # the port's own init has the same tree
    fresh = tm.to_flax_variables(port_module(kind, nd, x.shape[-1]).state_dict())
    assert {p: a.shape for p, a in _flat(fresh["params"])} == {
        p: a.shape for p, a in want.items()}
    if kind == "generator":
        assert sorted(variables["params"]) == sorted(
            [f"Conv_{i}" for i in range(4)] + [f"InstanceNorm_{i}" for i in range(5)]
            + ["ResnetBlock_0", "ResnetBlock_1", "ConvTranspose_0", "ConvTranspose_1"])
    else:
        assert sorted(variables["params"]) == sorted(
            [f"Conv_{i}" for i in range(5)] + [f"InstanceNorm_{i}" for i in range(3)])


def test_forward_matches_flax(case):
    kind, nd, x, _, variables, apply = case
    want = np.asarray(apply(variables, x))
    got = bridged(kind, nd, variables, x.shape[-1])(torch.from_numpy(x)).detach().numpy()
    _close(got, want, 1e-5)
    if kind == "generator":
        assert want.shape == x.shape[:-1] + (1,) and np.abs(got).max() <= 1.0


def test_gradients_match_jax_in_f64(case):
    kind, nd, x, module, variables, _ = case
    rng = np.random.default_rng(50 + nd)
    y_shape = jax.eval_shape(module.apply, variables, x).shape
    r = rng.standard_normal(y_shape).astype(np.float32)

    def loss(params):
        return jnp.sum(module.apply({"params": params}, x) * r)

    want = dict(_flat(jax.jit(jax.grad(loss))(variables["params"])))
    model = bridged(kind, nd, variables, x.shape[-1], torch.float64)
    (model(torch.from_numpy(x).double()) * torch.from_numpy(r).double()).sum().backward()
    got = dict(_flat(tm.to_flax_variables(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
    assert set(got) == set(want)
    floor = 1e-2 * max(np.abs(g).max() for g in want.values())
    for path, g in want.items():
        err = np.abs(got[path] - g).max()
        assert err <= 1e-4 * max(np.abs(g).max(), floor), (path, err, np.abs(g).max())


@pytest.mark.parametrize("nd", [2, 3])
def test_instance_norm_matches_flax(nd):
    rng = np.random.default_rng(60 + nd)
    shape = (3,) + (6,) * nd + (4,)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    x[1, ..., 2] = 0.75  # a constant channel: var 0, the output is the bias
    scale = (1 + 0.2 * rng.standard_normal(4)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(4)).astype(np.float32)
    want = np.asarray(jm.InstanceNorm().apply({"params": {"scale": scale, "bias": bias}}, x))
    norm = tm.InstanceNorm(4)
    norm.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = norm(torch.from_numpy(x)).detach().numpy()
    _close(got, want, 1e-5)
    np.testing.assert_allclose(got[1, ..., 2], bias[2], atol=1e-6)
    assert [n for n, _ in norm.named_parameters()] == ["scale", "bias"]


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("k,stride,transposed", [(3, 2, False), (4, 1, False), (4, 2, False),
                                                 (7, 1, False), (3, 1, False), (3, 2, True)])
def test_same_padding_matches_flax(nd, size, k, stride, transposed):
    """XLA-SAME pads (0, 1) for the stride-2 3-kernel on even sizes, (1, 2)
    for the stride-1 4-kernel, (1, 1) for the stride-2 4-kernel on even
    sizes ((1, 2) on odd); the conv-transpose is flax's unflipped SAME one."""
    rng = np.random.default_rng(70 + 10 * nd + size + k)
    x = rng.standard_normal((2,) + (size,) * nd + (3,)).astype(np.float32)
    cls = fnn.ConvTranspose if transposed else fnn.Conv
    module = cls(5, (k,) * nd, strides=(stride,) * nd, padding="SAME")
    variables = filled_variables(module, x, seed=80 + k)
    want = np.asarray(module.apply(variables, x))
    port = (ConvTranspose if transposed else Conv)(3, 5, k, stride, nd=nd)
    sd = tm.from_flax_variables({"params": {
        ("ConvTranspose_0" if transposed else "Conv_0"): variables["params"]}})
    port.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(v) for k, v in sd.items()})
    got = port(torch.from_numpy(x)).detach().numpy()
    _close(got, want, 1e-5)
