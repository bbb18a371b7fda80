"""The ported UNet and its folded eval forward vs the JAX package.

A tiny UNet (channels (8, 16, 32), strides (2, 2), 2 residual units,
3 classes: both decoder stages run in phase space) gets a flax variables tree
filled from a numpy seed (non-trivial BatchNorm statistics), bridged into the
torch modules, and compared in f32: the plain module forward against ``module.apply``, and the
port's executor (the kernels' plain versions on the CPU) against the JAX
executor ``make_eval_forward(module, jnp.float32)``. Tolerance 2e-4 absolute +
2e-3 relative, the JAX package's own executor-vs-module bound (folded-norm
rounding and summation order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.infer.executor import make_eval_forward as jax_eval_forward
from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu_torch.infer import executor
from segmantic_tpu_torch.models.unet import UNet, from_flax_variables, to_flax_variables
from segmantic_tpu_torch.ops import fused_conv, phase_conv

CFG = dict(in_channels=1, out_channels=3, channels=(8, 16, 32), strides=(2, 2),
           num_res_units=2)
SHAPE = (2, 16, 16, 16, 1)


def _flax_variables(module, seed=0):
    """The flax variables tree (shapes from ``module.init`` traced, not run)
    filled from a numpy seed: lecun-scale kernels, non-trivial biases, BN
    scales and running statistics, so BN folding is really tested."""
    shapes = jax.eval_shape(
        lambda k, x: module.init(k, x, training=False),
        jax.random.key(0), jnp.zeros((1, 4, 4, 4, module.in_channels)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        n = rng.standard_normal(leaf.shape)
        if name == "kernel":
            v = n / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("var", "scale"):
            v = 1.0 + 0.2 * np.abs(n)
        elif name == "alpha":
            v = 0.25 + 0.05 * n
        else:  # bias, mean
            v = 0.1 * n
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _bridge(variables, **cfg):
    model = UNet(**cfg)
    state = from_flax_variables(jax.tree_util.tree_map(np.asarray, variables))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model.eval()


@pytest.fixture(scope="module")
def case():
    module = FlaxUNet(spatial_dims=3, **CFG)
    variables = _flax_variables(module)
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    return module, variables, x, _bridge(variables, **CFG)


def test_bridge_round_trip(case):
    _, variables, _, model = case
    assert set(from_flax_variables(variables)) == set(model.state_dict())
    back = to_flax_variables(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


def test_module_forward_matches_flax_apply(case):
    module, variables, x, model = case
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(module.apply(variables, jnp.asarray(x), training=False))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_executor_matches_jax_executor_f32(case, monkeypatch):
    module, variables, x, model = case
    calls = {"fused": 0, "phase": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fused_conv, "conv3d", counting("fused", fused_conv.conv3d))
    monkeypatch.setattr(phase_conv, "phase_conv", counting("phase", phase_conv.phase_conv))
    got = executor.make_eval_forward(model, torch.float32)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_eval_forward(module, jnp.float32)(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    ref = np.asarray(module.apply(variables, jnp.asarray(x), training=False))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
    # every stride-1 3^3 subunit conv through the fused conv (one per strided
    # encoder unit, two in the bottom unit) and both decoder stages in phase space
    assert calls == {"fused": 4, "phase": 2}


@pytest.mark.parametrize("cfg", [
    dict(CFG, num_res_units=0),
    dict(CFG, num_res_units=1, act="RELU", norm="NONE"),
], ids=["no_res_units", "relu_no_norm"])
def test_executor_variants_match_jax(cfg):
    module = FlaxUNet(spatial_dims=3, **cfg)
    variables = _flax_variables(module, seed=4)
    model = _bridge(variables, **cfg)
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    got = executor.make_eval_forward(model, torch.float32)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_eval_forward(module, jnp.float32)(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_executor_bf16_close_to_f32(case):
    """bf16 compute stays within bf16 resolution of the f32 forward (the
    JAX package's executor bf16 bound)."""
    _, _, x, model = case
    f32 = executor.make_eval_forward(model, torch.float32)(torch.from_numpy(x))
    bf16 = executor.make_eval_forward(model, torch.bfloat16)(torch.from_numpy(x))
    assert bf16.dtype == torch.float32
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), atol=0.15, rtol=0.1)
    assert float((bf16 - f32).abs().mean()) < 0.02
