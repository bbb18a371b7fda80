"""ZeRO-1 and tensor parallelism of the port on two gloo CPU ranks, against
the port's replicated data-parallel step, the JAX package's ZeRO / TP steps
on two devices of the conftest's virtual mesh, and the JAX placement rules.

Limits are the JAX tests' own: ZeRO equals the replicated update within
atol 1e-5 (``tests/parallel/test_zero_optimizer.py:65-78``, SGD with
momentum); TP follows the DP trajectory within rtol 2e-4 (losses) and atol
2e-4 (parameters) (``tests/parallel/test_tp_equivalence.py:58-78``). The JAX
TP step is its GSPMD step with XLA convs, so that parity is numbers only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu.parallel import mesh as jmesh
from segmantic_tpu_torch.models.unet import UNet, from_flax_variables
from segmantic_tpu_torch.parallel import mesh as pmesh
from segmantic_tpu_torch.train import trainer
from segmantic_tpu_torch.train.augment import AugmentConfig
from tests.test_torch_parallel_ranks import Ranks
from tests.test_torch_parallel_step import _batch, _variables, assert_state_close, jax_steps

SGD = {"optimizer": "SGD", "lr": 1e-2, "momentum": 0.9}
ADAM = {"optimizer": "Adam", "lr": 1e-3}
ZERO_NET = dict(spatial_dims=2, in_channels=1, out_channels=3, channels=(8, 16),
                strides=(2,), num_res_units=1)
TP_NET = dict(spatial_dims=2, in_channels=1, out_channels=3, channels=(64, 128),
              strides=(2,), num_res_units=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    zvars = _variables(FlaxUNet(**ZERO_NET), (16, 16))
    tvars = _variables(FlaxUNet(**TP_NET), (16, 16))
    image, label = _batch(8, (16, 16), 3)
    common = dict(arch="unet", image=image, label=label, patch=(16, 16))
    zero = dict(common, model_kw=ZERO_NET, variables=zvars, n_steps=3, optimizer=SGD)
    adam = dict(common, model_kw=ZERO_NET, variables=zvars, n_steps=1, optimizer=ADAM)
    tp = dict(common, model_kw=TP_NET, variables=tvars, n_steps=3, optimizer=SGD)
    cases = {"replicated": zero, "zero": dict(zero, zero=True), "adam": adam,
             "adam_zero": dict(adam, zero=True), "dp": tp, "tp": dict(tp, model=2)}
    ranks = Ranks("steps", 2, tmp_path_factory.mktemp("zero_tp"), cases=list(cases.values()))
    devices = jax.devices()[:2]
    jax_zero = jax_steps(FlaxUNet(**ZERO_NET), zvars, image, label, (16, 16), 3,
                         jmesh.make_mesh(devices=devices), optimizer=SGD, zero=True)
    jax_tp = jax_steps(FlaxUNet(**TP_NET), tvars, image, label, (16, 16), 3,
                       jmesh.make_mesh(devices=devices, data=1, model=2), optimizer=SGD,
                       tp=True)
    two = ranks.wait()
    return {name: (two[0][i], two[1][i]) for i, name in enumerate(cases)} | {
        "jax_zero": jax_zero, "jax_tp": jax_tp}


def test_zero_matches_the_replicated_update(runs):
    (z0, z1), (r0, _) = runs["zero"], runs["replicated"]
    np.testing.assert_allclose(z0["losses"], r0["losses"], rtol=1e-5)
    for k, v in r0["state"].items():
        np.testing.assert_allclose(z0["state"][k], v, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(z0["state"][k], z1["state"][k], err_msg=k)
    jax_losses, jax_state = runs["jax_zero"]
    np.testing.assert_allclose(z0["losses"], jax_losses, rtol=1e-5)
    assert_state_close(z0["state"], jax_state)


def test_zero_moments_are_partitioned(runs):
    """Adam: every rank holds about half of the moments' bytes (the leaves
    without an even axis, PReLU slopes and the 3-class bias among them, stay
    whole); the one ZeRO step equals the replicated one."""
    (z0, z1), (r0, _) = runs["adam_zero"], runs["adam"]
    for z in (z0, z1):
        assert 0.45 * r0["moment_bytes"] < z["moment_bytes"] < 0.55 * r0["moment_bytes"]
    np.testing.assert_allclose(z0["losses"], r0["losses"], rtol=1e-5)


def _shapes(flax_module, nd):
    """The flax variables' shapes (traced, not run)."""
    return jax.eval_shape(lambda k: flax_module.init(k, jnp.zeros((1,) + (8,) * nd + (1,)),
                                                     training=False), jax.random.key(0))


def _marker_tree(tree, mark):
    """``tree`` with each leaf replaced by ``mark(path, leaf)`` (an array of the
    leaf's shape)."""
    return jax.tree_util.tree_map_with_path(mark, tree)


def test_zero_axis_is_the_jax_placements():
    """For every parameter the axis the port slices (chosen on the flax
    layout) is the axis JAX's ``zero_placement`` shards, carried through the
    bridge by an array that counts along that axis."""
    jax_mesh = jmesh.make_mesh(devices=jax.devices()[:2])
    for cfg in (ZERO_NET, TP_NET, dict(ZERO_NET, spatial_dims=3, channels=(6, 12))):
        variables = _shapes(FlaxUNet(**cfg), cfg["spatial_dims"])

        def mark(path, x):
            spec = tuple(jmesh.zero_placement(jax_mesh, jnp.zeros(x.shape)).spec)
            if "data" not in spec:
                return np.full(x.shape, -1.0, np.float32)
            return np.indices(x.shape)[spec.index("data")].astype(np.float32)

        marked = from_flax_variables({"params": _marker_tree(variables["params"], mark)})
        module = UNet(**cfg)
        opt = torch.optim.SGD(module.parameters(), lr=0.0)
        pmesh.shard_opt_state(pmesh.Mesh({"data": 2, "model": 1}, (0, 1), 0), opt, module)
        names = {id(p): k for k, p in module.named_parameters()}
        for p, _, axis in opt.zero_shards:
            arr = marked[names[id(p)]]
            if axis is None:
                assert (arr == -1).all(), names[id(p)]
                continue
            for b in range(arr.ndim):
                varies = not (np.diff(arr, axis=b) == 0).all()
                assert varies == (b == axis), (names[id(p)], b, axis)


def test_zero_refusals():
    module = UNet(**ZERO_NET)
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="zero=True needs a mesh"):
        trainer.make_train_step(module, opt, AugmentConfig(), (16, 16), False, zero=True)
    with pytest.raises(ValueError, match="zero_optimizer does not combine with model_parallel"):
        trainer._check_parallel(model_parallel=2, zero_optimizer=True, world=2)
    with pytest.raises(ValueError, match=r"model_parallel=3 must divide the device count \(2\)"):
        trainer._check_parallel(model_parallel=3, zero_optimizer=False, world=2)


def test_tp_matches_the_dp_trajectory(runs):
    (t0, t1), (d0, _) = runs["tp"], runs["dp"]
    np.testing.assert_allclose(t0["losses"], d0["losses"], rtol=2e-4)
    for k, v in d0["state"].items():
        np.testing.assert_allclose(t0["state"][k], v, atol=2e-4, err_msg=k)
        np.testing.assert_array_equal(t0["state"][k], t1["state"][k], err_msg=k)
    jax_losses, jax_state = runs["jax_tp"]
    np.testing.assert_allclose(t0["losses"], jax_losses, rtol=2e-4)
    for k, v in jax_state.items():
        np.testing.assert_allclose(t0["state"][k], v, atol=2e-4, err_msg=k)


def test_tp_kernels_hold_one_slice_per_rank(runs):
    """Each kernel the rule picks holds half its output axis on each rank;
    everything else is whole."""
    module = UNet(**TP_NET)
    picked = pmesh.tp_placement(module, 2)
    full = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    (t0, t1), sliced = runs["tp"], 0
    for shapes in (t0["shapes"], t1["shapes"]):
        for k, shape in shapes.items():
            if k in picked and len(shape) >= 2:
                want = list(full[k])
                want[picked[k]] //= 2
                assert shape == tuple(want), k
                sliced += 1
            else:
                assert shape == full[k], k
    assert sliced > 0


def test_tp_placement_picks_the_jax_rules_tensors():
    """``tp_placement`` on the torch layout picks exactly the tensors that the
    JAX ``shard_params`` places over 'model' on the flax tree (parameters and
    running statistics), mapped through the bridge."""
    jax_mesh = jmesh.make_mesh(devices=jax.devices()[:2], data=1, model=2)
    for cfg in (TP_NET, dict(TP_NET, spatial_dims=3, channels=(8, 64, 96), strides=(2, 2))):
        variables = _shapes(FlaxUNet(**cfg), cfg["spatial_dims"])
        placed = jmesh.shard_params(
            jax_mesh, jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype), variables))

        def mark(path, x):
            return np.full(x.shape, float("model" in tuple(x.sharding.spec)), np.float32)

        marked = from_flax_variables({k: _marker_tree(v, mark) for k, v in placed.items()})
        want = {k for k, v in marked.items() if v.size and v.flat[0] == 1.0}
        got = pmesh.tp_placement(UNet(**cfg), 2)
        assert want and set(got) == want
