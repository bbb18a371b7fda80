"""The port's data-parallel train step on two gloo CPU ranks against the JAX
package's step on two devices of the conftest's virtual CPU mesh and against
the port's own one-rank step, on the same numpy-seeded batches and the same
flax weights (bridged by ``from_flax_variables``).

The JAX tests' own limits (``tests/parallel/test_shardmap_step.py:58-71``,
``test_arch_dp.py:42``): loss rtol 1e-5; parameters and running statistics
rtol 1e-4 / atol 1e-5. SGD with momentum, as there: Adam's ``g / sqrt(v)``
turns reduction-order noise into updates of the size of the learning rate.
Cases: the 2D UNet (its top decoder stage runs in phase space, so a BatchNorm
reduces phase-major statistics per true channel), a 3D UNet, the 2D UNet with
``accumulate_steps=2`` and with ``remat``, SegResNet (GroupNorm: nothing
reduces but the gradients; those three in ``test_torch_parallel_step_extras``),
and a batch of 5 the two ranks cannot split, which runs whole on both.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu.parallel import mesh as jmesh
from segmantic_tpu.train import optim as jo
from segmantic_tpu.train.augment import AugmentConfig as JaxAugmentConfig
from segmantic_tpu.train.trainer import make_train_step as jax_make_train_step
from segmantic_tpu_torch.models.unet import from_flax_variables
from tests.test_torch_parallel_ranks import Ranks, steps_case

SGD = {"optimizer": "SGD", "lr": 1e-2, "momentum": 0.9}
UNET_2D = dict(spatial_dims=2, in_channels=1, out_channels=3, channels=(4, 8), strides=(2,),
               num_res_units=1)
UNET_3D = dict(spatial_dims=3, in_channels=1, out_channels=2, channels=(4, 8), strides=(2,),
               num_res_units=1)
SEGRESNET_2D = dict(spatial_dims=2, in_channels=1, out_channels=3, init_filters=4,
                    blocks_down=(1, 1), blocks_up=(1,))
NO_AUG = dict(spatial=False, intensity=False, flip_prob=0.0)


def _variables(flax_module, patch):
    return jax.device_get(flax_module.init(
        jax.random.key(0), jnp.zeros((1,) + tuple(patch) + (1,)), training=False))


def _batch(n, patch, classes, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + tuple(patch) + (1,)).astype(np.float32),
            rng.integers(0, classes, (n,) + tuple(patch)).astype(np.int32))


def jax_steps(flax_module, variables, image, label, patch, n_steps, mesh,
              optimizer=SGD, accumulate_steps=1, remat=False, zero=False, tp=False):
    """The JAX step on ``mesh`` as its tests drive it; (losses, port-keyed
    state)."""
    opt = jo.make_optimizer(optimizer)
    if accumulate_steps > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accumulate_steps)
    place = jmesh.shard_params if tp else jmesh.replicate
    params = place(mesh, variables["params"])
    bs = place(mesh, variables.get("batch_stats", {}))
    st = opt.init(params)
    st = jmesh.shard_opt_state(mesh, st) if zero else jmesh.replicate(mesh, st)
    step = jax_make_train_step(flax_module, opt, JaxAugmentConfig(**NO_AUG), patch,
                               mixed_precision=False, mesh=None if tp else mesh,
                               remat=remat, zero=zero)
    img, lbl = jmesh.put_batch(mesh, image), jmesh.put_batch(mesh, label)
    key, losses = jax.random.key(7), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        params, bs, st, loss = step(params, bs, st, img, lbl, sub)
        losses.append(float(loss))
    state = from_flax_variables(jax.device_get({"params": params, "batch_stats": bs}))
    return losses, state


def assert_state_close(got, want, rtol=1e-4, atol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


CASES = {
    "unet2d": dict(arch="unet", flax=lambda: FlaxUNet(**UNET_2D), model_kw=UNET_2D,
                   patch=(16, 16), batch=8, classes=3, n_steps=3),
    "unet3d": dict(arch="unet", flax=lambda: FlaxUNet(**UNET_3D), model_kw=UNET_3D,
                   patch=(8, 8, 8), batch=4, classes=2, n_steps=2),
    "undivided": dict(arch="unet", flax=lambda: FlaxUNet(**UNET_2D), model_kw=UNET_2D,
                      patch=(16, 16), batch=5, classes=3, n_steps=2),
}


def _one_thread(fn, **kw):
    """``fn(**kw)`` on one intra-op thread, as each rank runs (the CPU convs
    sum in another order with more threads)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(**kw)
    finally:
        torch.set_num_threads(threads)


def make_runs(cases, tmp):
    """Every case on two ranks (one spawn), on one rank of the port, and on
    the JAX package's two-device mesh (the last two while the ranks run)."""
    jax_mesh = jmesh.make_mesh(devices=jax.devices()[:2])
    inputs = {}
    for name, c in cases.items():
        flax_module = c["flax"]()
        variables = _variables(flax_module, c["patch"])
        image, label = _batch(c["batch"], c["patch"], c["classes"])
        extra = {k: c[k] for k in ("accumulate_steps", "remat", "optimizer") if k in c}
        kw = dict(arch=c["arch"], model_kw=c["model_kw"], variables=variables, image=image,
                  label=label, patch=c["patch"], n_steps=c["n_steps"], **extra)
        inputs[name] = (flax_module, kw, extra)
    ranks = Ranks("steps", 2, tmp,
                  cases=[kw for _, kw, _ in inputs.values()])
    out = {}
    for name, (flax_module, kw, extra) in inputs.items():
        out[name] = {"one": _one_thread(steps_case, **dict(kw, mesh=False)),
                     "jax": jax_steps(flax_module, kw["variables"], kw["image"], kw["label"],
                                      kw["patch"], kw["n_steps"], jax_mesh, **extra)}
    two = ranks.wait()
    for i, name in enumerate(cases):
        out[name]["two"] = [two[0][i], two[1][i]]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(CASES, tmp_path_factory.mktemp("steps"))


def check_two_ranks(r):
    """Both ranks agree bit for bit; the 2-rank step matches the JAX mesh and
    the port's one rank within the JAX tests' limits."""
    (r0, r1), one = r["two"], r["one"]
    jax_losses, jax_state = r["jax"]
    # both ranks hold the same loss and the same (replicated) state
    assert r0["losses"] == r1["losses"]
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], err_msg=k)
    np.testing.assert_allclose(r0["losses"], jax_losses, rtol=1e-5)
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-5)
    assert_state_close(r0["state"], jax_state)
    assert_state_close(r0["state"], one["state"])


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_jax_mesh_and_one_rank(runs, name):
    check_two_ranks(runs[name])


def test_an_undivided_batch_runs_whole_on_every_rank(runs):
    """5 rows over 2 ranks: no rank splits them, so nothing reduces and the
    step is the one-rank step bit for bit."""
    r = runs["undivided"]
    assert r["two"][0]["losses"] == r["one"]["losses"]
    for k, v in r["one"]["state"].items():
        np.testing.assert_array_equal(r["two"][0]["state"][k], v, err_msg=k)
