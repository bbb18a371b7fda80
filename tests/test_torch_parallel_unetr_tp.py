"""Tensor parallelism of the packed UNETR on two gloo CPU ranks.

At feature size 32 the phase-space region's kernels reach ``shard_params``'
``min_features`` of 64 (``encoder2``'s last stage and ``decoder3`` have 2f =
64 output channels). Their outputs are phase-major, so ``tp_placement``
keeps the region whole; the other kernels (the 4f and 8f stages, the MLP's
first Dense) run column-parallel. The model axis of 2 is held against the
mesh-less packed model: the eval forward's logits, then two SGD steps
(losses and the gathered state), within the limits of
``test_torch_parallel_zero_tp.py``'s TP test.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from segmantic_tpu_torch.models.unet import to_flax_variables
from segmantic_tpu_torch.models.unetr import UNETR
from segmantic_tpu_torch.parallel import mesh as pmesh
from segmantic_tpu_torch.parallel.mesh import TensorParallel
from tests.test_torch_parallel_ranks import Ranks, forward_case, steps_case
from tests.test_torch_parallel_step import _batch, _one_thread

PATCH = (16, 16, 16)
NET = dict(spatial_size=PATCH, in_channels=1, out_channels=3, hidden_size=32, num_layers=2,
           num_heads=2, mlp_dim=64, feature_size=32)
SGD = {"optimizer": "SGD", "lr": 1e-2, "momentum": 0.9}
# the layers of the phase-space region (packed UNETR's)
PHASE_LAYERS = ("encoder1.", "encoder2_up_2.", "encoder2_conv_2.", "decoder3_up.",
                "decoder3_conv.", "decoder2_up.", "decoder2_conv.", "out.")


def _variables():
    return to_flax_variables(UNETR(generator=torch.Generator().manual_seed(5),
                                   **NET).state_dict())


def _in_phase_region(key):
    return key.startswith(PHASE_LAYERS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    variables = _variables()
    image, label = _batch(2, PATCH, 3)
    steps = dict(arch="unetr", model_kw=NET, variables=variables, image=image, label=label,
                 patch=PATCH, n_steps=2, optimizer=SGD)
    ranks = Ranks("forward", 2, tmp_path_factory.mktemp("unetr_tp"), cases=[dict(
        arch="unetr", model_kw=NET, variables=variables, image=image, model=2,
        steps=dict(steps, model=2))])
    one = _one_thread(forward_case, arch="unetr", model_kw=NET, variables=variables,
                      image=image)
    one_steps = _one_thread(steps_case, **dict(steps, mesh=False))
    return ranks.wait(), one, one_steps


def test_tp_placement_keeps_the_phase_region_whole():
    """The rule without the marks would slice phase-region kernels at this
    width; with them it picks none of the region's conv and deconv tensors
    (the norms' vectors stay whole anyway), and still picks kernels outside
    it."""
    module = UNETR(**NET)
    ndim = {k: v.ndim for k, v in module.state_dict().items()}
    picked = pmesh.tp_placement(module, 2)
    assert any(ndim[k] >= 2 for k in picked)
    assert not any(_in_phase_region(k) for k in picked if ".Norm_" not in k)
    for m in module.modules():
        m.__dict__.pop("phase_space", None)
    unmarked = pmesh.tp_placement(module, 2)
    assert any(_in_phase_region(k) and ndim[k] >= 2 for k in unmarked)


def test_a_sharded_phase_layer_refuses_to_run():
    """Were a phase-space layer sliced anyway, it raises rather than gather
    phase-major channels as plain ones."""
    module = UNETR(**NET)
    tp = TensorParallel(None, 0, 2)
    module.decoder3_up.deconv.tp = tp
    with pytest.raises(ValueError, match="never sharded"):
        module.decoder3_up(torch.zeros(1, 4, 4, 4, 128))
    module.decoder3_conv.conv_1.tp = tp
    with pytest.raises(ValueError, match="never sharded"):
        module.decoder3_conv.conv_1(torch.zeros(1, 4, 4, 4, 8 * 64), phase=True)


def test_packed_unetr_tp_forward_matches_the_mesh_less_forward(runs):
    two, one, _ = runs
    for rank in two:
        out = rank[0]
        assert out["sliced"] and not any(_in_phase_region(k) for k in out["sliced"])
        assert out["logits"].shape == (2,) + PATCH + (3,)
        np.testing.assert_allclose(out["logits"], one["logits"], atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(two[0][0]["logits"], two[1][0]["logits"])


def test_packed_unetr_tp_steps_match_the_mesh_less_steps(runs):
    two, _, one = runs
    t0, t1 = (rank[0]["steps"] for rank in two)
    np.testing.assert_allclose(t0["losses"], one["losses"], rtol=2e-4)
    for k, v in one["state"].items():
        np.testing.assert_allclose(t0["state"][k], v, atol=2e-4, err_msg=k)
        np.testing.assert_array_equal(t0["state"][k], t1["state"][k], err_msg=k)
