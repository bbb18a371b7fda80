"""The port's data-parallel train step on two gloo CPU ranks, continued
(``test_torch_parallel_step`` says how and within what limits): the 2D UNet
with ``accumulate_steps=2`` and with ``remat``, and SegResNet (GroupNorm:
nothing reduces but the gradients), against the JAX package's step on two
devices of the conftest's virtual mesh and the port's one-rank step; the
cross-rank BatchNorm alone against one process holding the whole batch; the
per-rank augmentation streams.
"""

from __future__ import annotations

import numpy as np
import pytest

from segmantic_tpu.models.segresnet import SegResNet as FlaxSegResNet
from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu_torch.train import augment as paugment
from tests.test_torch_parallel_ranks import run_ranks, steps_case
from tests.test_torch_parallel_step import (
    SEGRESNET_2D, UNET_2D, _batch, _variables, check_two_ranks, make_runs,
)

CASES = {
    "accumulate": dict(arch="unet", flax=lambda: FlaxUNet(**UNET_2D), model_kw=UNET_2D,
                       patch=(16, 16), batch=8, classes=3, n_steps=4, accumulate_steps=2),
    "remat": dict(arch="unet", flax=lambda: FlaxUNet(**UNET_2D), model_kw=UNET_2D,
                  patch=(16, 16), batch=8, classes=3, n_steps=2, remat=True),
    "segresnet": dict(arch="segresnet", flax=lambda: FlaxSegResNet(**SEGRESNET_2D),
                      model_kw=SEGRESNET_2D, patch=(16, 16), batch=8, classes=3, n_steps=1,
                      optimizer={"optimizer": "SGD", "lr": 1e-2}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(CASES, tmp_path_factory.mktemp("steps"))


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_jax_mesh_and_one_rank(runs, name):
    check_two_ranks(runs[name])


def test_cross_rank_batchnorm_keeps_flax_semantics(tmp_path):
    """BatchNorm on two ranks' rows against one process holding both ranks'
    rows: f32 statistics of bf16 input, the biased running variance, the
    statistics per true channel over 8 phases, and the input gradient of a
    loss summed over the ranks (it flows back through the reduced
    statistics)."""
    import torch

    from segmantic_tpu_torch.models.unet import BatchNorm

    rng = np.random.default_rng(5)
    cases = []
    for dtype, groups in ((torch.float32, 8), (torch.float32, 1), (torch.bfloat16, 8)):
        x = (1.5 * rng.standard_normal((4, 3, 5, groups * 6)) + 0.7).astype(np.float32)
        x = torch.from_numpy(x).to(dtype).float().numpy()  # values dtype can hold
        weight = rng.standard_normal(x.shape).astype(np.float32)
        cases.append(dict(x=x, groups=groups, weight=weight, dtype=str(dtype)[6:]))
    ranks = run_ranks("norm", 2, tmp_path, cases=cases)
    for i, case in enumerate(cases):
        x, groups, weight = case["x"], case["groups"], case["weight"]
        dtype = getattr(torch, case["dtype"])
        whole = torch.from_numpy(x).to(dtype).requires_grad_(True)
        bn = BatchNorm(6).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 6))
        y = bn(whole, groups=groups)
        (y.float() * torch.from_numpy(weight)).sum().backward()
        tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=2e-2,
                                                                             atol=2e-2)
        for r in range(2):
            got, rows = ranks[r][i], slice(2 * r, 2 * r + 2)
            np.testing.assert_allclose(got["y"], y.detach().float().numpy()[rows], **tol)
            np.testing.assert_allclose(got["dx"], whole.grad.float().numpy()[rows],
                                       rtol=max(tol["rtol"], 1e-4), atol=max(tol["atol"], 1e-5))
            np.testing.assert_allclose(got["mean"], bn.running_mean.numpy(), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(got["var"], bn.running_var.numpy(), rtol=1e-5)
            assert got["stat_dtype"] == "torch.float32"
        # the biased variance over the whole batch, per true channel
        xf = x.reshape(-1, 6).astype(np.float64)
        np.testing.assert_allclose(ranks[0][i]["var"], 0.9 + 0.1 * xf.var(0), rtol=1e-5)


def test_ranks_draw_distinct_augmentations(tmp_path):
    """Identical samples on both ranks, the spatial augmentation on and lr 0:
    each rank draws its own stream (the counterpart of the JAX step's
    ``fold_in(key, axis_index)``), so the averaged loss differs from one rank
    on one copy; each rank's exact-count subset is ``round(p * local_B)`` of
    its 4 rows, as in ``tests/parallel/test_dp_local_augment.py``."""
    flax_module = FlaxUNet(**UNET_2D)
    variables = _variables(flax_module, (16, 16))
    one, lbl_one = _batch(1, (24, 24), 3, seed=3)
    aug = dict(spatial=True, intensity=False, flip_prob=0.5)
    kw = dict(arch="unet", model_kw=UNET_2D, variables=variables,
              image=np.repeat(one, 8, 0), label=np.repeat(lbl_one, 8, 0), patch=(16, 16),
              n_steps=1, optimizer={"optimizer": "SGD", "lr": 0.0}, aug=aug, seed=5,
              record_augment=True)
    r0, r1 = run_ranks("steps", 2, tmp_path, cases=[kw])
    r0, r1 = r0[0], r1[0]
    single = steps_case(**dict(kw, image=one, label=lbl_one, mesh=False))
    assert r0["losses"] == r1["losses"]
    assert not np.allclose(r0["losses"], single["losses"], rtol=1e-6)
    cfg = paugment.AugmentConfig(**aug)
    p_any = 1.0 - (1.0 - cfg.rotate_prob) ** 1 * (1.0 - cfg.zoom_prob)
    (b0, n0, drawn0), (b1, n1, drawn1) = r0["drawn"] + r1["drawn"]
    assert b0 == b1 == 4 and n0 == n1 == paugment._subset_count(p_any, 4)
    assert drawn0 != drawn1  # the ranks' parameters differ
