"""The port's analytic FLOP counts against the JAX package's: every count
equal, for the flagship UNet, SegResNet, UNETR and a 2D UNet, with and
without the spatial augmentation's subset gating. The port names the H100's
dense bf16 peak where the JAX module names its TPU's."""

from __future__ import annotations

import dataclasses

import pytest

from segmantic_tpu.train.augment import AugmentConfig as JAugmentConfig
from segmantic_tpu.utils import flops as jflops
from segmantic_tpu_torch.train.augment import AugmentConfig
from segmantic_tpu_torch.utils import flops


@pytest.mark.parametrize("kw", [
    dict(batch=8, patch=(96, 96, 96), margin=24, num_classes=8),
    dict(batch=8, patch=(96, 96, 96), margin=24, num_classes=8, arch="segresnet"),
    dict(batch=8, patch=(96, 96, 96), margin=24, num_classes=8, arch="unetr"),
    dict(batch=16, patch=(256, 256), margin=64, num_classes=8),
    dict(batch=4, patch=(64, 80, 48), margin=0, num_classes=3, channels=(8, 16, 32),
         strides=(2, 2), num_res_units=0),
    dict(batch=6, patch=(45, 37, 50), margin=11, num_classes=5),
], ids=["flagship", "segresnet", "unetr", "2d", "small-no-res", "odd-sizes"])
@pytest.mark.parametrize("subset", [True, False], ids=["subset", "every-sample"])
def test_step_flops_equal_jax(kw, subset):
    got = flops.flagship_step_flops(**kw, aug_cfg=AugmentConfig(spatial=True,
                                                                 spatial_subset=subset))
    want = jflops.flagship_step_flops(**kw, aug_cfg=JAugmentConfig(spatial=True,
                                                                     spatial_subset=subset))
    assert got == want and set(got) == {"model_fwd", "model_fwd_bwd", "augment", "step"}
    assert got["step"] == got["model_fwd_bwd"] + got["augment"] and got["model_fwd"] > 0


def test_counts_equal_jax_without_a_config_and_apart():
    """The defaults (no ``aug_cfg``), each model count alone, and the
    augmentation count for odd margins and zoom bounds."""
    assert flops.flagship_step_flops(8, (96, 96, 96), 24, 8) == jflops.flagship_step_flops(
        8, (96, 96, 96), 24, 8)
    for args in (((96, 96, 96), 1, 8), ((128, 128), 2, 4), ((33, 47, 29), 1, 3)):
        assert flops.unet_fwd_flops(*args) == jflops.unet_fwd_flops(*args)
        assert flops.segresnet_fwd_flops(*args, init_filters=16) == \
            jflops.segresnet_fwd_flops(*args, init_filters=16)
    assert flops.unetr_fwd_flops((96, 96, 96), 1, 8, num_layers=6) == \
        jflops.unetr_fwd_flops((96, 96, 96), 1, 8, num_layers=6)
    cfg = dataclasses.replace(AugmentConfig(), rotate_prob=0.5, zoom_prob=0.1)
    jcfg = dataclasses.replace(JAugmentConfig(), rotate_prob=0.5, zoom_prob=0.1)
    for margin, out, zmin in (((144, 144, 144), (96, 96, 96), 0.8), ((61, 50, 77), (40, 33, 51),
                                                                    0.7), ((300, 280), (200, 190),
                                                                            1.0)):
        assert flops.augment_flops(8, margin, out, zoom_min=zmin, aug_cfg=cfg) == \
            jflops.augment_flops(8, margin, out, zoom_min=zmin, aug_cfg=jcfg)
    assert flops.H100_SXM_BF16_PEAK == 989e12 and not hasattr(flops, "TPU_V5E_BF16_PEAK")
