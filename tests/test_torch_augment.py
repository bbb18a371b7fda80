"""The port's batched augmentation against the JAX package's pieces.

``jax.random`` and ``torch.Generator`` give different numbers from one seed,
so the two are compared by parameters: the port draws an ``AugmentParams``
(plain numpy) and applies it; the test replays the same parameters, sample by
sample, through ``segmantic_tpu``'s ``rotate_zoom_shear``, ``center_crop`` and
``intensity_ops`` in the order of its ``augment_batch``. Images agree within
1e-4 * max|ref| in f32 (order of f32 sums; the FFT Gibbs), labels exactly.
The draws are tested on their own: exact subset counts, ranges, and pattern
frequencies against ``_spatial_pattern_table``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import shear_resample as jsr
from segmantic_tpu.train import augment as jaug
from segmantic_tpu.transforms import intensity_ops as jiops
from segmantic_tpu_torch.train import augment as taug
from segmantic_tpu_torch.train.augment import AugmentConfig

FULL = AugmentConfig(spatial=True, intensity=True)


def _batch(seed, batch=8, margin=(24, 24, 24), channels=1):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in margin], indexing="ij"))
    images, labels = [], []
    for _ in range(batch):
        c = rng.uniform(-0.3, 0.3, len(margin)).reshape((-1,) + (1,) * len(margin))
        r2 = ((grid - c) ** 2).sum(0)
        lbl = (r2 < 0.6).astype(np.uint8) + (r2 < 0.3) + (r2 < 0.1)
        img = lbl[..., None] + 0.3 * rng.standard_normal(tuple(margin) + (channels,))
        images.append(img.astype(np.float32))
        labels.append(lbl.astype(np.uint8))
    return np.stack(images), np.stack(labels)


def _jax_replay(images, labels, p: taug.AugmentParams, cfg: AugmentConfig, out_shape):
    """The JAX package's augment_batch with every draw replaced by ``p``."""
    batch = images.shape[0]
    nd = labels.ndim - 1
    zoom_min = min(cfg.zoom_range[0], 1.0)
    spatial = {} if p.spatial_index is None else {int(s): i for i, s in
                                                  enumerate(p.spatial_index)}
    out_i, out_l = [], []
    for b in range(batch):
        img = jnp.moveaxis(jnp.asarray(images[b]), -1, 0)
        lbl = jnp.asarray(labels[b])[None]
        if b in spatial:
            angles, zoom = jnp.asarray(p.angles[spatial[b]]), jnp.asarray(p.zoom[spatial[b]])
            img = jsr.rotate_zoom_shear(img, angles, zoom, order=1, out_shape=out_shape,
                                        angle_max=cfg.rotate_range, zoom_min=zoom_min,
                                        bf16=cfg.interp_bf16)
            lbl = jsr.rotate_zoom_shear(lbl, angles, zoom, order=0, out_shape=out_shape,
                                        angle_max=cfg.rotate_range, zoom_min=zoom_min)
        img, lbl = jsr.center_crop(img, out_shape), jsr.center_crop(lbl, out_shape)
        if cfg.intensity:
            if p.contrast_gate[b]:
                img = jiops.adjust_contrast(img, p.contrast_gamma[b])
            if p.hist_gate[b]:
                k = p.hist_noise.shape[1]
                noise = jnp.asarray(p.hist_noise[b]).at[0].set(0.0).at[-1].set(0.0)
                src = jnp.linspace(0.0, 1.0, k)
                dst = jnp.sort(src + noise)
                mn, mx = jnp.min(img), jnp.max(img)
                img = jiops.histogram_shift(img, src * (mx - mn) + mn, dst * (mx - mn) + mn)
            if p.bias_gate[b]:
                img = jiops.bias_field(img, jnp.asarray(p.bias_coeff[b]), cfg.bias_degree)
        img = jiops.flip(img, jnp.asarray(p.flips[b]))
        lbl = jiops.flip(lbl, jnp.asarray(p.flips[b]))
        out_i.append(img)
        out_l.append(lbl)
    if cfg.intensity:
        for i, b in enumerate(p.gibbs_index):
            out_i[b] = jiops.gibbs_noise(out_i[b], jnp.asarray(p.gibbs_alpha[i]))
        for i, b in enumerate(p.spike_index):
            out_i[b] = jiops.kspace_spike(out_i[b], jnp.asarray(p.spike_loc[i]),
                                          jnp.asarray(p.spike_intensity[i]))
    assert nd == out_l[0].ndim - 1
    return (np.stack([np.moveaxis(np.asarray(i), 0, -1) for i in out_i]),
            np.stack([np.asarray(lb[0]) for lb in out_l]))


def _dense(cfg: AugmentConfig) -> AugmentConfig:
    """Gates that fire often, so that a small batch exercises every op."""
    return dataclasses.replace(cfg, contrast_prob=0.6, hist_shift_prob=0.6, bias_prob=0.6,
                               flip_prob=0.5, gibbs_prob=0.4, spike_prob=0.4)


@pytest.mark.parametrize("cfg,channels,seed", [
    (dataclasses.replace(_dense(FULL), interp_bf16=False), 1, 0),
    (dataclasses.replace(_dense(FULL), interp_bf16=False), 2, 1),
    (dataclasses.replace(FULL, interp_bf16=False), 1, 2),  # the default probabilities
    (dataclasses.replace(_dense(FULL), interp_bf16=False, spatial_subset=False), 1, 3),
    (AugmentConfig(spatial=True, interp_bf16=False), 1, 4),
    (_dense(AugmentConfig(intensity=True)), 1, 5),
], ids=["dense", "two-channels", "defaults", "independent-gates", "spatial-only",
        "intensity-only"])
def test_apply_matches_jax_replay(cfg, channels, seed):
    margin = (24, 24, 24) if cfg.spatial else (16, 16, 16)
    images, labels = _batch(seed, 8, margin, channels)
    params = taug.draw_params(torch.Generator().manual_seed(seed), cfg, 8, 3)
    out_shape = (16, 16, 16)
    got_i, got_l = taug.apply_params(torch.from_numpy(images), torch.from_numpy(labels),
                                     params, cfg, out_shape)
    want_i, want_l = _jax_replay(images, labels, params, cfg, out_shape)
    assert got_i.shape == want_i.shape == (8, 16, 16, 16, channels)
    assert got_l.dtype == torch.uint8
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    assert np.abs(got_i.numpy() - want_i).max() <= 1e-4 * np.abs(want_i).max()


def test_apply_bf16_interpolation_matches_jax_replay():
    """With ``interp_bf16`` the f32 image's chain rounds weights and samples to
    bf16 in both packages: within one bf16 ulp of max|ref|."""
    cfg = AugmentConfig(spatial=True)
    images, labels = _batch(6)
    params = taug.draw_params(torch.Generator().manual_seed(6), cfg, 8, 3)
    got_i, got_l = taug.apply_params(torch.from_numpy(images), torch.from_numpy(labels),
                                     params, cfg, (16, 16, 16))
    want_i, want_l = _jax_replay(images, labels, params, cfg, (16, 16, 16))
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    assert np.abs(got_i.numpy() - want_i).max() <= 2.0 ** -8 * np.abs(want_i).max()


def test_apply_2d_matches_jax_replay():
    cfg = dataclasses.replace(_dense(FULL), interp_bf16=False)
    images, labels = _batch(7, 6, (28, 24), 1)
    params = taug.draw_params(torch.Generator().manual_seed(7), cfg, 6, 2)
    assert params.angles.shape[1] == 1
    got_i, got_l = taug.apply_params(torch.from_numpy(images), torch.from_numpy(labels),
                                     params, cfg, (18, 16))
    want_i, want_l = _jax_replay(images, labels, params, cfg, (18, 16))
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    assert np.abs(got_i.numpy() - want_i).max() <= 1e-4 * np.abs(want_i).max()


def test_exact_subset_counts_at_the_defaults():
    """5 of 8 samples take the rotation + zoom (P[any] = 1 - 0.8^4 = 0.59),
    2 of 8 Gibbs, 2 of 8 the spike, every step, each a set of distinct samples."""
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        p = taug.draw_params(gen, FULL, 8, 3)
        for idx, n in ((p.spatial_index, 5), (p.gibbs_index, 2), (p.spike_index, 2)):
            assert len(idx) == n == len(set(idx.tolist())) and idx.min() >= 0 and idx.max() < 8
        assert p.angles.shape == (5, 3) and p.zoom.shape == (5,)
        # members of the subset are active: some rotation or a zoom
        assert ((p.angles != 0).any(1) | (p.zoom != 1)).all()
    assert jaug._subset_count(1 - 0.8 ** 4, 8) == 5 == taug._subset_count(1 - 0.8 ** 4, 8)


def test_pattern_table_matches_jax_and_draw_frequencies():
    for n_rot in (1, 3):
        pats, cdf = taug._spatial_pattern_table(FULL, n_rot)
        jp, jc = jaug._spatial_pattern_table(jaug.AugmentConfig(spatial=True), n_rot)
        np.testing.assert_array_equal(pats, jp)
        np.testing.assert_array_equal(cdf, jc)
    # frequencies of the drawn (rotation mask, zoom) patterns over many steps
    pats, cdf = taug._spatial_pattern_table(FULL, 3)
    probs = np.diff(np.concatenate([[0.0], cdf, [1.0]]))
    gen = torch.Generator().manual_seed(1)
    counts = np.zeros(len(pats))
    n_steps = 400
    for _ in range(n_steps):
        p = taug.draw_params(gen, FULL, 8, 3)
        bits = np.concatenate([p.angles != 0, (p.zoom != 1)[:, None]], 1).astype(np.float32)
        for row in bits:
            counts[(pats == row).all(1).argmax()] += 1
    freq = counts / counts.sum()
    # 2000 draws: binomial standard deviation below 0.011 for every pattern
    assert np.abs(freq - probs).max() < 0.04
    # every sample is in the subset equally often: 5 / 8 of the steps
    hits = np.zeros(8)
    gen = torch.Generator().manual_seed(2)
    for _ in range(n_steps):
        hits[taug.draw_params(gen, FULL, 8, 3).spatial_index] += 1
    assert np.abs(hits / n_steps - 5 / 8).max() < 0.1


def test_draw_ranges():
    cfg = _dense(FULL)
    gen = torch.Generator().manual_seed(3)
    for _ in range(30):
        p = taug.draw_params(gen, cfg, 8, 3)
        assert np.abs(p.angles).max() <= cfg.rotate_range
        z = p.zoom[p.zoom != 1]
        assert ((z >= cfg.zoom_range[0]) & (z <= cfg.zoom_range[1])).all()
        assert ((p.contrast_gamma >= 0.5) & (p.contrast_gamma <= 4.5)).all()
        assert np.abs(p.hist_noise).max() <= 0.45 / 9 + 1e-7
        assert ((p.bias_coeff >= 0) & (p.bias_coeff <= 0.1)).all()
        assert p.bias_coeff.shape == (8, 20)
        assert ((p.gibbs_alpha >= 0) & (p.gibbs_alpha <= 1)).all()
        assert ((p.spike_loc >= 0.55) & (p.spike_loc <= 0.95)).all()
        assert ((p.spike_intensity >= 0.95) & (p.spike_intensity <= 1.10)).all()
        assert p.flips.shape == (8, 3) and p.flips.dtype == bool
        for f in dataclasses.fields(p):
            assert isinstance(getattr(p, f.name), np.ndarray)  # plain numpy throughout


def test_independent_gates_and_batch_of_one():
    cfg = dataclasses.replace(FULL, spatial_subset=False)
    p = taug.draw_params(torch.Generator().manual_seed(4), cfg, 8, 3)
    np.testing.assert_array_equal(p.spatial_index, np.arange(8))
    assert p.angles.shape == (8, 3)
    p1 = taug.draw_params(torch.Generator().manual_seed(4), FULL, 1, 3)
    np.testing.assert_array_equal(p1.spatial_index, [0])  # a batch of one has no subset


def test_same_seed_same_batch_and_inputs_untouched():
    images, labels = _batch(8)
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    cfg = _dense(FULL)
    a = taug.augment_batch(ti, tl, torch.Generator().manual_seed(5), cfg, (16, 16, 16))
    b = taug.augment_batch(ti, tl, torch.Generator().manual_seed(5), cfg, (16, 16, 16))
    c = taug.augment_batch(ti, tl, torch.Generator().manual_seed(6), cfg, (16, 16, 16))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    np.testing.assert_array_equal(ti.numpy(), images)  # the margin batch is not written
    np.testing.assert_array_equal(tl.numpy(), labels)
    assert torch.isfinite(a[0]).all()


def test_pairing_kept_and_labels_keep_their_values():
    """Every output label map still belongs to its image (the image's bright
    core lies where the label is high) and holds only the input's class ids."""
    images, labels = _batch(9)
    images = labels[..., None].astype(np.float32)  # the image is its label map
    cfg = AugmentConfig(spatial=True, interp_bf16=False, flip_prob=0.5)
    out_i, out_l = taug.augment_batch(torch.from_numpy(images), torch.from_numpy(labels),
                                      torch.Generator().manual_seed(7), cfg, (16, 16, 16))
    assert set(np.unique(out_l.numpy())) <= set(np.unique(labels))
    # linear interpolation of each map against the nearest-neighbour copies:
    # nearest to its own, whatever the subset permutation did
    dist = (out_i[:, None, ..., 0] - out_l[None].float()).abs().mean((2, 3, 4))
    assert (dist.argmin(1) == torch.arange(8)).all()
    assert dist.diagonal().max() < 0.25


def test_no_augmentation_is_the_flips_alone():
    """spatial=False, intensity=False: one (B, nd) uniform draw, as before the
    augmentation was ported, flips image and label together."""
    images, labels = _batch(10, margin=(16, 16, 16))
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    cfg = AugmentConfig(flip_prob=0.5)
    got_i, got_l = taug.augment_batch(ti, tl, torch.Generator().manual_seed(8), cfg)
    do_flip = (torch.rand((8, 3), generator=torch.Generator().manual_seed(8)) < 0.5).tolist()
    for b in range(8):
        dims = [a for a in range(3) if do_flip[b][a]]
        assert torch.equal(got_i[b], ti[b].flip(dims) if dims else ti[b])
        assert torch.equal(got_l[b], tl[b].flip(dims) if dims else tl[b])
