"""The labels' composed-affine gather and the one-axis Paeth rotation against
the JAX package's.

``rotate_zoom_nn_gather`` sums its positions in f32 in the JAX function's
order; XLA's CPU backend may contract the products and sums into FMAs, so a
position within a few ulp of a half-integer can round the other way there.
Every voxel where the two packages differ must therefore sit at such a tie:
its position, recomputed in f64, lies within ``TIE`` voxel of a half-integer
along some axis (f32 positions of magnitude below 100 carry ~1e-5 of
rounding). Everywhere else the labels are equal. ``AugmentConfig(
label_affine_gather=True)`` is compared through ``apply_params`` with the JAX
replay of ``test_torch_augment.py`` (images) and the JAX gather (labels), on
the full-batch and the exact-count subset paths.
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
from segmantic_tpu_torch.ops import fused_shear
from segmantic_tpu_torch.ops import shear_resample as tsr
from segmantic_tpu_torch.train import augment as taug
from segmantic_tpu_torch.train.augment import AugmentConfig
from tests.test_torch_augment import _batch, _dense, _jax_replay

TIE = 1e-4


def tie_mask(in_shape, out_shape, angles, zoom) -> np.ndarray:
    """Output voxels whose f64 source position lies within ``TIE`` of a
    half-integer along some axis (where f32 rounding may pick either side)."""
    nd = len(in_shape)
    inv = tsr.rotation_matrix(nd, np.asarray(angles, np.float64)).T / float(zoom)
    grids = np.meshgrid(*[np.arange(o) + (n - o) // 2 - (n - 1) / 2.0
                          for n, o in zip(in_shape, out_shape)], indexing="ij")
    near = np.zeros(tuple(out_shape), bool)
    for a in range(nd):
        pos = sum(inv[a, b] * grids[b] for b in range(nd)) + (in_shape[a] - 1) / 2.0
        near |= np.abs(pos - np.floor(pos) - 0.5) < TIE
    return near


def _labels(rng, shape, dtype, classes=7):
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    lbl = np.zeros(shape, np.int64)
    for k in range(1, classes):
        c = rng.uniform(-0.3, 0.3, len(shape)).reshape((-1,) + (1,) * len(shape))
        lbl[((grid - c) ** 2).sum(0) < 0.9 * (1 - k / classes)] = k
    return lbl.astype(dtype)


def _jax_gather(x, angles, zoom, out_shape):
    return np.asarray(jsr.rotate_zoom_nn_gather(
        jnp.asarray(x), jnp.asarray(angles, jnp.float32), jnp.asarray(zoom, jnp.float32),
        tuple(out_shape)))


def _check_ties(got, want, in_shape, out_shape, angles, zoom):
    """``got`` equals ``want`` except at ties; returns the count of ties that differ."""
    diff = np.any(got != want, axis=0) if got.ndim > len(out_shape) else got != want
    if diff.any():
        near = tie_mask(in_shape, out_shape, angles, zoom)
        assert near[diff].all(), f"{int((diff & ~near).sum())} voxels differ off a tie"
    return int(diff.sum())


@pytest.mark.parametrize("in_shape,out_shape,zoom_range", [
    ((20, 22, 18), (12, 14, 10), (0.7, 0.95)),
    ((20, 22, 18), (12, 14, 10), (1.05, 1.4)),
    ((16, 15, 17), (16, 15, 17), (0.8, 1.3)),
    ((30, 26), (18, 16), (0.7, 0.95)),
    ((30, 26), (18, 16), (1.05, 1.4)),
], ids=["3d-zoom-in", "3d-zoom-out", "3d-same-shape", "2d-zoom-in", "2d-zoom-out"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_gather_matches_jax_but_at_ties(in_shape, out_shape, zoom_range, dtype):
    rng = np.random.default_rng(len(in_shape) * 10 + int(zoom_range[0] * 10))
    nd, batch = len(in_shape), 4
    n_rot = 3 if nd == 3 else 1
    x = np.stack([_labels(rng, in_shape, dtype)[None] for _ in range(batch)])
    angles = rng.uniform(-0.4, 0.4, (batch, n_rot)).astype(np.float32)
    angles[0] = 0.0  # one sample without rotation
    zoom = rng.uniform(*zoom_range, batch).astype(np.float32)
    got = tsr.rotate_zoom_nn_gather(torch.from_numpy(x), torch.from_numpy(angles),
                                    torch.from_numpy(zoom), out_shape)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (batch, 1, *out_shape)
    for s in range(batch):
        want = _jax_gather(x[s], angles[s], zoom[s], out_shape)
        assert want.dtype == dtype
        _check_ties(got[s].numpy(), want, in_shape, out_shape, angles[s], zoom[s])
    # outside the frame: zeros; the identity: an exact center crop
    ident = tsr.rotate_zoom_nn_gather(torch.from_numpy(x), torch.zeros(batch, n_rot),
                                      torch.ones(batch), out_shape)
    np.testing.assert_array_equal(ident.numpy(), tsr.center_crop(torch.from_numpy(x),
                                                                 out_shape).numpy())


def test_gather_identity_and_outside_are_exact():
    """A zoom-out leaves the frame's outside at 0 in both packages; with odd
    extents, zoom 0.5 and no rotation every position is an integer (no tie),
    and output voxel o reads input 2 (o - c) + c."""
    x = (np.arange(1, 1 + 9 * 11 * 13) % 250).astype(np.uint8).reshape(1, 1, 9, 11, 13)
    got = tsr.rotate_zoom_nn_gather(torch.from_numpy(x), torch.zeros(1, 3),
                                    torch.tensor([0.5]), (9, 11, 13)).numpy()[0]
    want = _jax_gather(x[0], np.zeros(3, np.float32), np.float32(0.5), (9, 11, 13))
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0] == 0).all() and got[0, 3, 5, 6] == x[0, 0, 2, 5, 6]
    assert got[0, 4, 6, 7] == x[0, 0, 4, 7, 8]
    # even extents: exact half-integer positions, the same in both packages'
    # f32, rounded up by floor(pos + 0.5) (round-half-even would not)
    y = (np.arange(1, 1 + 10 * 12 * 8) % 250).astype(np.uint8).reshape(1, 1, 10, 12, 8)
    got = tsr.rotate_zoom_nn_gather(torch.from_numpy(y), torch.zeros(1, 3),
                                    torch.tensor([0.5]), (10, 12, 8)).numpy()[0]
    np.testing.assert_array_equal(got, _jax_gather(y[0], np.zeros(3, np.float32),
                                                   np.float32(0.5), (10, 12, 8)))
    # output (5, 6, 4) reads (5.5, 6.5, 4.5) -> (6, 7, 5); (4, 5, 3) reads (3.5, 4.5, 2.5)
    assert got[0, 5, 6, 4] == y[0, 0, 6, 7, 5] and got[0, 4, 5, 3] == y[0, 0, 4, 5, 3]


@pytest.mark.parametrize("nd,axis", [(3, 0), (3, 1), (3, 2), (2, 0)])
def test_rotate_pass_matches_jax(nd, axis):
    """Order 1 within 1e-5 * max|ref| (f32 sums), order 0 equal."""
    rng = np.random.default_rng(30 + nd + axis)
    shape = (14, 13, 12) if nd == 3 else (20, 17)
    img = rng.standard_normal((3, 2) + shape).astype(np.float32)
    lbl = np.stack([_labels(rng, shape, np.uint8)[None] for _ in range(3)])
    angle = np.array([0.3, -0.25, 0.0], np.float32)
    got_i = tsr.rotate_pass(torch.from_numpy(img), axis, torch.from_numpy(angle), 1)
    got_l = tsr.rotate_pass(torch.from_numpy(lbl), axis, torch.from_numpy(angle), 0)
    assert got_l.dtype == torch.uint8
    for s in range(3):
        want_i = np.asarray(jsr.rotate_pass(jnp.asarray(img[s]), axis, jnp.float32(angle[s]), 1))
        want_l = np.asarray(jsr.rotate_pass(jnp.asarray(lbl[s]), axis, jnp.float32(angle[s]), 0))
        assert np.abs(got_i[s].numpy() - want_i).max() <= 1e-5 * np.abs(want_i).max()
        np.testing.assert_array_equal(got_l[s].numpy(), want_l)
    # a scalar angle is every sample's
    np.testing.assert_array_equal(
        tsr.rotate_pass(torch.from_numpy(lbl), axis, 0.3, 0)[0].numpy(), got_l[0].numpy())


def test_augment_config_takes_label_affine_gather():
    """The field exists in both packages, with the same default."""
    assert AugmentConfig(label_affine_gather=True).label_affine_gather
    assert jaug.AugmentConfig(label_affine_gather=True).label_affine_gather
    assert AugmentConfig().label_affine_gather is jaug.AugmentConfig().label_affine_gather \
        is False
    assert [f.name for f in dataclasses.fields(AugmentConfig)] == [
        f.name for f in dataclasses.fields(jaug.AugmentConfig)]


def _jax_labels(labels, p: taug.AugmentParams, out_shape):
    """The JAX package's label path with ``label_affine_gather``: the gather
    for the spatial samples, the center crop for the rest, then the flips."""
    spatial = {} if p.spatial_index is None else {int(s): i for i, s in
                                                  enumerate(p.spatial_index)}
    out = []
    for b in range(labels.shape[0]):
        lbl = jnp.asarray(labels[b])[None]
        if b in spatial:
            i = spatial[b]
            lbl = jsr.rotate_zoom_nn_gather(lbl, jnp.asarray(p.angles[i]),
                                            jnp.asarray(p.zoom[i]), out_shape)
        lbl = jiops.flip(jsr.center_crop(lbl, out_shape), jnp.asarray(p.flips[b]))
        out.append(np.asarray(lbl[0]))
    return np.stack(out)


@pytest.mark.parametrize("cfg,seed", [
    (dataclasses.replace(_dense(AugmentConfig(spatial=True)), interp_bf16=False,
                         label_affine_gather=True), 0),
    (dataclasses.replace(_dense(AugmentConfig(spatial=True)), interp_bf16=False,
                         label_affine_gather=True, spatial_subset=False), 1),
], ids=["subset", "full-batch"])
def test_apply_with_label_gather_matches_jax(cfg, seed, monkeypatch):
    """Labels against the JAX gather (ties only), images against the JAX
    replay (1e-4 * max|ref|, as in ``test_torch_augment.py``); the labels run
    no shear group."""
    images, labels = _batch(seed, 8, (24, 24, 24), 1)
    params = taug.draw_params(torch.Generator().manual_seed(seed), cfg, 8, 3)
    groups = []
    real = fused_shear.shear_group
    monkeypatch.setattr(fused_shear, "shear_group",
                        lambda x, *a, **k: groups.append(x.dtype) or real(x, *a, **k))
    out_shape = (16, 16, 16)
    got_i, got_l = taug.apply_params(torch.from_numpy(images), torch.from_numpy(labels),
                                     params, cfg, out_shape)
    assert groups and all(d.is_floating_point for d in groups)  # image groups only
    want_i, _ = _jax_replay(images, labels, params, cfg, out_shape)
    want_l = _jax_labels(labels, params, out_shape)
    assert got_l.dtype == torch.uint8 and got_l.shape == want_l.shape
    assert np.abs(got_i.numpy() - want_i).max() <= 1e-4 * np.abs(want_i).max()
    spatial = {int(s): i for i, s in enumerate(params.spatial_index)}
    for b in range(8):
        if b not in spatial:
            np.testing.assert_array_equal(got_l[b].numpy(), want_l[b])
            continue
        i = spatial[b]
        # the tie mask lives in the gather's frame: undo the flips first
        axes = [a for a in range(3) if params.flips[b][a]]
        g, w = np.flip(got_l[b].numpy(), axes), np.flip(want_l[b], axes)
        _check_ties(g, w, (24, 24, 24), out_shape, params.angles[i], params.zoom[i])


def test_augment_batch_with_label_gather_keeps_classes():
    """``augment_batch`` draws and applies with the gather: shapes, the u8
    dtype, and only classes of the input."""
    cfg = AugmentConfig(spatial=True, intensity=True, label_affine_gather=True,
                        rotate_prob=0.9, zoom_prob=0.9)
    images, labels = _batch(9, 4, (20, 20, 20), 1)
    out_i, out_l = taug.augment_batch(torch.from_numpy(images), torch.from_numpy(labels),
                                      torch.Generator().manual_seed(9), cfg, (12, 12, 12))
    assert out_i.shape == (4, 12, 12, 12, 1) and out_l.shape == (4, 12, 12, 12)
    assert out_l.dtype == torch.uint8
    assert set(np.unique(out_l.numpy())) <= set(np.unique(labels))
