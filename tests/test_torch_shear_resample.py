"""The port's shear-decomposed rotation + zoom against the JAX package's.

Same numpy-seeded inputs through ``segmantic_tpu.ops.shear_resample`` (per
sample, on the CPU) and ``segmantic_tpu_torch.ops.shear_resample`` (batched,
per-sample coefficients; on the CPU the rotation groups run their plain
version). Tolerances: order 0 and the pass lists / extent schedules are
equal; order 1 in f32 within 1e-5 * max|ref| (the two matrix products sum
their two nonzero terms with or without a fused multiply-add); order 1 with
``bf16=True`` within one bf16 ulp of max|ref| (2^-8; measured equal here: two
products of bf16 values are exact in f32).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops import shear_resample as jsr
from segmantic_tpu_torch.ops import fused_shear
from segmantic_tpu_torch.ops import shear_resample as tsr
from segmantic_tpu_torch.ops.resample import resample_affine_np

MODES = [(1, False), (1, True), (0, False)]  # (order, bf16)
BF16_ULP = 2.0 ** -8


def _inputs(seed, shape, samples=3, channels=2, order=1):
    rng = np.random.default_rng(seed)
    if order == 0:
        return rng.integers(0, 7, (samples, 1) + tuple(shape)).astype(np.uint8)
    return rng.standard_normal((samples, channels) + tuple(shape)).astype(np.float32)


def _check(got: torch.Tensor, want: np.ndarray, order: int, bf16: bool):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        tol = (BF16_ULP if bf16 else 1e-5) * np.abs(want).max()
        assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("order,bf16", MODES)
@pytest.mark.parametrize("shape,a,b,out_extent,zoom,frame", [
    ((10, 12, 14), 0, 1, None, False, None),
    ((10, 12, 14), 2, 0, 8, False, None),  # shrinking window, minor axis sheared
    ((11, 12, 13), 1, 2, 8, True, 16),  # folded zoom about a larger frame
    ((16, 18), 0, 1, 12, True, 16),  # 2D
])
def test_shear_pass_matches_jax(shape, a, b, out_extent, zoom, frame, order, bf16):
    x = _inputs(1, shape, order=order)
    rng = np.random.default_rng(2)
    s = rng.uniform(-0.4, 0.4, x.shape[0]).astype(np.float32)
    z = rng.uniform(0.8, 1.3, x.shape[0]).astype(np.float32) if zoom else None
    got = tsr.shear_pass(torch.from_numpy(x), a, b, torch.from_numpy(s), order, out_extent,
                         bf16, zoom=None if z is None else torch.from_numpy(z),
                         frame_extent=frame)
    want = np.stack([np.asarray(jsr.shear_pass(
        jnp.asarray(x[i]), a, b, jnp.asarray(s[i]), order, out_extent, bf16,
        zoom=None if z is None else jnp.asarray(z[i]), frame_extent=frame))
        for i in range(x.shape[0])])
    _check(got, want, order, bf16)


@pytest.mark.parametrize("order,bf16", MODES)
@pytest.mark.parametrize("shape,axis,out_extent,frame", [
    ((10, 12, 14), 1, None, None), ((10, 12, 14), 2, 10, 18), ((9, 11), 0, 7, None),
])
def test_scale_pass_matches_jax(shape, axis, out_extent, frame, order, bf16):
    x = _inputs(3, shape, order=order)
    z = np.random.default_rng(4).uniform(0.8, 1.3, x.shape[0]).astype(np.float32)
    got = tsr.scale_pass(torch.from_numpy(x), axis, torch.from_numpy(z), order, out_extent,
                         bf16, frame_extent=frame)
    want = np.stack([np.asarray(jsr.scale_pass(
        jnp.asarray(x[i]), axis, jnp.asarray(z[i]), order, out_extent, bf16,
        frame_extent=frame)) for i in range(x.shape[0])])
    _check(got, want, order, bf16)


@pytest.mark.parametrize("order,bf16", MODES)
@pytest.mark.parametrize("shape,out_shape", [
    ((20, 22, 24), (12, 12, 14)), ((18, 18, 18), None), ((16, 20), (10, 12)),
    ((17, 16, 19), (11, 11, 11)),  # out_shape raised to the frame's parity
])
def test_rotate_zoom_shear_matches_jax(shape, out_shape, order, bf16):
    x = _inputs(5, shape, order=order)
    rng = np.random.default_rng(6)
    n_rot = 3 if len(shape) == 3 else 1
    angles = rng.uniform(-0.4, 0.4, (x.shape[0], n_rot)).astype(np.float32)
    angles[0, 0] = 0.0  # an inactive rotation
    zoom = rng.uniform(0.8, 1.3, x.shape[0]).astype(np.float32)
    zoom[1] = 1.0
    got = tsr.rotate_zoom_shear(torch.from_numpy(x), torch.from_numpy(angles),
                                torch.from_numpy(zoom), order, out_shape, 0.4, 0.8, bf16)
    want = np.stack([np.asarray(jsr.rotate_zoom_shear(
        jnp.asarray(x[i]), jnp.asarray(angles[i]), jnp.asarray(zoom[i]), order, out_shape,
        0.4, 0.8, bf16)) for i in range(x.shape[0])])
    _check(got, want, order, bf16)
    if out_shape is not None:
        crop = tsr.center_crop(got, out_shape).numpy()
        ref = np.stack([np.asarray(jsr.center_crop(jnp.asarray(w), out_shape)) for w in want])
        assert crop.shape == ref.shape == x.shape[:2] + tuple(out_shape)


@pytest.mark.parametrize("nd,n_rot", [(2, 1), (3, 3), (3, 1)])
def test_pass_lists_equal_jax(nd, n_rot):
    assert tsr._pass_list(nd, n_rot) == jsr._pass_list(nd, n_rot)
    assert tsr._folded_pass_list(nd, n_rot) == jsr._folded_pass_list(nd, n_rot)


@pytest.mark.parametrize("full,out_shape,angle_max,zoom_min", [
    ((144, 144, 144), (96, 96, 96), 0.4, 0.8),  # the flagship's margin patch
    ((24, 24, 24), (16, 16, 16), 0.4, 0.8), ((40, 37, 33), (20, 20, 21), 0.3, 1.0),
    ((30, 28), (16, 16), 0.4, 0.8),
])
def test_extent_schedule_equals_jax(full, out_shape, angle_max, zoom_min):
    nd = len(full)
    passes, divz = jsr._folded_pass_list(nd, 3 if nd == 3 else 1)
    want = jsr._extent_schedule(full, out_shape, passes, angle_max, zoom_min, divz)
    assert tsr._extent_schedule(full, out_shape, passes, angle_max, zoom_min, divz) == want
    _, _, extents, groups = tsr.chain_plan(full, 3 if nd == 3 else 1, out_shape, angle_max,
                                           zoom_min)
    assert extents == want
    assert [ext for _, _, specs in groups for _, _, ext in specs] == want[:3 * len(groups)]


def test_flagship_groups_are_the_documented_ones():
    """144^3 -> 96^3 at the default bounds: group 0 keeps every extent, groups
    1 and 2 fold the zoom and shrink to 96."""
    _, _, _, groups = tsr.chain_plan((144,) * 3, 3, (96,) * 3, 0.4, 0.8)
    assert groups == [
        (1, 2, ((False, None, 144), (False, None, 144), (False, None, 144))),
        (0, 2, ((False, None, 144), (True, 144, 96), (False, None, 144))),
        (0, 1, ((False, None, 144), (True, 144, 96), (True, 144, 96))),
    ]


def test_rotation_matrix_matches_jax():
    angles = np.asarray([0.3, -0.22, 0.15], np.float32)
    np.testing.assert_allclose(tsr.rotation_matrix(3, angles),
                               np.asarray(jsr.rotation_matrix(3, jnp.asarray(angles))),
                               atol=1e-6)
    np.testing.assert_allclose(tsr.rotation_matrix(2, angles[:1]),
                               np.asarray(jsr.rotation_matrix(2, jnp.asarray(angles[:1]))),
                               atol=1e-6)


def _smooth_blob(shape, seed=0):
    rng = np.random.default_rng(seed)
    coords = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    x = np.zeros(shape)
    for _ in range(4):
        c = rng.uniform(-0.5, 0.5, len(shape))
        w = rng.uniform(0.2, 0.5)
        x += np.exp(-sum((g - ci) ** 2 for g, ci in zip(coords, c)) / w ** 2)
    return x[None].astype(np.float32)  # (1, *shape)


def test_rotation_zoom_matches_affine_gather():
    """The full chain (3 rotations then the isotropic zoom, about the center)
    equals the ideal affine gather in = Rot.T @ (out - c) / z + c: guards the
    zoom-fold algebra. Limits as the JAX package's own oracle test (nine
    interpolating passes smooth slightly more than one gather)."""
    shape = (32, 32, 32)
    x = _smooth_blob(shape, seed=11)
    angles = np.asarray([0.3, -0.22, 0.15], np.float32)
    z = 1.2
    got = tsr.rotate_zoom_shear(torch.from_numpy(x)[None], torch.from_numpy(angles)[None],
                                torch.tensor([z]), order=1)[0].numpy()
    rot = tsr.rotation_matrix(3, angles)
    center = (np.asarray(shape) - 1) / 2
    m = np.zeros((3, 4))
    m[:, :3] = rot.T / z
    m[:, 3] = center - rot.T @ center / z
    want = resample_affine_np(x, m, shape, order=1)
    core = (slice(0, 1),) + (slice(8, 24),) * 3
    assert np.abs(got[core] - want[core]).max() < 0.15
    assert np.corrcoef(got[core].ravel(), want[core].ravel())[0, 1] > 0.995


@pytest.mark.parametrize("order,bf16", MODES)
@pytest.mark.parametrize("group", [0, 1, 2])
def test_shear_group_plain_is_three_jax_passes(group, order, bf16):
    """One rotation group of the shrinking, zoom-folded chain against the
    three JAX ``shear_pass`` calls it stands for."""
    full, out_shape = (20, 22, 24), (12, 12, 14)
    passes, divz, extents, groups = tsr.chain_plan(full, 3, out_shape, 0.4, 0.8)
    # the group's input has the extents the earlier groups left
    shape = list(full)
    for i in range(3 * group):
        shape[passes[i][1]] = extents[i]
    x = _inputs(7 + group, shape, order=order)
    rng = np.random.default_rng(8)
    angles = rng.uniform(-0.4, 0.4, (x.shape[0], 3)).astype(np.float32)
    zoom = rng.uniform(0.8, 1.3, x.shape[0]).astype(np.float32)
    coef = tsr.shear_coefficients(torch.from_numpy(angles), torch.from_numpy(zoom), passes,
                                  divz)[:, 3 * group: 3 * group + 3]
    a_axis, b_axis, specs = groups[group]
    got = fused_shear.shear_group(torch.from_numpy(x), a_axis, b_axis, coef,
                                  torch.from_numpy(zoom), specs, order, bf16)
    want = []
    for i in range(x.shape[0]):
        y = jnp.asarray(x[i])
        for j in range(3):
            kind, a, b, _ = passes[3 * group + j]
            y = jsr.shear_pass(y, a, b, jnp.asarray(coef[i, j].item()), order,
                               extents[3 * group + j], bf16,
                               zoom=jnp.asarray(zoom[i]) if kind == "shz" else None,
                               frame_extent=full[a] if kind == "shz" else None)
        want.append(np.asarray(y))
    _check(got, np.stack(want), order, bf16)


def test_shear_group_checks_its_arguments():
    x = torch.zeros(2, 1, 8, 8, 8)
    specs = ((False, None, None),) * 3
    with pytest.raises(ValueError, match="coef"):
        fused_shear.shear_group(x, 0, 1, torch.zeros(2, 2), torch.ones(2), specs, 1)
    with pytest.raises(ValueError, match="order"):
        fused_shear.shear_group(x, 0, 1, torch.zeros(2, 3), torch.ones(2), specs, 2)
