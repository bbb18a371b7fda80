"""Shear-decomposed rotation + zoom (the augmentation's geometry).

Port of ``segmantic_tpu/ops/shear_resample.py``. A content rotation is three
shears (Paeth: ``R(t) = Shear_a(-tan t/2) . Shear_b(sin t) . Shear_a(-tan
t/2)``); each pass shifts 1D lines by per-line fractional offsets, order 1
interpolates between two neighbours and order 0 picks one (labels move as
exact copies). The trailing isotropic zoom folds into the last shear per axis
(:func:`_folded_pass_list`), so a 3D rotation + zoom is nine passes in three
groups of three, one group per rotation plane; with ``out_shape`` every pass
emits only the center window later passes need (:func:`_extent_schedule`).

This module is the plain version: the JAX package's banded interpolation
matrices and ``torch.einsum``, batched over samples with per-sample
coefficients (the JAX code is per sample under ``vmap``). Tensors are
``(S, C, *spatial)`` channel-first, coefficients ``(S,)``.
:func:`rotate_zoom_shear` sends each rotation group through
``ops.fused_shear.shear_group``, which on the card is one hand-written kernel
per group and on the CPU the three :func:`shear_pass` calls it stands for.

Numerics kept from the JAX code: positions in f32, the full-frame position
first and the integer window offset subtracted last (shrunk windows stay
bit-identical to the full frame); ``floor(pos + 0.5)`` for order 0; with
``bf16=True`` weights and samples are rounded to bf16 and their products
summed in f32; each pass's output is rounded to the carry dtype. Integer
labels are copied exactly (the JAX chain carries them in bf16, which is the
same up to 256 classes).

:func:`rotate_zoom_nn_gather` is the labels' other route
(``AugmentConfig.label_affine_gather``): the rotation + zoom composed into
one affine and one nearest-neighbour gather in the label's own dtype, plain
PyTorch on any device (an XLA gather in the JAX package, no Pallas kernel).
:func:`rotate_pass` is one Paeth rotation about one axis.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "rotation_matrix", "shear_pass", "shear_positions", "scale_pass", "rotate_zoom_shear",
    "center_crop", "shear_coefficients", "chain_plan", "rotate_zoom_nn_gather", "rotate_pass",
]


def _center(n: int) -> float:
    return (n - 1) / 2.0


def rotation_matrix(nd: int, angles) -> np.ndarray:
    """Compose per-axis content rotations (axis order 0,1,2) into one
    nd x nd matrix (float64 numpy): the matrix the shear chain factorizes."""
    angles = np.asarray(angles, np.float64)
    if nd == 2:
        c, s = np.cos(angles[0]), np.sin(angles[0])
        return np.array([[c, -s], [s, c]])
    rot = np.eye(3)
    for axis in range(3):
        a, b = [d for d in range(3) if d != axis]
        c, s = np.cos(angles[axis]), np.sin(angles[axis])
        m = np.eye(3)
        m[a, a], m[a, b], m[b, a], m[b, b] = c, -s, s, c
        rot = m @ rot
    return rot


def rotate_zoom_nn_gather(
    x: torch.Tensor,  # (S, C, *spatial)
    angles,  # (S, 3) or (S, 1) content rotation angles per axis
    zoom,  # (S,) isotropic content zoom
    out_shape: Sequence[int],
) -> torch.Tensor:
    """Direct composed-affine nearest-neighbour resample: the label twin of
    ``rotate_zoom_shear(order=0)`` + center crop, as one gather per sample.

    The shear chain rounds to the grid after every pass; composing the same
    rotation + zoom into one affine (``in = R.T @ (out - c) / z + c`` about
    the full-frame center) and rounding once is the resample MONAI's
    ``Rand{Rotate,Zoom}d(mode="nearest")`` applies to label maps (reference:
    src/segmantic/seg/monai_unet.py:187-205). The output window is
    center-aligned in the full frame (offset ``(n - m) // 2`` per axis, as
    the chain's), positions round by ``floor(pos + 0.5)``, zeros outside, and
    the gather stays in ``x``'s dtype (u8 labels move as u8).

    The affine is composed per sample on the CPU (:func:`rotation_matrix`
    in f64, rounded to f32 once) and sent to ``x``'s device in one copy that
    does not wait for the card, so every device gathers the same voxels. The
    positions are summed in f32 in the JAX function's order,
    ``sum_b inv[a, b] * grid_b + c``, each product and sum rounded on its
    own. The JAX function composes the rotation in f32 and XLA's CPU backend
    may contract the sums into FMAs, so a position within a few ulp of a
    half-integer can round the other way there.
    """
    nd = x.ndim - 2
    batch, in_shape = x.shape[0], tuple(x.shape[2:])
    out_shape = tuple(int(o) for o in out_shape)
    dev = x.device
    angles = torch.as_tensor(angles).detach().cpu().double().reshape(batch, -1).numpy()
    zoom = torch.as_tensor(zoom).detach().cpu().float().expand(batch).numpy()
    # in = rot.T @ (out - c) / z + c
    inv = np.stack([rotation_matrix(nd, a).T.astype(np.float32) / z
                    for a, z in zip(angles, zoom)])
    inv = torch.from_numpy(inv)
    if dev.type == "cuda":  # pinned, so the copy does not wait for the work queued before it
        inv = inv.pin_memory().to(dev, non_blocking=True)
    inv = inv.reshape((batch, nd, nd) + (1,) * nd)

    def axis_grid(a: int) -> torch.Tensor:
        g = (torch.arange(out_shape[a], dtype=torch.float32, device=dev)
             + float((in_shape[a] - out_shape[a]) // 2) - _center(in_shape[a]))
        return g.reshape((1,) + tuple(-1 if d == a else 1 for d in range(nd)))

    grids = [axis_grid(a) for a in range(nd)]
    strides = [1] * nd
    for a in range(nd - 2, -1, -1):
        strides[a] = strides[a + 1] * in_shape[a + 1]

    inside = torch.ones((batch,) + out_shape, dtype=torch.bool, device=dev)
    lin = torch.zeros((batch,) + out_shape, dtype=torch.int64, device=dev)
    for a in range(nd):
        pos = inv[:, a, 0] * grids[0]
        for b in range(1, nd):
            pos = pos + inv[:, a, b] * grids[b]
        pos = pos + _center(in_shape[a])
        i = torch.floor(pos + 0.5).to(torch.int64)
        inside &= (i >= 0) & (i <= in_shape[a] - 1)
        lin = lin + i.clamp(0, in_shape[a] - 1) * strides[a]

    flat = x.reshape(batch, x.shape[1], -1)
    idx = lin.reshape(batch, 1, -1).expand(-1, x.shape[1], -1)
    out = torch.gather(flat, 2, idx).reshape((batch, x.shape[1]) + out_shape)
    return torch.where(inside[:, None], out, torch.zeros((), dtype=x.dtype, device=dev))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _interp_matrix(pos: torch.Tensor, n_in: int, order: int) -> torch.Tensor:
    """Banded interpolation matrix W with W[..., o, u] the weight of input
    sample u for output position o (rows of out-of-range positions are 0)."""
    if order == 0:
        # floor(pos + 0.5), never round-half-even: nearest picks must not
        # flip under integer window offsets
        idx = torch.floor(pos + 0.5).to(torch.int64)
        valid = (idx >= 0) & (idx <= n_in - 1)
        return _one_hot(idx.clamp(0, n_in - 1), n_in) * valid[..., None]
    lo = torch.floor(pos).to(torch.int64).clamp(0, n_in - 2)
    frac = (pos - lo.to(torch.float32))[..., None]
    valid = ((pos >= 0) & (pos <= n_in - 1))[..., None]
    w = _one_hot(lo, n_in) * (1.0 - frac) + _one_hot(lo + 1, n_in) * frac
    return w * valid


def _restore_dtype(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if not dtype.is_floating_point:
        return torch.round(out).to(dtype)
    return out.to(dtype)


def _banded_matmul(w: torch.Tensor, x: torch.Tensor, spec: str, order: int,
                   bf16: bool) -> torch.Tensor:
    """The banded-interp einsum with an f32 result. With ``bf16`` (order 1)
    weights and samples are rounded to bf16 first; the products of two bf16
    values are exact in f32, so this equals a bf16 product with f32
    accumulation. Order 0 copies one sample per output (exact in f32 for
    integer ids below 2^24)."""
    if bf16 and order == 1:
        w = w.to(torch.bfloat16).to(torch.float32)
        x = x.to(torch.bfloat16)
    return torch.einsum(spec, w, x.to(torch.float32))


def _per_sample(v, batch: int, device) -> torch.Tensor:
    """A scalar or (S,) coefficient as an (S,) f32 tensor on ``device``."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return v.expand(batch) if v.ndim == 0 else v


def shear_positions(na: int, nb: int, m: int, s: torch.Tensor, zoom=None,
                    frame_extent: Optional[int] = None) -> torch.Tensor:
    """Input a-coordinates of a shear pass, (S, M, NB) f32: output index o of
    the center window of extent ``m`` on line ``b`` reads the line of extent
    ``na`` at ``[s, o, b]``. ``s`` and ``zoom`` are (S,) f32 tensors."""
    dev = s.device
    s = s[:, None, None]
    b_rel = torch.arange(nb, dtype=torch.float32, device=dev) - _center(nb)
    o_glob = torch.arange(m, dtype=torch.float32, device=dev) + float((na - m) // 2)
    if zoom is None:
        return o_glob[None, :, None] - s * b_rel[None, None, :]
    z = zoom[:, None, None]
    frame = na if frame_extent is None else frame_extent
    off_in = float((frame - na) // 2)
    c_f = _center(frame)
    o_full = o_glob + off_in
    pos_full = (o_full[None, :, None] - c_f) / z + c_f - s * b_rel[None, None, :]
    return pos_full - off_in


def shear_pass(
    x: torch.Tensor, a_axis: int, b_axis: int, s, order: int,
    out_extent: Optional[int] = None, bf16: bool = False,
    zoom=None, frame_extent: Optional[int] = None,
) -> torch.Tensor:
    """Content shear: the output line at (a, b) reads input a-coordinate
    ``a - s * (b - center_b)`` (about the volume center, zeros outside).

    ``x`` is (S, C, *spatial); ``a_axis``/``b_axis`` are spatial axis indices;
    ``s`` is per sample, (S,) or a scalar. ``out_extent`` (same parity as the
    input extent) emits only the center window along ``a_axis``.

    With ``zoom`` (per sample) the pass is the merged shear + scale map
    ``a_in = (a_out - c)/zoom + c - s*(b - c_b)`` about the full-frame center
    (``frame_extent``). The full-frame position is computed first and the
    integer window offset subtracted last."""
    batch = x.shape[0]
    a2, b2 = a_axis + 2, b_axis + 2
    na, nb = x.shape[a2], x.shape[b2]
    m = na if out_extent is None else min(out_extent, na)
    dev = x.device
    pos = shear_positions(
        na, nb, m, _per_sample(s, batch, dev),
        None if zoom is None else _per_sample(zoom, batch, dev), frame_extent)

    w = _interp_matrix(pos.transpose(1, 2), na, order)  # (S, NB, M, NA_in)
    letters = "cdefgh"[: x.ndim - 1]
    in_sub, out_sub = list(letters), list(letters)
    in_sub[a_axis + 1], in_sub[b_axis + 1] = "u", "b"
    out_sub[a_axis + 1], out_sub[b_axis + 1] = "o", "b"
    spec = f"sbou,s{''.join(in_sub)}->s{''.join(out_sub)}"
    return _restore_dtype(_banded_matmul(w, x, spec, order, bf16), x.dtype)


def scale_pass(
    x: torch.Tensor, axis: int, zoom, order: int,
    out_extent: Optional[int] = None, bf16: bool = False,
    frame_extent: Optional[int] = None,
) -> torch.Tensor:
    """Per-axis content zoom about the center: input coord =
    (out - c) / zoom + c, in the full frame when ``x`` is a center-aligned
    window of ``frame_extent``. ``x`` (S, C, *spatial), ``zoom`` per sample."""
    batch = x.shape[0]
    n = x.shape[axis + 2]
    m = n if out_extent is None else min(out_extent, n)
    frame = n if frame_extent is None else frame_extent
    off_in = (frame - n) // 2
    dev = x.device
    z = _per_sample(zoom, batch, dev)[:, None]

    o_full = torch.arange(m, dtype=torch.float32, device=dev) + float((n - m) // 2 + off_in)
    pos_full = (o_full[None, :] - _center(frame)) / z + _center(frame)
    pos = pos_full - float(off_in)
    w = _interp_matrix(pos, n, order)  # (S, M, N_in)
    letters = "cdefgh"[: x.ndim - 1]
    in_sub, out_sub = list(letters), list(letters)
    in_sub[axis + 1], out_sub[axis + 1] = "u", "o"
    spec = f"sou,s{''.join(in_sub)}->s{''.join(out_sub)}"
    return _restore_dtype(_banded_matmul(w, x, spec, order, bf16), x.dtype)


def _pass_list(nd: int, n_rot: int) -> List[Tuple[str, int, int, Tuple[int, int]]]:
    """Ordered (kind, a_axis, b_axis, (rot_axis, slot)) for the full chain.

    kind 'sh': shear of a by b; slot 0/2 are the tan-half shears, slot 1 the
    sin shear. kind 'sc': per-axis zoom (b_axis unused)."""
    passes: List[Tuple[str, int, int, Tuple[int, int]]] = []
    for axis in range(n_rot):
        if nd == 2:
            a, b = 0, 1
        else:
            a, b = [d for d in range(3) if d != axis]
        passes.append(("sh", a, b, (axis, 0)))
        passes.append(("sh", b, a, (axis, 1)))
        passes.append(("sh", a, b, (axis, 2)))
    for axis in range(nd):
        passes.append(("sc", axis, -1, (-1, -1)))
    return passes


def _folded_pass_list(nd: int, n_rot: int):
    """The shear chain with the trailing isotropic zoom folded into the last
    shear per a-axis (kind 'shz'), dropping the standalone scale passes.
    Moving the scale of axis a earlier past a shear conjugates it: every pass
    after a's fold point whose b-axis is a divides its coefficient by the
    zoom. Returns (passes, divz): 4-tuples like :func:`_pass_list` and the set
    of pass indices whose coefficient divides by zoom."""
    passes = [p for p in _pass_list(nd, n_rot) if p[0] == "sh"]
    divz: set = set()
    for axis in range(nd):
        occ = [i for i, p in enumerate(passes) if p[1] == axis]
        if not occ:  # an axis never sheared still needs its scale pass
            passes.append(("sc", axis, -1, (-1, -1)))
            continue
        i = occ[-1]
        passes[i] = ("shz",) + passes[i][1:]
        for j in range(i + 1, len(passes)):
            if passes[j][2] == axis:
                divz.add(j)
    return passes, divz


def _extent_schedule(
    full: Sequence[int],
    out_shape: Sequence[int],
    passes: List[Tuple[str, int, int, Tuple[int, int]]],
    angle_max: float,
    zoom_min: float,
    divz: Optional[set] = None,
) -> List[int]:
    """Static per-pass output extents, walked backward from ``out_shape``.

    A shear of a by b with |s| <= s_max needs input support
    need_a + 2*ceil(s_max * need_b / 2) + 2 (interp stencil + rounding); a
    zoom >= zoom_min needs need / zoom_min + 2. Extents keep the full frame's
    parity (center-aligned crops keep the exact center) and are capped at the
    full extent."""
    t_max = abs(math.tan(angle_max / 2.0))
    s_max = abs(math.sin(angle_max))
    zlo = min(zoom_min, 1.0)
    divz = divz or set()

    def with_parity(v: float, axis: int) -> int:
        n = int(math.ceil(v))
        if (n - full[axis]) % 2:
            n += 1
        return min(n, full[axis])

    need = [with_parity(o, ax) for ax, o in enumerate(out_shape)]
    out_extents = [0] * len(passes)
    for i in range(len(passes) - 1, -1, -1):
        kind, a, b, (_, slot) = passes[i]
        out_extents[i] = need[a]
        if kind == "sc":
            need[a] = with_parity(need[a] / zlo + 2, a)
        else:
            smax = s_max if slot == 1 else t_max
            if i in divz:  # coefficient divided by the (folded) zoom
                smax = smax / zlo
            reach = need[a] / zlo if kind == "shz" else need[a]
            need[a] = with_parity(reach + 2 * (smax * need[b] / 2.0 + 1), a)
    return out_extents


def shear_coefficients(angles: torch.Tensor, zoom: torch.Tensor, passes, divz
                       ) -> torch.Tensor:
    """The chain's per-sample, per-pass shear coefficients, (S, len(passes))
    f32: ``-tan(angle/2)`` for slots 0 and 2, ``sin(angle)`` for slot 1,
    divided by the zoom for the passes in ``divz`` (0 for 'sc' passes)."""
    angles = angles.to(torch.float32)
    zoom = zoom.to(torch.float32)
    tan_half, sin = -torch.tan(angles / 2.0), torch.sin(angles)
    cols = []
    for i, (kind, _, _, (rot_axis, slot)) in enumerate(passes):
        if kind == "sc":
            cols.append(torch.zeros_like(zoom))
            continue
        s = sin[:, rot_axis] if slot == 1 else tan_half[:, rot_axis]
        cols.append(s / zoom if i in divz else s)
    return torch.stack(cols, dim=1)


def chain_plan(full: Sequence[int], n_rot: int, out_shape: Optional[Sequence[int]] = None,
               angle_max: float = 0.0, zoom_min: float = 1.0):
    """The chain for a frame of extents ``full``: (passes, divz, extents,
    groups). ``groups[g]`` = (a_axis, b_axis, specs) is rotation group ``g`` as
    ``fused_shear.shear_group`` takes it: its plane and, per pass, (whether the
    zoom is folded in, the full-frame extent of the sheared axis or None, the
    pass's output extent or None)."""
    passes, divz = _folded_pass_list(len(full), n_rot)
    if out_shape is not None:
        extents = _extent_schedule(full, out_shape, passes, angle_max, zoom_min, divz)
    else:
        extents = [None] * len(passes)
    groups = []
    for g in range(n_rot):
        group = passes[3 * g: 3 * g + 3]
        specs = tuple(
            (kind == "shz", full[a] if kind == "shz" else None, extents[3 * g + j])
            for j, (kind, a, _, _) in enumerate(group)
        )
        groups.append((group[0][1], group[0][2], specs))
    return passes, divz, extents, groups


def rotate_zoom_shear(
    x: torch.Tensor,  # (S, C, *spatial)
    angles: torch.Tensor,  # (S, 3) or (S, 1) content rotation angles per axis
    zoom: torch.Tensor,  # (S,) isotropic content zoom
    order: int,
    out_shape: Optional[Sequence[int]] = None,
    angle_max: float = 0.0,
    zoom_min: float = 1.0,
    bf16: bool = False,
) -> torch.Tensor:
    """Apply content rotations (axis order 0,1,2) then an isotropic zoom, all
    about the volume center, zeros outside, per sample.

    With ``out_shape`` (and the static bounds ``angle_max``/``zoom_min`` on
    the parameters) every pass emits only the center window later passes
    need, and the result is the center crop of the full-frame computation,
    at extents of ``out_shape`` raised to the full frame's parity
    (:func:`center_crop` trims the rest). Each rotation group of three shears
    goes through ``fused_shear.shear_group``: one kernel launch on the card."""
    from . import fused_shear

    n_rot = angles.shape[1]
    full = tuple(x.shape[2:])
    passes, divz, extents, groups = chain_plan(full, n_rot, out_shape, angle_max, zoom_min)
    angles = angles.to(x.device)
    zoom = zoom.to(device=x.device, dtype=torch.float32)
    coef = shear_coefficients(angles, zoom, passes, divz)

    x = x.contiguous()  # a channel-last caller's view of several channels is not
    for g, (a_axis, b_axis, specs) in enumerate(groups):
        x = fused_shear.shear_group(
            x, a_axis, b_axis, coef[:, 3 * g: 3 * g + 3].contiguous(), zoom, specs,
            order, bf16,
        )
    for i in range(3 * n_rot, len(passes)):  # axes never sheared: plain zoom
        x = scale_pass(x, passes[i][1], zoom, order, extents[i], bf16,
                       frame_extent=full[passes[i][1]])
    return x


def rotate_pass(x: torch.Tensor, axis: int, angle, order: int) -> torch.Tensor:
    """Content rotation about one axis by three shears (Paeth), per sample:
    ``x`` (S, C, *spatial), ``angle`` (S,) or a scalar. The rotation plane
    (a, b) is the two spatial axes other than ``axis`` in 3D, (0, 1) in 2D,
    as in :func:`rotation_matrix`."""
    nd = x.ndim - 2
    if nd == 2:
        a, b = 0, 1
    else:
        a, b = [d for d in range(3) if d != axis]
    angle = _per_sample(angle, x.shape[0], x.device)
    sh1 = -torch.tan(angle / 2.0)
    sh2 = torch.sin(angle)
    # R(t) content rotation = shear_a(sh1) . shear_b(sh2) . shear_a(sh1)
    x = shear_pass(x, a, b, sh1, order)
    x = shear_pass(x, b, a, sh2, order)
    return shear_pass(x, a, b, sh1, order)


def center_crop(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """Static center crop of the spatial axes of a (S, C, *spatial) tensor."""
    sl = (slice(None), slice(None)) + tuple(
        slice((x.shape[2 + a] - out_shape[a]) // 2,
              (x.shape[2 + a] - out_shape[a]) // 2 + out_shape[a])
        for a in range(x.ndim - 2)
    )
    return x[sl]
