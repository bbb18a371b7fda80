"""Affine grid resampling on the host (numpy).

Port of the numpy half of ``segmantic_tpu/ops/resample.py``: ``grid_matrix``,
``output_affine_for_spacing`` and ``resample_affine_np`` (ITK semantics: voxel
centres at integer indices, ``v_in = M[:, :nd] @ v_out + M[:, nd]``, linear or
nearest interpolation, constant padding outside the input grid). The device
twin (``resample_affine_jax``) is not on the serving path and is not ported.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np


def grid_matrix(in_affine: np.ndarray, out_affine: np.ndarray, ndim: int) -> np.ndarray:
    """(ndim, ndim+1) matrix mapping output voxel index -> input voxel index."""
    m = np.linalg.inv(np.asarray(in_affine, np.float64)) @ np.asarray(
        out_affine, np.float64
    )
    cols = list(range(ndim)) + [3]
    return m[:ndim][:, cols]


def output_affine_for_spacing(
    in_affine: np.ndarray, in_shape: Sequence[int], target_spacing: Sequence[float]
) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """ITK-style resample-to-spacing geometry: same origin/direction,
    ``out_size = ceil(size * spacing / target)``
    (reference: src/segmantic/image/processing.py:54-58)."""
    ndim = len(in_shape)
    in_affine = np.asarray(in_affine, np.float64)
    spacing = np.linalg.norm(in_affine[:3, :ndim], axis=0)
    target = np.asarray(target_spacing, np.float64)
    out_shape = tuple(
        int(np.ceil(in_shape[d] * spacing[d] / target[d])) for d in range(ndim)
    )
    direction = in_affine[:3, :ndim] / np.where(spacing == 0, 1, spacing)[None, :]
    out_affine = np.eye(4, dtype=np.float64)
    out_affine[:3, :ndim] = direction * target[None, :]
    out_affine[:3, 3] = in_affine[:3, 3]
    return out_affine, out_shape


def _is_diagonal(mat: np.ndarray) -> bool:
    return np.allclose(mat, np.diag(np.diag(mat)), atol=1e-12)


# ---------------------------------------------------------------------------
# numpy implementation (host path)
# ---------------------------------------------------------------------------


def _np_axis_lerp(
    data: np.ndarray, pos: np.ndarray, axis: int, order: int
) -> np.ndarray:
    """Interpolate along one axis at (1D) positions ``pos``; zero outside."""
    n = data.shape[axis]
    if order == 0:
        idx = np.round(pos).astype(np.int64)
        valid = (idx >= 0) & (idx <= n - 1)
        idx_c = np.clip(idx, 0, n - 1)
        out = np.take(data, idx_c, axis=axis)
        mask_shape = [1] * data.ndim
        mask_shape[axis] = len(pos)
        return out * valid.reshape(mask_shape)
    lo = np.floor(pos).astype(np.int64)
    w = (pos - lo).astype(data.dtype if np.issubdtype(data.dtype, np.floating) else np.float32)
    v_lo = (lo >= 0) & (lo <= n - 1)
    v_hi = (lo + 1 >= 0) & (lo + 1 <= n - 1)
    a = np.take(data, np.clip(lo, 0, n - 1), axis=axis)
    b = np.take(data, np.clip(lo + 1, 0, n - 1), axis=axis)
    shp = [1] * data.ndim
    shp[axis] = len(pos)
    w = w.reshape(shp)
    return a * (v_lo.reshape(shp) * (1 - w)) + b * (v_hi.reshape(shp) * w)


def resample_affine_np(
    data: np.ndarray,
    matrix: np.ndarray,
    out_shape: Sequence[int],
    order: int = 1,
    cval: float = 0.0,
) -> np.ndarray:
    """Resample channel-first ``data`` (C, *S_in) onto an ``out_shape`` grid.

    ``matrix`` is (nd, nd+1): input index = matrix[:, :nd] @ out index + matrix[:, nd].
    order: 0 = nearest, 1 = (bi/tri)linear. Outside the grid -> ``cval``.
    """
    nd = data.ndim - 1
    matrix = np.asarray(matrix, np.float64)
    out_shape = tuple(int(s) for s in out_shape)
    in_dtype = data.dtype

    work = data if np.issubdtype(in_dtype, np.floating) else data.astype(np.float32)

    if _is_diagonal(matrix[:, :nd]):
        # separable fast path: per-axis 1D interpolation
        out = work
        inside = np.True_
        for ax in range(nd):
            pos = matrix[ax, ax] * np.arange(out_shape[ax]) + matrix[ax, nd]
            out = _np_axis_lerp(out, pos, axis=ax + 1, order=order)
            chk = np.round(pos) if order == 0 else pos
            valid = (chk >= 0) & (chk <= data.shape[1 + ax] - 1)
            shp = [1] * nd
            shp[ax] = out_shape[ax]
            inside = inside & valid.reshape(shp)
        inside = np.broadcast_to(inside, out_shape)
        result = out
    else:
        # general path: full coordinate grid
        grids = np.meshgrid(
            *[np.arange(s, dtype=np.float64) for s in out_shape], indexing="ij"
        )
        coords = np.stack(
            [
                sum(matrix[a, b] * grids[b] for b in range(nd)) + matrix[a, nd]
                for a in range(nd)
            ]
        )  # (nd, *out_shape)
        result = _np_gather_interp(work, coords, order)
        inside = np.ones(out_shape, dtype=bool)
        for a in range(nd):
            chk = np.round(coords[a]) if order == 0 else coords[a]
            inside &= (chk >= 0) & (chk <= data.shape[1 + a] - 1)

    # ITK convention: any point whose continuous index leaves [0, n-1] on any
    # axis gets the default pixel value (even partially-overlapping lerps)
    result = np.where(inside[None], result, cval)

    if not np.issubdtype(in_dtype, np.floating):
        result = result.astype(in_dtype)  # truncation cast, like ITK static_cast
    return result


def _np_gather_interp(work: np.ndarray, coords: np.ndarray, order: int) -> np.ndarray:
    nd = coords.shape[0]
    in_shape = work.shape[1:]
    if order == 0:
        idx = [np.round(coords[a]).astype(np.int64) for a in range(nd)]
        valid = np.ones(coords.shape[1:], dtype=bool)
        for a in range(nd):
            valid &= (idx[a] >= 0) & (idx[a] <= in_shape[a] - 1)
            idx[a] = np.clip(idx[a], 0, in_shape[a] - 1)
        out = work[(slice(None),) + tuple(idx)]
        return out * valid[None]

    lo = [np.floor(coords[a]).astype(np.int64) for a in range(nd)]
    frac = [(coords[a] - lo[a]).astype(np.float32) for a in range(nd)]
    out = None
    for corner in itertools.product((0, 1), repeat=nd):
        w = np.ones(coords.shape[1:], dtype=np.float32)
        idx = []
        valid = np.ones(coords.shape[1:], dtype=bool)
        for a in range(nd):
            i = lo[a] + corner[a]
            valid &= (i >= 0) & (i <= in_shape[a] - 1)
            idx.append(np.clip(i, 0, in_shape[a] - 1))
            w = w * (frac[a] if corner[a] else (1.0 - frac[a]))
        term = work[(slice(None),) + tuple(idx)] * (w * valid)[None]
        out = term if out is None else out + term
    return out
