"""Anatomical orientation utilities (axis codes, reorientation, inversion).

Replaces MONAI's ``Orientationd(axcodes=...)`` step of the preprocessing
chain (reference: src/segmantic/seg/monai_unet.py:163) with explicit
permute+flip derived from the affine — for any target axis codes and for
both 2D and 3D volumes (a 2D slice's voxel axes may lie along any two of
the three physical axes, e.g. a coronal slice is R/S). Pure numpy on host
metadata; the actual data movement (transpose/flip) is cheap and
XLA-fusable when applied on device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

_AXIS_LABELS = (("L", "R"), ("P", "A"), ("I", "S"))  # negative, positive per RAS axis
_CODE_TO_PHYS = {
    code: (phys, sign)
    for phys, (neg, pos) in enumerate(_AXIS_LABELS)
    for code, sign in ((neg, -1), (pos, 1))
}


def parse_axcodes(codes: Union[str, Sequence[str]]) -> List[Tuple[int, int]]:
    """Axis codes → list of (physical_axis, sign); e.g. 'RAS' → [(0,1),(1,1),(2,1)]."""
    out: List[Tuple[int, int]] = []
    seen = set()
    for c in codes:
        c = c.upper()
        if c not in _CODE_TO_PHYS:
            raise ValueError(f"unknown axis code {c!r} in {codes!r}")
        phys, sign = _CODE_TO_PHYS[c]
        if phys in seen:
            raise ValueError(f"axis codes {codes!r} repeat a physical axis")
        seen.add(phys)
        out.append((phys, sign))
    return out


def io_orientation(affine: np.ndarray, ndim: int = 3) -> np.ndarray:
    """For each voxel axis, the closest physical axis and its sign.

    Returns an (ndim, 2) array of (physical_axis, sign) rows, computed by
    greedy assignment of the strongest remaining |direction cosine|.
    """
    rot = np.asarray(affine, dtype=np.float64)[:3, :ndim].copy()
    norms = np.linalg.norm(rot, axis=0)
    norms = np.where(norms == 0, 1.0, norms)
    cosines = rot / norms[None, :]

    result = np.zeros((ndim, 2), dtype=np.int64)
    remaining_vox = list(range(ndim))
    remaining_phys = list(range(3))
    # greedy: repeatedly take the largest |cosine| among remaining pairs
    while remaining_vox:
        best = None
        for v in remaining_vox:
            for p in remaining_phys:
                mag = abs(cosines[p, v])
                if best is None or mag > best[0]:
                    best = (mag, v, p)
        _, v, p = best
        result[v, 0] = p
        result[v, 1] = 1 if cosines[p, v] >= 0 else -1
        remaining_vox.remove(v)
        remaining_phys.remove(p)
    return result


def axcodes(affine: np.ndarray, ndim: int = 3) -> Tuple[str, ...]:
    """Axis codes like ('R','A','S') for each voxel axis."""
    orn = io_orientation(affine, ndim)
    return tuple(_AXIS_LABELS[int(p)][1 if s > 0 else 0] for p, s in orn)


def orientation_ops(
    affine: np.ndarray, ndim: int, target: Union[str, Sequence[str]] = "RAS"
) -> Tuple[List[int], List[int]]:
    """The (perm, flips) taking a volume's voxel axes to ``target`` codes.

    ``perm``: new voxel axis ``i`` takes old voxel axis ``perm[i]``.
    ``flips``: new voxel axes to flip after the permutation.

    For 2D volumes the target is restricted to the two physical axes the
    slice actually spans, in target order — so ``"RAS"`` orients an axial
    slice to R/A and a coronal slice to R/S.
    """
    orn = io_orientation(affine, ndim)
    want = parse_axcodes(target)
    present = {int(p): (v, int(s)) for v, (p, s) in enumerate(orn)}
    ordered = [(q, t) for q, t in want if q in present]
    if len(ordered) != ndim:
        raise ValueError(
            f"target axcodes {target!r} do not cover the volume's physical "
            f"axes {sorted(present)} (ndim={ndim})"
        )
    perm: List[int] = []
    flips: List[int] = []
    for i, (q, t) in enumerate(ordered):
        v, s = present[q]
        perm.append(v)
        if s != t:
            flips.append(i)
    return perm, flips


def apply_orientation(
    data: np.ndarray, affine: np.ndarray, perm: Sequence[int], flips: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply (perm, flips) to a channel-first array and its 4x4 affine."""
    ndim = data.ndim - 1
    if list(perm) != list(range(ndim)):
        data = np.transpose(data, [0] + [int(p) + 1 for p in perm])
    aff = np.asarray(affine, dtype=np.float64)
    new_aff = np.eye(4, dtype=np.float64)
    new_aff[:3, :3] = aff[:3, :3]
    new_aff[:3, :ndim] = aff[:3, [int(p) for p in perm]]
    new_aff[:3, 3] = aff[:3, 3]
    for ax in flips:
        n = data.shape[ax + 1]
        data = np.flip(data, axis=ax + 1)
        new_aff[:3, 3] = new_aff[:3, 3] + new_aff[:3, ax] * (n - 1)
        new_aff[:3, ax] = -new_aff[:3, ax]
    return np.ascontiguousarray(data), new_aff


def invert_orientation(
    data: np.ndarray,
    perm: Sequence[int],
    flips: Sequence[int],
    original_affine: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Undo :func:`apply_orientation`: flip back, then inverse-permute."""
    ndim = data.ndim - 1
    if flips:
        data = np.flip(data, axis=[int(f) + 1 for f in flips])
    inv = np.argsort(np.asarray(perm))
    if list(inv) != list(range(ndim)):
        data = np.transpose(data, [0] + [int(i) + 1 for i in inv])
    return np.ascontiguousarray(data), np.asarray(original_affine, dtype=np.float64)


def reorient_to_axcodes(
    data: np.ndarray, affine: np.ndarray, target: Union[str, Sequence[str]] = "RAS"
) -> Tuple[np.ndarray, np.ndarray, List[int], List[int]]:
    """Reorient a channel-first array + affine to ``target`` axis codes.

    Returns (new_data, new_affine, perm, flips); the (perm, flips) pair is
    what :func:`invert_orientation` needs for an exact inverse.
    """
    ndim = data.ndim - 1
    perm, flips = orientation_ops(affine, ndim, target)
    new_data, new_aff = apply_orientation(data, affine, perm, flips)
    return new_data, new_aff, perm, flips


def reorient_arrays_to_ras(
    data: np.ndarray, affine: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Reorient a channel-first array + affine so axis codes become RAS."""
    new_data, new_aff, _, _ = reorient_to_axcodes(data, affine, "RAS")
    return new_data, new_aff


def inverse_orientation_op(
    data: np.ndarray,
    affine: np.ndarray,
    original_affine: np.ndarray,
    target: Union[str, Sequence[str]] = "RAS",
) -> Tuple[np.ndarray, np.ndarray]:
    """Map an array oriented to ``target`` codes back to the voxel axis
    order/signs of ``original_affine``."""
    ndim = data.ndim - 1
    perm, flips = orientation_ops(original_affine, ndim, target)
    return invert_orientation(data, perm, flips, original_affine)
