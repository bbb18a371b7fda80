"""The blend kernel's launch geometry and traversal, on the CPU.

``blend.union_tiles`` lists the tiles of a launch that some window touches and
the windows each takes; the kernel derives the same lists from the starts it
gets by value, and a block with an empty list returns before it touches the
accumulator. Held here: the listed tiles are disjoint, cover every covered
voxel and hold no tile without one; each list is exactly the windows that
overlap the tile, ascending. The kernel cannot run here, so its traversal
(tiles, per-tile window lists, windows added in the order of b, at most
``MAX_WINDOWS`` windows a launch) is emulated in plain PyTorch and must equal
``accumulate_windows_plain`` bit for bit (each element sees the same products
added in the same order) and ``accumulate_windows_pallas`` in interpret mode on
an aligned grid within 1e-6 (one rounding step, should XLA fuse differently).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.ops.pallas_blend import accumulate_windows_pallas
from segmantic_tpu_torch.infer.sliding_window import window_starts
from segmantic_tpu_torch.ops import blend

ROI = (96, 96, 96)


def _chunks(volume, sw_batch):
    starts = np.asarray(window_starts(volume, ROI, 0.25))
    return [starts[i:i + sw_batch] for i in range(0, len(starts), sw_batch)]


def _cases():
    cases = [(f"head-sw4-{i}", (256, 256, 176), c)
             for i, c in enumerate(_chunks((256, 256, 176), 4))]
    cases += [(f"head-sw16-{i}", (256, 256, 176), c)
              for i, c in enumerate(_chunks((256, 256, 176), 16))]
    cases += [(f"lps-sw4-{i}", (200, 168, 150), c)
              for i, c in enumerate(_chunks((200, 168, 150), 4))]
    cases.append(("single", (256, 256, 176), np.array([[72, 160, 80]])))
    cases.append(("twice", (256, 256, 176), np.array([[3, 5, 7], [3, 5, 7]])))
    return cases


CASES = _cases()


def test_the_served_grids_have_the_expected_chunks():
    assert len(_chunks((256, 256, 176), 4)) == 12 and len(_chunks((256, 256, 176), 16)) == 3
    assert len(_chunks((200, 168, 150), 4)) == 3  # every last window snapped to an edge


@pytest.mark.parametrize("name,volume,starts", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("channels", [8, 5])
def test_union_tiles_cover_the_union_exactly_once(name, volume, starts, channels):
    _, (_, tx, ty) = blend.launch_shape(channels)
    tile = (blend.ROWS, ty, tx)
    plan = blend.union_tiles(starts, ROI, tile)
    covered = np.zeros(volume, bool)
    for s in starts:
        covered[tuple(slice(a, a + r) for a, r in zip(s, ROI))] = True
    assert plan.origin == tuple(starts.min(axis=0))
    assert len(plan.tiles) == len(set(plan.tiles)) == len(plan.windows)
    visited = np.zeros(volume, np.int32)
    for t, wins in zip(plan.tiles, plan.windows):
        assert all(0 <= t[a] < plan.grid[a] for a in range(3))
        lo = [plan.origin[a] + t[a] * tile[a] for a in range(3)]
        box = tuple(slice(lo[a], min(lo[a] + tile[a], volume[a])) for a in range(3))
        visited[box] += 1
        assert covered[box].any()  # no tile without a covered voxel
        overlap = [b for b, s in enumerate(starts)
                   if all(s[a] < lo[a] + tile[a] and s[a] + ROI[a] > lo[a] for a in range(3))]
        assert list(wins) == overlap and wins  # ascending, exactly the overlapping windows
    assert visited.max() == 1  # tiles are disjoint
    assert not (covered & (visited == 0)).any()  # every covered voxel lies in a listed tile
    # the listed tiles hold less than the bounding box wherever the union does
    box_tiles = int(np.prod(plan.grid))
    assert len(plan.tiles) <= box_tiles
    if name == "head-sw4-0" and channels == 8:
        assert len(plan.tiles) < 0.9 * box_tiles


def test_union_tiles_is_cached_per_chunk():
    starts = _chunks((256, 256, 176), 4)[3]
    first = blend.union_tiles(starts, ROI, (4, 8, 16))
    assert blend.union_tiles(starts.copy(), ROI, (4, 8, 16)) is first
    assert blend.union_tiles(starts + 1, ROI, (4, 8, 16)) is not first


@pytest.mark.parametrize("channels,aligned,expect", [
    (8, True, (4, (2, 16, 8))),  # the flagship's classes: float4, a warp = 16 voxels of a row
    (4, True, (4, (1, 32, 8))),
    (8, False, (1, (8, 4, 8))),  # a base pointer off 16 bytes: scalar
    (5, True, (1, (5, 6, 8))),
    (3, True, (1, (3, 10, 8))),
    (64, True, (4, (16, 2, 8))),
    (200, True, (4, (32, 1, 8))),  # 50 float4 a voxel: 32 side by side, then a loop
    (1, True, (1, (1, 32, 8))),
])
def test_vector_and_scalar_route_rule(channels, aligned, expect):
    vec, block = blend.launch_shape(channels, aligned)
    assert (vec, block) == expect
    assert channels % vec == 0 and 32 <= block[0] * block[1] * block[2] <= 256


def emulate_kernel(acc, logits, imp, starts, wacc=None):
    """The kernel's traversal: launches of at most MAX_WINDOWS windows in
    order; per launch the listed tiles; per tile its windows in order, each
    over the tile's intersection with the window."""
    roi = tuple(logits.shape[1:4])
    _, (_, tx, ty) = blend.launch_shape(acc.shape[-1])
    tile = (blend.ROWS, ty, tx)
    launches = 0
    for i in range(0, len(starts), blend.MAX_WINDOWS):
        part = np.asarray(starts[i:i + blend.MAX_WINDOWS])
        plan = blend.union_tiles(part, roi, tile)
        launches += 1
        for t, wins in zip(plan.tiles, plan.windows):
            lo = [plan.origin[a] + t[a] * tile[a] for a in range(3)]
            for b in wins:
                s = part[b]
                a0 = [max(lo[a], s[a]) for a in range(3)]
                a1 = [min(lo[a] + tile[a], s[a] + roi[a]) for a in range(3)]
                box = tuple(slice(a0[a], a1[a]) for a in range(3))
                rel = tuple(slice(a0[a] - s[a], a1[a] - s[a]) for a in range(3))
                acc[box] += logits[i + b][rel] * imp[rel][..., None]
                if wacc is not None:
                    wacc[box] += imp[rel][..., None]
    return launches


def _random_case(rng, volume, roi, starts, channels):
    acc = torch.from_numpy(rng.standard_normal((*volume, channels)).astype(np.float32))
    logits = torch.from_numpy(
        rng.standard_normal((len(starts), *roi, channels)).astype(np.float32))
    imp = torch.from_numpy(rng.random(roi).astype(np.float32))
    return acc, logits, imp


@pytest.mark.parametrize("channels", [8, 5, 3])
@pytest.mark.parametrize("volume,roi,starts", [
    ((40, 44, 36), (24, 24, 20), window_starts((40, 44, 36), (24, 24, 20), 0.25)),  # snapped edges
    ((30, 30, 30), (12, 16, 10), [[3, 5, 7], [3, 5, 7], [18, 14, 20]]),  # a window twice
    ((20, 20, 20), (8, 8, 8), [[12, 12, 12]]),
    # a 2D sliding window's chunk: windows one plane deep
    ((1, 40, 36), (1, 16, 16), window_starts((1, 40, 36), (1, 16, 16), 0.25)),
])
def test_emulated_traversal_is_bit_equal_to_the_plain_loop(volume, roi, starts, channels):
    rng = np.random.default_rng(5)
    starts = np.asarray(starts)
    acc, logits, imp = _random_case(rng, volume, roi, starts, channels)
    wacc = torch.from_numpy(rng.random((*volume, 1)).astype(np.float32))
    want_w = wacc.clone()
    want = blend.accumulate_windows_plain(acc.clone(), logits, imp, starts, want_w)
    got, got_w = acc.clone(), wacc.clone()
    assert emulate_kernel(got, logits, imp, starts, got_w) == 1
    assert torch.equal(got, want) and torch.equal(got_w, want_w)
    # outside the union nothing changed
    covered = torch.zeros(volume, dtype=torch.bool)
    for s in starts:
        covered[tuple(slice(a, a + r) for a, r in zip(s, roi))] = True
    assert torch.equal(got[~covered], acc[~covered])


@pytest.mark.parametrize("channels", [8, 5])
@pytest.mark.parametrize("sw_batch", [4, 16])
def test_unit_depth_windows_take_one_plane_of_tiles(channels, sw_batch):
    """A 2D volume runs as one of unit depth: a 1024^2 image in 256^2 windows
    at overlap 0.25 (25 windows). Each launch's tiles lie in plane 0 (the
    kernel's ROWS = 4 planes a thread, of which only the first is covered),
    cover the union exactly once, and the listed tiles fill less than the
    bounding box only where the union does."""
    volume, roi = (1, 1024, 1024), (1, 256, 256)
    starts = np.asarray(window_starts(volume, roi, 0.25))
    assert len(starts) == 25
    _, (_, tx, ty) = blend.launch_shape(channels)
    tile = (blend.ROWS, ty, tx)
    for i in range(0, len(starts), sw_batch):
        part = starts[i:i + sw_batch]
        plan = blend.union_tiles(part, roi, tile)
        assert plan.grid[0] == 1 and all(t[0] == 0 for t in plan.tiles)
        covered = np.zeros(volume[1:], bool)
        for s in part:
            covered[s[1]:s[1] + roi[1], s[2]:s[2] + roi[2]] = True
        visited = np.zeros(volume[1:], np.int32)
        for t in plan.tiles:
            y, x = plan.origin[1] + t[1] * ty, plan.origin[2] + t[2] * tx
            visited[y:y + ty, x:x + tx] += 1
        assert visited.max() == 1 and not (covered & (visited == 0)).any()


def test_more_windows_than_a_launch_takes_split_in_order():
    rng = np.random.default_rng(6)
    volume, roi = (24, 26, 28), (6, 8, 10)
    starts = np.stack([rng.integers(0, v - r + 1, 40) for v, r in zip(volume, roi)], axis=1)
    assert len(starts) > blend.MAX_WINDOWS
    acc, logits, imp = _random_case(rng, volume, roi, starts, 4)
    want = blend.accumulate_windows_plain(acc.clone(), logits, imp, starts)
    got = acc.clone()
    assert emulate_kernel(got, logits, imp, starts) == 2
    assert torch.equal(got, want)


def test_emulated_traversal_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    acc = rng.standard_normal((32, 32, 48, 8)).astype(np.float32)
    logits = rng.standard_normal((4, 16, 16, 32, 8)).astype(np.float32)
    imp = rng.random((16, 16, 32)).astype(np.float32)
    # axis-1 starts % 8 == 0, axis-2 starts * C % 128 == 0; windows overlap
    starts = np.array([[0, 0, 0], [8, 8, 16], [16, 16, 16], [4, 16, 0]], np.int32)
    got = torch.from_numpy(acc.copy())
    emulate_kernel(got, torch.from_numpy(logits), torch.from_numpy(imp), starts)
    want = np.asarray(accumulate_windows_pallas(
        jnp.asarray(acc), jnp.asarray(logits), jnp.asarray(imp), jnp.asarray(starts),
        tile=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_weight_map_in_the_same_pass_equals_the_slice_adds():
    rng = np.random.default_rng(7)
    volume, roi = (20, 22, 24), (10, 12, 8)
    starts = np.array([[0, 0, 0], [5, 6, 4], [10, 10, 16], [10, 10, 16]])
    acc, logits, imp = _random_case(rng, volume, roi, starts, 4)
    wacc = torch.zeros((*volume, 1))
    got = blend.accumulate_windows(acc.clone(), logits, imp, starts, wacc)
    want_w = torch.zeros((*volume, 1))
    for s in starts:
        want_w[tuple(slice(a, a + r) for a, r in zip(s, roi))] += imp[..., None]
    assert torch.equal(wacc, want_w)
    assert torch.equal(got, blend.accumulate_windows(acc.clone(), logits, imp, starts))
    with pytest.raises(ValueError, match="wacc"):
        blend.accumulate_windows(acc, logits, imp, starts, torch.zeros(volume))
