"""The port's sliding window over a mesh of two gloo CPU ranks against the
JAX package's on two devices of the conftest's virtual mesh and against the
port's one-rank result: window sharding and volume sharding, 2D and 3D, the
``sw_batch_size`` rounding and the fall-back to window sharding when a slab
would be thinner than the roi (``tests/infer/test_sliding_window.py:76-220``).

Limits are the JAX tests' own: window sharding atol 1e-5, volume sharding
atol 1e-4 / rtol 1e-4 (the sums run in another order). The predictor adds a
ramp along the window's first axis, so an offset of a slab, a halo or a
window shows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from segmantic_tpu.infer import sliding_window as jsw
from segmantic_tpu.parallel import mesh as jmesh
from tests.test_torch_parallel_ranks import Ranks, sw_cases

WINDOW_TOL = dict(atol=1e-5, rtol=0)
VOLUME_TOL = dict(atol=1e-4, rtol=1e-4)


def _volume(shape, seed):
    return np.random.default_rng(seed).standard_normal(tuple(shape) + (1,)).astype(np.float32)


CASES = {
    "window3d": dict(volume=_volume((23, 20, 18), 0), roi=(8, 8, 8), sw_batch=4),
    "window2d": dict(volume=_volume((40, 33), 1), roi=(16, 16), sw_batch=4, mode="constant"),
    "rounded": dict(volume=_volume((20, 17), 2), roi=(8, 8), sw_batch=3),
    "volume3d": dict(volume=_volume((40, 24, 24), 3), roi=(16, 16, 16), sw_batch=4,
                     shard_volume=True),
    "direct3d": dict(volume=_volume((40, 24, 24), 3), roi=(16, 16, 16), sw_batch=4,
                     direct=True),
    "volume2d": dict(volume=_volume((40, 33), 4), roi=(16, 16), sw_batch=3,
                     shard_volume=True, overlap=0.5),
    "thin_slab": dict(volume=_volume((24, 20, 20), 5), roi=(16, 16, 16), sw_batch=4,
                      shard_volume=True),
}


def _jax_predictor(w):
    ramp = jnp.arange(w.shape[1], dtype=jnp.float32).reshape((1, -1) + (1,) * (w.ndim - 2))
    return jnp.concatenate([w * 2.0 + ramp * 0.01, -w, w * w], axis=-1)


def _jax(case):
    mesh = jmesh.make_mesh(devices=jax.devices()[:2])
    kw = dict(overlap=case.get("overlap", 0.25), mode=case.get("mode", "gaussian"))
    if case.get("direct"):
        return np.asarray(jsw.sliding_window_inference_sharded(
            case["volume"], case["roi"], case["sw_batch"], jax.jit(_jax_predictor), mesh,
            **kw))
    return np.asarray(jsw.sliding_window_inference(
        case["volume"], case["roi"], case["sw_batch"], jax.jit(_jax_predictor), mesh=mesh,
        shard_volume=case.get("shard_volume", False), **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks = Ranks("sw", 2, tmp_path_factory.mktemp("sw"), cases=list(CASES.values()))
    one = sw_cases([dict(c, mesh=False, direct=False) for c in CASES.values()])
    want = {name: _jax(c) for name, c in CASES.items()}
    two = ranks.wait()
    return {name: (two[0][i], two[1][i], one[i], want[name])
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_jax_mesh_and_one_rank(runs, name):
    r0, r1, one, want = runs[name]
    c = CASES[name]
    tol = VOLUME_TOL if (c.get("shard_volume") or c.get("direct")) else WINDOW_TOL
    assert r0["result"].shape == c["volume"].shape[:-1] + (3,)
    np.testing.assert_array_equal(r0["result"], r1["result"])  # every rank, the whole
    np.testing.assert_allclose(r0["result"], want, **tol)
    np.testing.assert_allclose(r0["result"], one["result"], **tol)


def test_window_sharding_splits_every_chunk(runs):
    """sw_batch 4 over 2 ranks: each rank runs 2 windows a call; sw_batch 3
    rounds down to 2 (the JAX rule), so each rank runs 1; a slab of 12 rows
    under a roi of 16 falls back to window sharding."""
    for name, per in (("window3d", 2), ("rounded", 1), ("thin_slab", 2)):
        r0, r1, one, _ = runs[name]
        assert set(r0["batches"][1:]) == set(r1["batches"][1:]) == {per}, name
        assert one["batches"][1:] and max(one["batches"][1:]) == CASES[name]["sw_batch"]


def test_volume_sharding_runs_each_window_once(runs):
    """The two ranks run the grid's windows between them, each window once
    (at most sw_batch a call), as the one-rank path runs them all."""
    r0, r1, one, _ = runs["volume3d"]
    assert max(r0["batches"] + r1["batches"]) <= 4
    assert sum(r0["batches"][1:]) + sum(r1["batches"][1:]) == sum(one["batches"][1:])
    assert sum(r0["batches"][1:]) and sum(r1["batches"][1:])
