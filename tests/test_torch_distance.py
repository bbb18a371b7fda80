"""Surface and point-wise Hausdorff statistics against the JAX package's.

Both packages take the native distance transform of ``native/`` when the
library loads, scipy's exact one when it does not; each route gives the
same statistics in both packages, and the two routes agree within 1e-5
relative (the native transform returns f32). The library is built first
through the port's atomic loader (module fixture), so the JAX loader finds a
finished file and never runs its own ``make``.
"""

from __future__ import annotations

import numpy as np
import pytest

from segmantic_tpu import native as jnative
from segmantic_tpu.metrics import distance as jdist
from segmantic_tpu_torch import metrics, native
from segmantic_tpu_torch.metrics import distance as tdist


@pytest.fixture(scope="module", autouse=True)
def native_library():
    return native.available()


def _blob(rng, shape, radius, shift=0.0):
    grid = np.stack(np.meshgrid(*[np.arange(s) - s / 2 for s in shape], indexing="ij"))
    c = rng.uniform(-2, 2, len(shape)).reshape((-1,) + (1,) * len(shape)) + shift
    noise = rng.uniform(0, 0.8, shape)
    return (np.sqrt(((grid - c) ** 2).sum(0)) + noise < radius).astype(np.uint8)


CASES = {
    "3d": ((24, 22, 20), None, 7.0),
    "3d-anisotropic": ((24, 22, 20), (0.9, 0.9, 1.2), 7.0),
    "2d": ((40, 36), (0.5, 0.7), 12.0),
    "3d-pred-empty": ((16, 16, 16), (1.0, 1.0, 1.5), 0.0),
}


def _masks(case):
    shape, spacing, radius = CASES[case]
    rng = np.random.default_rng(len(case))
    ref = _blob(rng, shape, max(radius, 5.0))
    pred = _blob(rng, shape, radius, shift=1.5) if radius > 0 else np.zeros(shape, np.uint8)
    return pred, ref, spacing


def _block_native(monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("native library unavailable")

    monkeypatch.setattr(native, "edt_distance_to_foreground", refuse)
    monkeypatch.setattr(jnative, "edt_distance_to_foreground", refuse)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fn", ["hausdorff_surface_distance", "hausdorff_pointwise_distance"])
def test_distances_match_jax_on_both_routes(case, fn, monkeypatch, native_library):
    pred, ref, spacing = _masks(case)
    port, jax_ = getattr(tdist, fn), getattr(jdist, fn)
    routes = {}
    if native_library:
        calls = []
        real = native.edt_distance_to_foreground
        monkeypatch.setattr(native, "edt_distance_to_foreground",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        routes["native"] = (port(pred, ref, spacing), jax_(pred, ref, spacing))
        assert calls or not pred.any(), "the native transform was not taken"
        monkeypatch.undo()
    _block_native(monkeypatch)
    routes["scipy"] = (port(pred, ref, spacing), jax_(pred, ref, spacing))
    for name, (got, want) in routes.items():
        assert got.keys() == want.keys() == {"mean", "median", "std", "max"}
        np.testing.assert_array_equal([got[k] for k in sorted(got)],
                                      [want[k] for k in sorted(want)], err_msg=name)
    got_s = routes["scipy"][0]
    if not pred.any():  # an empty mask is infinitely far from everything
        assert np.isinf(got_s["max"])
        return
    assert got_s["max"] > 0
    if "native" in routes:
        got_n = routes["native"][0]
        for k in got_s:
            assert abs(got_n[k] - got_s[k]) <= 1e-5 * max(abs(got_s[k]), 1e-6), k


def test_binary_contour_and_exports_match(native_library):
    pred, ref, _ = _masks("3d")
    np.testing.assert_array_equal(tdist.binary_contour(ref), jdist.binary_contour(ref))
    from segmantic_tpu import metrics as jmetrics

    assert metrics.__all__ == jmetrics.__all__
    if native_library:
        np.testing.assert_array_equal(
            native.edt_distance_to_foreground(pred, (0.9, 0.8, 1.2)),
            jnative.edt_distance_to_foreground(pred, (0.9, 0.8, 1.2)))
