"""Surface and point-wise Hausdorff statistics against the JAX package's.

Both packages take the native distance transform of ``native/`` when the
library loads, scipy's exact one when it does not; each route gives the
same statistics in both packages, and the two routes agree within 1e-5
relative (the native transform returns f32). The module fixture holds both
packages to one finished library (``test_torch_native_sync.one_native_library``:
built through the port's atomic loader, the JAX loader's cached failure
cleared), so a worker whose JAX loader cached a failure at collection does
not send the JAX side to scipy while the port takes the library.
"""

from __future__ import annotations

import numpy as np
import pytest

from segmantic_tpu import native as jnative
from segmantic_tpu.metrics import distance as jdist
from segmantic_tpu_torch import metrics, native
from segmantic_tpu_torch.metrics import distance as tdist
from tests.test_torch_native_sync import one_native_library


@pytest.fixture(scope="module", autouse=True)
def native_library():
    return one_native_library()


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


def test_a_failure_the_jax_loader_cached_before_the_fixture_is_cleared():
    """The fault this file's fixture repairs, set by hand: the JAX loader's
    cached failure, as a worker caches it when it loads a half-linked file
    at collection. The fixture's helper clears it, and the JAX Hausdorff
    then takes the same route as the port's, bit for bit."""
    with jnative._lock:
        jnative._lib, jnative._load_failed = None, True
    both = one_native_library()
    assert jnative._load_failed == (not both)
    assert both == jnative.available() == native.available()
    pred, ref, spacing = _masks("3d-anisotropic")
    got = tdist.hausdorff_surface_distance(pred, ref, spacing)
    want = jdist.hausdorff_surface_distance(pred, ref, spacing)
    np.testing.assert_array_equal([got[k] for k in sorted(got)], [want[k] for k in sorted(want)])
