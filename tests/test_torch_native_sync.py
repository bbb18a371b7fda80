"""One native library for both packages' loaders in the port's tests.

The tests that hold a port function against a JAX function that may reach
``segmantic_tpu.native`` (the distance transform, the sampler's crop, the
resampler) call :func:`one_native_library` from a module fixture. It builds
the library through the port's loader (under ``flock``, linked to a
temporary name and renamed into place), then clears the JAX loader's cached
state under its lock and loads it again, so both packages take the same
route on the same finished file.

Why: every pytest worker imports ``tests/test_native.py`` when it collects,
whose module-level ``skipif`` runs the JAX loader; when the library is
missing that loader runs ``make``, which links straight onto the library's
name. A worker that loads the file while another worker's linker is still
writing it caches the failure (``_load_failed``) for the rest of its life,
and its JAX functions then take scipy or numpy where the port takes the
library: the surface distances differ in the last bits. The tests here pin
the repair: a cached failure set before the fixture runs is cleared, and
both loaders compute the same distance transform.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from segmantic_tpu import native as jnative
from segmantic_tpu_torch import native


def _compiler():
    """The C++ compiler ``make`` would run (``CXX``, else ``g++``), or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def _load_error(loader) -> str:
    try:
        loader._load()
    except RuntimeError as err:
        return str(err)
    return "loaded"


def one_native_library() -> bool:
    """Build the native library through the port's atomic loader, clear both
    loaders' cached failures and load the JAX one again; True when both load
    the same file, False when neither can (no compiler: both take scipy /
    numpy). Fails, naming the cause, when one loads and the other does not,
    or when a compiler is there and the library does not build."""
    with native._lock:
        if native._lib is None:
            native._load_failed = False
    port = native.available()
    with jnative._lock:
        jnative._lib = None
        jnative._load_failed = False
    jax_ok = jnative.available()
    if port and not jax_ok:
        pytest.fail("the port's native library loads but the JAX loader's does not: "
                    + _load_error(jnative))
    if not port:
        cxx = _compiler()
        if cxx is not None:
            pytest.fail(f"the native library did not build with {cxx}: "
                        + _load_error(native))
        if jax_ok:
            pytest.fail("the JAX loader loads a native library that the port's cannot")
        return False
    assert os.path.samefile(jnative._LIB_PATH, native._LIB_PATH)
    assert os.path.samefile(jnative._lib._name, native._lib._name)
    return True


def _mask():
    rng = np.random.default_rng(5)
    return (rng.random((20, 18, 16)) > 0.97).astype(np.uint8)


def test_a_cached_jax_failure_is_cleared_and_both_loaders_agree():
    """The failure a worker caches when it loads a half-linked file, set by
    hand: the JAX loader refuses until :func:`one_native_library` clears it;
    then both loaders give the same distance transform, bit for bit."""
    with jnative._lock:
        jnative._lib, jnative._load_failed = None, True
    assert not jnative.available()
    both = one_native_library()
    assert jnative._load_failed == (not both)
    assert both == native.available() == jnative.available()
    if not both:  # no compiler: both packages take scipy
        return
    mask = _mask()
    np.testing.assert_array_equal(native.edt_distance_to_foreground(mask, (0.9, 0.8, 1.2)),
                                  jnative.edt_distance_to_foreground(mask, (0.9, 0.8, 1.2)))


def test_the_port_loader_drops_a_cached_failure_of_its_own():
    """The port's loader caches a failure too when a file it loaded did not
    change meanwhile; the helper clears that before it builds."""
    with native._lock:
        lib, failed = native._lib, native._load_failed
        native._lib, native._load_failed = None, True
    try:
        assert not native.available()
        both = one_native_library()
        assert both == native.available() and native._load_failed == (not both)
    finally:
        with native._lock:
            if native._lib is None:
                native._lib, native._load_failed = lib, failed
