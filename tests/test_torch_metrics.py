"""The port's overlap metrics against the JAX package's on the same label maps.

``confusion_matrix`` with numpy in (numpy int64 out, as the JAX function) and
with tensors in (a tensor on their device), ``dice_metric`` with and without
background and with absent classes (nan, left out of the mean), and
``dice_from_confusion`` / ``confusion_matrix_metrics``. Integers exact,
floats within 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.metrics import overlap as joverlap
from segmantic_tpu_torch.metrics import overlap

# (num_classes, shape, seed, classes drawn): the last two leave classes out
CASES = [
    (2, (16, 16, 16), 0, None),
    (3, (9, 10, 11), 1, None),
    (8, (12, 12, 12), 2, None),
    (5, (7, 8, 9), 3, [0, 1, 3]),
    (4, (6, 6, 6), 4, [0]),
]
IDS = ["k2", "k3", "k8", "k5-absent", "k4-only-bg"]


def _maps(num_classes, shape, seed, classes):
    rng = np.random.default_rng(seed)
    pool = np.arange(num_classes) if classes is None else np.asarray(classes)
    target = rng.choice(pool, shape).astype(np.uint8)
    pred = target.copy()
    flip = rng.random(shape) < 0.3
    pred[flip] = rng.choice(pool, int(flip.sum()))
    return target, pred.astype(np.int64)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_confusion_matrix_numpy_in_numpy_out(case):
    target, pred = _maps(*case)
    got = overlap.confusion_matrix(case[0], target, pred)
    want = joverlap.confusion_matrix(case[0], target, pred)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.sum() == target.size


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_confusion_matrix_tensor_in_tensor_out(case):
    target, pred = _maps(*case)
    got = overlap.confusion_matrix(case[0], torch.from_numpy(target), torch.from_numpy(pred))
    want = joverlap.confusion_matrix(case[0], jnp.asarray(target), jnp.asarray(pred))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("include_background", [False, True], ids=["no-bg", "bg"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dice_metric(case, include_background):
    target, pred = _maps(*case)
    got = overlap.dice_metric(torch.from_numpy(pred), torch.from_numpy(target), case[0],
                              include_background=include_background)
    want = float(joverlap.dice_metric(jnp.asarray(pred), jnp.asarray(target), case[0],
                                      include_background=include_background))
    assert got.dtype == torch.float32 and got.ndim == 0
    if np.isnan(want):  # every class absent (only background, excluded)
        assert torch.isnan(got)
    else:
        assert abs(float(got) - want) <= 1e-6


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_confusion_matrix_metrics_and_dice(case):
    target, pred = _maps(*case)
    cm = overlap.confusion_matrix(case[0], target, pred)
    got, want = overlap.confusion_matrix_metrics(cm), joverlap.confusion_matrix_metrics(cm)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(overlap.dice_from_confusion(cm),
                               joverlap.dice_from_confusion(cm), rtol=0, atol=1e-6)
