"""``train_pix2pix`` and ``train_cyclegan`` of the port on two gloo CPU ranks
against one: each rank takes its rows of every batch and the D and G
gradients and losses are averaged over the ranks, so the history and the
generators equal the one-rank run's up to the order of the sums. Each loss
within 1e-4 relative (``test_torch_i2i_train``'s limit). Each generator
tensor within 1e-6 * max|p| + 1e-3 * lr after 3 Adam iterations: Adam moves
an element by about lr a step whatever the gradient's size, so a zero,
unaveraged-per-rank or wrong gradient moves it by ~lr against the one-rank
run, while rounding moves it by < 1e-4 * lr here. The exception is the bias
of each conv that feeds an InstanceNorm (all but a generator's output
conv): the norm subtracts the per-channel mean, so its true gradient is
zero, its computed one rounding noise, and Adam walks it by up to lr a step
whichever way the sums' order rounds it; those are held to the bound of
that walk, 2 * lr a step. Both ranks hold the same numbers, and rank 0 alone
writes the checkpoint.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.test_torch_parallel_ranks import Ranks, i2i_case

LR = 2e-4
KW = dict(steps=3, base_features=4, n_blocks=1, log_every=1, seed=0, lr=LR)


def _batches(seed, n=3, batch=4, size=16):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, size, size, 1)).astype(np.float32),
             rng.standard_normal((batch, size, size, 1)).astype(np.float32))
            for _ in range(n)]


def _norm_fed_biases(params):
    """The biases of the convs that feed an InstanceNorm: every conv bias of a
    generator but its last conv's (the output conv, in front of the tanh)."""
    convs = {}  # generator ("" for pix2pix's one, "gen_ab" / "gen_ba") -> conv biases
    for k in params:
        path = k.split("/")
        if path[-1] == "bias" and path[-2].startswith("Conv"):
            convs.setdefault(path[0] if path[0].startswith("gen_") else "", []).append(k)
    return {k for keys in convs.values() for k in keys[:-1]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("i2i")
    cases = [dict(kind=kind, batches=_batches(i), kw=KW, out_root=root / kind)
             for i, kind in enumerate(("pix2pix", "cyclegan"))]
    ranks = Ranks("i2i", 2, root / "ranks", cases=cases)
    one = [i2i_case(**dict(c, out_root=root / "one" / c["kind"])) for c in cases]
    two = ranks.wait()
    return {c["kind"]: (two[0][i], two[1][i], one[i]) for i, c in enumerate(cases)}


@pytest.mark.parametrize("kind", ["pix2pix", "cyclegan"])
def test_two_ranks_train_as_one(runs, kind):
    r0, r1, one = runs[kind]
    assert r0["history"] == r1["history"]
    assert len(r0["history"]) == len(one["history"]) == 3
    for got, want in zip(r0["history"], one["history"]):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert r0["params"].keys() == one["params"].keys()
    noise = _norm_fed_biases(one["params"])
    assert noise
    for k, v in one["params"].items():
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)
        if k in noise:
            atol = 2 * LR * KW["steps"]
        else:
            atol = 1e-6 * np.abs(v).max() + 1e-3 * LR
        np.testing.assert_allclose(r0["params"][k], v, atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", ["pix2pix", "cyclegan"])
def test_rank_zero_alone_writes_the_checkpoint(runs, kind):
    r0, r1, one = runs[kind]
    name = "pix2pix_generator.ckpt" if kind == "pix2pix" else "cyclegan_generators.ckpt"
    assert r0["files"] == one["files"] == [name]
    assert r1["files"] == [] and r1["checkpoint"] is None
