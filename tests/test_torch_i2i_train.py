"""The port's pix2pix and CycleGAN trainers (``segmantic_tpu_torch/i2i/train.py``)
against the JAX package's, from the same weights.

Both packages train 3 iterations (base 4, 1 block, batches of 4 x 16^2,
``log_every=1``) from the JAX init: the test computes flax's ``init`` with the
trainer's key and hands it to the port through its seam (``_init_pix2pix`` /
``_init_cyclegan``). pix2pix reads a generator that runs dry after two
batches (the third iteration reuses the last batch), CycleGAN a list of two
(the third iteration restarts it). Held:

- the history: the same steps and keys, each loss within 1e-4 relative;
- the final generator parameters, per tensor within
  1e-5 * max|p| + 3 * 2.5 * lr: Adam normalises each update to about lr, so a
  gradient that is rounding noise in both packages (the conv biases in front
  of an InstanceNorm, whose true gradient is zero) moves by up to about lr a
  step in a direction neither package controls;
- the generator's output on a batch: pix2pix within 1e-4 * max|ref|;
  CycleGAN within 5e-3 * max|ref|, because some of its kernel entries have a
  true gradient below f32's rounding of the sum that forms it (3e-7 against
  terms of order 1 in ``ResnetBlock_0/Conv_0`` here: f64 says 3.2e-7, the
  port's f32 1.3e-6, XLA's 1.5e-8), and Adam's first step, lr * g / (|g| +
  1e-8), turns that noise into steps of 0.43 lr in one package and 0.99 lr in
  the other;
- so the loss terms are held where rounding cannot hide a fault: the
  gradients of the D step and the G step of the first iteration, the port in
  f64 against ``jax.grad`` of the reference's losses (restated from
  ``segmantic_tpu/i2i/train.py``) in f32, per tensor within 1e-4 * max(max|g|,
  1e-2 * the largest of all);
- the checkpoints both ways: the JAX ``load_generator`` reads the port's file
  and the port's reads JAX's, and ``translate_volume`` through either agrees
  within 1e-5 * max|ref| with the other package on the same file; the
  hparams are equal.

Also: the port's init draws the same weights for ``gen_ab`` / ``gen_ba`` and
``disc_a`` / ``disc_b`` (one seed, as the JAX package's one key); the G step
leaves the discriminator's gradients as the D step left them; ``lsgan_loss``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmantic_tpu.core.volume import Volume
from segmantic_tpu.i2i import data as jdata
from segmantic_tpu.i2i import models as jm
from segmantic_tpu.i2i import train as jtrain
from segmantic_tpu_torch.core.volume import Volume as TVolume
from segmantic_tpu_torch.i2i import data as tdata
from segmantic_tpu_torch.i2i import models as tm
from segmantic_tpu_torch.i2i import train as ttrain

BASE, BLOCKS, STEPS, LR, SEED = 4, 1, 3, 2e-4, 3


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _load(module, params):
    state = tm.from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, params)})
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return module


def _batches(seed: int, paired: bool):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        a = rng.uniform(-1, 1, (4, 16, 16, 1)).astype(np.float32)
        b = (-a if paired else np.tanh(rng.uniform(-2, 2, a.shape))).astype(np.float32)
        out.append((a, b))
    return out


def _runs_dry(batches):
    yield from batches


def _jax_gen(out_channels):
    return jm.ResnetGenerator(out_channels=out_channels, base_features=BASE, n_blocks=BLOCKS)


@pytest.fixture(scope="module")
def pix2pix(tmp_path_factory):
    root = tmp_path_factory.mktemp("pix2pix")
    batches = _batches(1, paired=True)
    src0, dst0 = batches[0]
    key = jax.random.key(SEED)
    g_init = _jax_gen(1).init(key, jnp.asarray(src0))["params"]
    d_init = jm.PatchDiscriminator(base_features=BASE).init(
        key, jnp.concatenate([src0, dst0], -1))["params"]
    want = jtrain.train_pix2pix(_runs_dry(batches), steps=STEPS, lr=LR, base_features=BASE,
                                n_blocks=BLOCKS, seed=SEED, output_dir=root / "jax",
                                log_every=1, extra_hparams={"slice_axis": 2})

    def carried(src0, dst0, base_features, n_blocks, seed, device):
        assert (base_features, n_blocks, seed) == (BASE, BLOCKS, SEED)
        gen = _load(tm.ResnetGenerator(1, 1, BASE, BLOCKS, 2), g_init)
        disc = _load(tm.PatchDiscriminator(2, BASE, spatial_dims=2), d_init)
        return gen.to(device), disc.to(device)

    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "_init_pix2pix", carried)
    try:
        got = ttrain.train_pix2pix(_runs_dry(batches), steps=STEPS, lr=LR, base_features=BASE,
                                   n_blocks=BLOCKS, seed=SEED, output_dir=root / "port",
                                   log_every=1, extra_hparams={"slice_axis": 2}, device="cpu")
    finally:
        mp.undo()
    return want, got, batches


@pytest.fixture(scope="module")
def cyclegan(tmp_path_factory):
    root = tmp_path_factory.mktemp("cyclegan")
    batches = _batches(2, paired=False)
    a0, b0 = batches[0]
    key = jax.random.key(SEED)
    init = {"gen_ab": _jax_gen(1).init(key, jnp.asarray(a0))["params"],
            "gen_ba": _jax_gen(1).init(key, jnp.asarray(b0))["params"],
            "disc_a": jm.PatchDiscriminator(base_features=BASE).init(key, a0)["params"],
            "disc_b": jm.PatchDiscriminator(base_features=BASE).init(key, b0)["params"]}
    want = jtrain.train_cyclegan(batches, steps=STEPS, lr=LR, base_features=BASE,
                                 n_blocks=BLOCKS, seed=SEED, output_dir=root / "jax",
                                 log_every=1, extra_hparams={"slice_axis": 2})

    def carried(a0, b0, base_features, n_blocks, seed, device):
        nets = {"gen_ab": tm.ResnetGenerator(1, 1, BASE, BLOCKS, 2),
                "gen_ba": tm.ResnetGenerator(1, 1, BASE, BLOCKS, 2),
                "disc_a": tm.PatchDiscriminator(1, BASE, spatial_dims=2),
                "disc_b": tm.PatchDiscriminator(1, BASE, spatial_dims=2)}
        return {k: _load(v, init[k]).to(device) for k, v in nets.items()}

    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "_init_cyclegan", carried)
    try:
        got = ttrain.train_cyclegan(batches, steps=STEPS, lr=LR, base_features=BASE,
                                    n_blocks=BLOCKS, seed=SEED, output_dir=root / "port",
                                    log_every=1, extra_hparams={"slice_axis": 2}, device="cpu")
    finally:
        mp.undo()
    return want, got, batches


@pytest.fixture(params=["pix2pix", "cyclegan"])
def run(request):
    return request.param, request.getfixturevalue(request.param)


def test_history_matches(run):
    name, (want, got, _) = run
    assert [sorted(r) for r in got.history] == [sorted(r) for r in want.history]
    assert [r["step"] for r in got.history] == list(range(STEPS))
    for rw, rg in zip(want.history, got.history):
        for k in rw:
            assert rg[k] == pytest.approx(rw[k], rel=1e-4), (name, rw["step"], k)


def _generators(params, name):
    return params.items() if name == "cyclegan" else [("gen", params)]


def test_final_generator_params_match(run):
    name, (want, got, _) = run
    assert sorted(got.generator_params) == sorted(want.generator_params)
    for which, wparams in _generators(want.generator_params, name):
        gparams = got.generator_params if name == "pix2pix" else got.generator_params[which]
        g, w = dict(_flat(gparams)), dict(_flat(wparams))
        assert set(g) == set(w)
        for path, arr in w.items():
            assert g[path].shape == arr.shape and g[path].dtype == np.float32
            err = np.abs(g[path] - arr).max()
            assert err <= 1e-5 * np.abs(arr).max() + STEPS * 2.5 * LR, (which, path, err)


def test_trained_generators_agree(run):
    name, (want, got, batches) = run
    x = batches[1][0]
    limit = {"pix2pix": 1e-4, "cyclegan": 5e-3}[name]
    for which, wparams in _generators(want.generator_params, name):
        gparams = got.generator_params if name == "pix2pix" else got.generator_params[which]
        ref = np.asarray(_jax_gen(1).apply({"params": wparams}, x))
        out = _load(tm.ResnetGenerator(1, 1, BASE, BLOCKS, 2), gparams)(torch.from_numpy(x))
        assert np.abs(out.detach().numpy() - ref).max() <= limit * np.abs(ref).max(), which


def _jax_losses(name, gen_p, disc_p, a, b):
    """(D loss of the D params, G loss of the G params) as the reference's
    ``d_step`` / ``g_step`` compute them (``segmantic_tpu/i2i/train.py``)."""
    gen, disc = _jax_gen(1), jm.PatchDiscriminator(base_features=BASE)
    g = lambda p, x: gen.apply({"params": p}, x)  # noqa: E731
    d = lambda p, x: disc.apply({"params": p}, x)  # noqa: E731
    if name == "pix2pix":
        fake = g(gen_p, a)

        def d_loss(dp):
            return 0.5 * (jtrain.lsgan_loss(d(dp, jnp.concatenate([a, b], -1)), True)
                          + jtrain.lsgan_loss(d(dp, jnp.concatenate([a, fake], -1)), False))

        def g_loss(gp):
            f = g(gp, a)
            adv = jtrain.lsgan_loss(d(disc_p, jnp.concatenate([a, f], -1)), True)
            return adv + 100.0 * jnp.mean(jnp.abs(f - b))

        return d_loss, g_loss
    fake_b, fake_a = g(gen_p["gen_ab"], a), g(gen_p["gen_ba"], b)

    def d_loss(dp):
        loss = jtrain.lsgan_loss(d(dp["disc_b"], b), True)
        loss += jtrain.lsgan_loss(d(dp["disc_b"], fake_b), False)
        loss += jtrain.lsgan_loss(d(dp["disc_a"], a), True)
        loss += jtrain.lsgan_loss(d(dp["disc_a"], fake_a), False)
        return 0.5 * loss

    def g_loss(gp):
        fb, fa = g(gp["gen_ab"], a), g(gp["gen_ba"], b)
        adv = jtrain.lsgan_loss(d(disc_p["disc_b"], fb), True)
        adv += jtrain.lsgan_loss(d(disc_p["disc_a"], fa), True)
        cyc = (jnp.mean(jnp.abs(g(gp["gen_ba"], fb) - a))
               + jnp.mean(jnp.abs(g(gp["gen_ab"], fa) - b)))
        idt = jnp.mean(jnp.abs(g(gp["gen_ab"], b) - b)) + jnp.mean(jnp.abs(g(gp["gen_ba"], a) - a))
        return adv + 10.0 * cyc + 10.0 * 0.5 * idt

    return d_loss, g_loss


@pytest.mark.parametrize("name", ["pix2pix", "cyclegan"])
def test_step_gradients_match_jax_in_f64(name):
    """One iteration at lr 0 (D unchanged, so the G step sees the init's D):
    every D and G gradient of the port's steps in f64 against ``jax.grad``."""
    a, b = _batches(3, paired=(name == "pix2pix"))[0]
    rng = np.random.default_rng(11)
    key = jax.random.key(SEED)
    gen, disc = _jax_gen(1), jm.PatchDiscriminator(base_features=BASE)
    if name == "pix2pix":
        gen_p = gen.init(key, a)["params"]
        disc_p = disc.init(key, np.concatenate([a, b], -1))["params"]
        nets = {"gen": _load(tm.ResnetGenerator(1, 1, BASE, BLOCKS, 2), gen_p),
                "disc": _load(tm.PatchDiscriminator(2, BASE, spatial_dims=2), disc_p)}
    else:
        # two different draws for the two generators and discriminators
        keys = jax.random.split(key, 4)
        gen_p = {"gen_ab": gen.init(keys[0], a)["params"], "gen_ba": gen.init(keys[1], b)["params"]}
        disc_p = {"disc_a": disc.init(keys[2], a)["params"],
                  "disc_b": disc.init(keys[3], b)["params"]}
        nets = {k: _load(tm.ResnetGenerator(1, 1, BASE, BLOCKS, 2), v) for k, v in gen_p.items()}
        nets.update({k: _load(tm.PatchDiscriminator(1, BASE, spatial_dims=2), v)
                     for k, v in disc_p.items()})
    nets = {k: v.double() for k, v in nets.items()}
    gens = [v for k, v in nets.items() if k.startswith("gen")]
    discs = [v for k, v in nets.items() if k.startswith("disc")]
    g_opt = ttrain._make_optim([p for n in gens for p in n.parameters()], 0.0)
    d_opt = ttrain._make_optim([p for n in discs for p in n.parameters()], 0.0)
    if name == "pix2pix":
        d_step, g_step = ttrain.make_pix2pix_steps(nets["gen"], nets["disc"], g_opt, d_opt, 100.0)
    else:
        d_step, g_step = ttrain.make_cyclegan_steps(nets, g_opt, d_opt, 10.0, 0.5)
    ta, tb = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    d_port = float(d_step(ta, tb))
    g_port = float(g_step(ta, tb)[0])
    d_loss, g_loss = _jax_losses(name, gen_p, disc_p, a, b)
    d_ref, d_grad = jax.jit(jax.value_and_grad(d_loss))(disc_p)
    g_ref, g_grad = jax.jit(jax.value_and_grad(g_loss))(gen_p)
    assert d_port == pytest.approx(float(d_ref), rel=1e-5)
    assert g_port == pytest.approx(float(g_ref), rel=1e-5)
    for ref_tree, group in ((d_grad, "disc"), (g_grad, "gen")):
        if name == "pix2pix":
            ref_tree = {group: ref_tree}
        want = {(k,) + p: g for k, t in ref_tree.items() for p, g in _flat(t)}
        got = {(k,) + p: g for k, t in ((k, tm.to_flax_variables(
            {n: q.grad for n, q in nets[k].named_parameters()})["params"])
            for k in ref_tree) for p, g in _flat(t)}
        assert set(got) == set(want)
        floor = 1e-2 * max(np.abs(g).max() for g in want.values())
        for path, g in want.items():
            err = np.abs(got[path] - g).max()
            assert err <= 1e-4 * max(np.abs(g).max(), floor), (path, err, np.abs(g).max())


def test_checkpoints_cross_both_ways(run):
    name, (want, got, _) = run
    assert got.checkpoint.name == want.checkpoint.name
    rng = np.random.default_rng(9)
    data = rng.uniform(0, 500, (1, 12, 16, 5)).astype(np.float32)
    jvol = Volume(data, np.eye(4))
    tvol = TVolume(data, np.eye(4))
    kw = dict(axis=2, batch_size=4, output_window=(0.0, 100.0))
    for direction in (["ab", "ba"] if name == "cyclegan" else ["ab"]):
        for ckpt in (want.checkpoint, got.checkpoint):
            japply, jh = jdata.load_generator(ckpt, direction=direction)
            tapply, th = tdata.load_generator(ckpt, direction=direction, device="cpu")
            assert th == jh
            ref = jdata.translate_volume(japply, jvol, **kw).numpy()
            out = tdata.translate_volume(tapply, tvol, **kw)
            assert out.spatial_shape == tvol.spatial_shape
            assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), (ckpt, direction)
    from segmantic_tpu.train.checkpoint import load_checkpoint as jload

    jc, tc = jload(want.checkpoint), jload(got.checkpoint)
    assert tc["hparams"] == jc["hparams"]
    assert sorted(tc["metrics"]) == sorted(jc["metrics"])
    assert jax.tree_util.tree_structure(tc["variables"]) == jax.tree_util.tree_structure(
        jc["variables"])


def test_init_draws_one_seed_for_all_networks():
    a0 = np.zeros((2, 16, 16, 1), np.float32)
    nets = ttrain._init_cyclegan(a0, a0, 4, 1, seed=5, device="cpu")
    for x, y in (("gen_ab", "gen_ba"), ("disc_a", "disc_b")):
        sa, sb = nets[x].state_dict(), nets[y].state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    again = ttrain._init_cyclegan(a0, a0, 4, 1, seed=5, device="cpu")["gen_ab"].state_dict()
    other = ttrain._init_cyclegan(a0, a0, 4, 1, seed=6, device="cpu")["gen_ab"].state_dict()
    assert all(torch.equal(v, again[k]) for k, v in nets["gen_ab"].state_dict().items())
    assert not torch.equal(other["Conv_0.weight"], again["Conv_0.weight"])
    gen, disc = ttrain._init_pix2pix(a0, a0, 4, 1, seed=5, device="cpu")
    assert torch.equal(gen.Conv_0.weight, nets["gen_ab"].Conv_0.weight)
    assert disc.Conv_0.weight.shape[1] == 2


def test_g_step_leaves_the_discriminator_gradients_alone():
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32))
    dst = -src
    gen, disc = ttrain._init_pix2pix(src.numpy(), dst.numpy(), 4, 1, seed=0, device="cpu")
    g_opt, d_opt = ttrain._make_optim(gen.parameters(), LR), ttrain._make_optim(
        disc.parameters(), LR)
    d_step, g_step = ttrain.make_pix2pix_steps(gen, disc, g_opt, d_opt, 100.0)
    d_step(src, dst)
    assert all(p.grad is None for p in gen.parameters())
    d_grads = [p.grad.clone() for p in disc.parameters()]
    d_params = [p.detach().clone() for p in disc.parameters()]
    g_step(src, dst)
    assert all(torch.equal(p.grad, g) for p, g in zip(disc.parameters(), d_grads))
    assert all(torch.equal(p, q) for p, q in zip(disc.parameters(), d_params))
    assert all(p.requires_grad for p in disc.parameters())
    assert all(p.grad is not None for p in gen.parameters())


def test_lsgan_loss_matches():
    x = np.random.default_rng(2).standard_normal((3, 4, 4, 1)).astype(np.float32)
    for real in (True, False):
        want = float(jtrain.lsgan_loss(jnp.asarray(x), real))
        assert float(ttrain.lsgan_loss(torch.from_numpy(x), real)) == pytest.approx(want, rel=1e-6)
