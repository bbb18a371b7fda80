"""The multi-host rule on two torchrun nodes: four gloo CPU ranks as two nodes
of two (``GROUP_RANK`` 0 and 1, ``LOCAL_WORLD_SIZE`` 2) against a genuine
two-process JAX run: two JAX processes of two CPU devices each, joined by
``jax.distributed.initialize`` on localhost (gloo CPU collectives), each
feeding its own rows through the JAX package's ``put_batch``
(``make_array_from_process_local_data``) into the step on the four-device
mesh. Both sides feed node / process n the same rows, so the global batch
is node 0's rows, then node 1's, on both.

One spawn of the four ranks runs every port case (``test_torch_parallel_ranks.
nodes_case``) while the two JAX processes run this module's ``_jax_process``
(``python -m tests.test_torch_parallel_nodes <process> <port> <dir>``) and
the parent computes the port's one-process runs on the 8 rows.

- **The draws.** ``train()`` on the two nodes: each node's ``PatchSampler``
  is seeded ``seed + node`` and its first batch equals the JAX sampler's that
  each JAX process seeds ``seed + jax.process_index()``, over the JAX
  package's cache of the same files; both ranks of a node draw the same
  rows, the two nodes different ones. The first rank of each node writes the
  run's files, and every rank holds the same history.
- **The f32 step.** Two steps of a narrow 3D UNet (channels 4-8-16, the
  port's seeded weights on both sides, SGD with momentum, no augmentation) on the (4, 1) mesh, each node passing its own
  batch of 4: against the JAX step of the two processes and the port's
  one-process step on the 8 rows, within ``test_torch_parallel_step``'s
  limits (loss rtol 1e-5; parameters and running statistics rtol 1e-4 / atol
  1e-5).
- **pix2pix.** Two iterations on the two nodes from the same weights (the
  port's seeded init, handed to both trainers' seams), each node passing its own batch of 4 slices: against
  the two JAX processes' ``train_pix2pix`` within ``test_torch_i2i_train``'s
  limits (each loss 1e-4 relative; each generator tensor 1e-5 * max|p| + 2.5
  * lr a step), and against the port's one-process run on the 8 rows within
  ``test_torch_parallel_i2i``'s (1e-6 * max|p| + 1e-3 * lr, the norm-fed
  biases 2 * lr a step).
- **The model axis** stays inside a node: ``make_mesh(model=4)`` over two
  nodes of two raises.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from segmantic_tpu.data import cache as jcache
from segmantic_tpu.data.dataset import PairedDataSet as JPairedDataSet
from segmantic_tpu.i2i import models as jm
from segmantic_tpu.i2i import train as jtrain
from segmantic_tpu.models.unet import UNet as FlaxUNet
from segmantic_tpu.parallel import mesh as jmesh
from segmantic_tpu.train import trainer as jtrainer
from segmantic_tpu_torch.i2i import train as ttrain
from tests.test_torch_parallel_i2i import _norm_fed_biases
from tests.test_torch_parallel_ranks import (
    REPO, TORCHRUN_ENV, Ranks, given_pix2pix, i2i_case, steps_case)
from tests.test_torch_parallel_step import (
    SGD, _batch, _one_thread, assert_state_close, jax_steps)
from tests.test_torch_train import phantoms  # noqa: F401  (the module fixture)

UNET = dict(spatial_dims=3, in_channels=1, out_channels=3, channels=(4, 8, 16),
            strides=(2, 2), num_res_units=1)
PATCH = (16, 16, 16)
NODE_ROWS = 4
TRAIN = dict(num_classes=4, spatial_size=(16, 16, 16), channels=(4, 8, 16), strides=(2, 2),
             mixed_precision=False, val_roi_size=(16, 16, 16), seed=5, max_epochs=1,
             batch_size=2, num_samples=2, optimizer=SGD)
LR, I2I_STEPS = 2e-4, 2
I2I_KW = dict(steps=I2I_STEPS, base_features=4, n_blocks=1, log_every=1, seed=0, lr=LR)


def _initial_weights():
    """Both sides' initial weights, drawn by the port (its own seeded init,
    bridged to flax trees): the UNet's variables and pix2pix's generator and
    discriminator params. A JAX ``init`` of them would compile for seconds
    before any process could start."""
    import torch

    from segmantic_tpu_torch.i2i import models as tm
    from segmantic_tpu_torch.models.unet import UNet, to_flax_variables

    torch.manual_seed(0)
    unet = to_flax_variables(UNet(**UNET).state_dict())
    gen = tm.ResnetGenerator(1, 1, 4, 1, 2, generator=torch.Generator().manual_seed(1))
    disc = tm.PatchDiscriminator(2, 4, spatial_dims=2, generator=torch.Generator().manual_seed(2))
    init = {"gen": tm.to_flax_variables(gen.state_dict())["params"],
            "disc": tm.to_flax_variables(disc.state_dict())["params"]}
    return unet, init


def _given(cls, params):
    """``cls`` (a JAX i2i network) whose ``init`` returns ``params``: the JAX
    trainer starts from the weights both sides were given."""

    class Given(cls):
        def init(self, *args, **kw):
            return {"params": params}

    return Given


def _slices(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (NODE_ROWS, 16, 16, 1)).astype(np.float32)
    return a, (-a * 0.5 + 0.1).astype(np.float32)


def _jax_process(process: int, port: int, tmp: Path) -> None:
    """One JAX process of the reference: two CPU devices, joined to the other
    process; its own rows of the step, of pix2pix and of the sampler."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                               process_id=process)
    kw = pickle.loads((tmp / "jax_in.pkl").read_bytes())
    me = jax.process_index()
    out = {"layout": (me, jax.process_count(), jax.device_count())}
    out["step"] = jax_steps(FlaxUNet(**UNET), kw["variables"], kw["image"][me],
                            kw["label"][me], PATCH, 2, jmesh.make_mesh())
    real = jtrain.ResnetGenerator, jtrain.PatchDiscriminator
    jtrain.ResnetGenerator = _given(jm.ResnetGenerator, kw["init"]["gen"])
    jtrain.PatchDiscriminator = _given(jm.PatchDiscriminator, kw["init"]["disc"])
    try:
        result = jtrain.train_pix2pix(iter([kw["slices"][me]]), **I2I_KW)
    finally:
        jtrain.ResnetGenerator, jtrain.PatchDiscriminator = real
    out["i2i"] = (result.history, {"/".join(k): np.asarray(v)
                                   for k, v in _flat(result.generator_params)})
    dataset = JPairedDataSet(kw["root"] / "image", "*.nii.gz", kw["root"] / "label", "*.nii.gz",
                             random_seed=TRAIN["seed"])
    cache = jcache.VolumeCache(dataset.training_files(),
                               jtrainer.default_preprocessing(["image", "label"], ()),
                               TRAIN["num_classes"])
    out["draws"] = [np.asarray(a) for a in jcache.PatchSampler(
        cache, patch_size=TRAIN["spatial_size"],
        batch_size=TRAIN["batch_size"] * TRAIN["num_samples"],
        num_samples=TRAIN["num_samples"], margin=0, seed=TRAIN["seed"] + me,
        image_wire_dtype=np.float32).sample_batch()]
    (tmp / f"jax{process}.pkl").write_bytes(pickle.dumps(out))


def _start_jax(tmp: Path, **inputs):
    """The two JAX processes of the reference, started."""
    (tmp / "jax_in.pkl").write_bytes(pickle.dumps(inputs))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = []
    for process in range(2):
        with open(tmp / f"jax{process}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.test_torch_parallel_nodes", str(process),
                 str(port), str(tmp)], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def _wait_jax(procs, tmp: Path):
    for process, proc in enumerate(procs):
        try:
            rc = proc.wait(timeout=240)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            rc = "timeout"
        if rc != 0:
            raise RuntimeError(f"JAX process {process} ({rc}):\n"
                               + (tmp / f"jax{process}.log").read_text()[-3000:])
    return [pickle.loads((tmp / f"jax{p}.pkl").read_bytes()) for p in range(2)]


@pytest.fixture(scope="module")
def runs(phantoms, tmp_path_factory):  # noqa: F811
    root, _, _ = phantoms
    tmp = tmp_path_factory.mktemp("nodes")
    variables, init = _initial_weights()
    # the f32 step: each node's batch, and the global batch in node order
    node_batches = [_batch(NODE_ROWS, PATCH, 3, seed=10 + n) for n in range(2)]
    image = np.concatenate([b[0] for b in node_batches])
    label = np.concatenate([b[1] for b in node_batches])
    step_kw = dict(arch="unet", model_kw=UNET, variables=variables, patch=PATCH, n_steps=2,
                   optimizer=SGD)
    # pix2pix: each node's slices, the global batch, the JAX init
    slices = [_slices(20 + n) for n in range(2)]
    src = np.concatenate([s[0] for s in slices])
    dst = np.concatenate([s[1] for s in slices])
    data = dict(image_dir=root / "image", labels_dir=root / "label")
    jax_procs = _start_jax(tmp, variables=variables, image=[b[0] for b in node_batches],
                           label=[b[1] for b in node_batches], slices=slices, init=init,
                           root=root)
    ranks = Ranks("nodes", 4, tmp / "ranks", nodes=2,
                  steps=[dict(step_kw, image=[b[0] for b in node_batches],
                              label=[b[1] for b in node_batches])],
                  i2i=[dict(init=init, batches=[[s] for s in slices], kw=I2I_KW,
                            out_root=tmp / "i2i")],
                  train=[dict(kw=dict(TRAIN, **data), out_root=tmp / "train")],
                  refuse_model=4)
    out = {"one_step": _one_thread(steps_case, **dict(step_kw, image=image, label=label,
                                                      mesh=False))}
    real = ttrain._init_pix2pix
    ttrain._init_pix2pix = given_pix2pix(init)
    try:
        out["one_i2i"] = _one_thread(i2i_case, kind="pix2pix", batches=[(src, dst)],
                                     kw=I2I_KW, out_root=tmp / "one")
    finally:
        ttrain._init_pix2pix = real
    out["jax"] = _wait_jax(jax_procs, tmp)
    out["nodes"] = ranks.wait()
    return out


def test_ranks_know_their_node(runs):
    nodes = runs["nodes"]
    assert [r["local_world_size"] for r in nodes] == ["2"] * 4
    assert [(r["process_index"], r["process_count"], r["data_index"]) for r in nodes] == [
        (0, 2, 0), (0, 2, 1), (1, 2, 2), (1, 2, 3)]
    assert [r["main"] for r in nodes] == [r["main_no_mesh"] for r in nodes] == [
        True, False, True, False]


def test_each_node_draws_the_jax_samplers_rows_seeded_seed_plus_node(runs):
    nodes = runs["nodes"]
    for rank, r in enumerate(nodes):
        (drawn,) = r["train"][0]["drawn"]
        node = rank // 2
        assert drawn["seed"] == TRAIN["seed"] + node
        want = runs["jax"][node]["draws"]
        np.testing.assert_array_equal(drawn["batch"][0], want[0])
        np.testing.assert_array_equal(drawn["batch"][1], want[1])
    assert not np.array_equal(nodes[0]["train"][0]["drawn"][0]["batch"][0],
                              nodes[2]["train"][0]["drawn"][0]["batch"][0])


def test_two_nodes_train_and_the_first_rank_of_each_writes(runs):
    nodes = runs["nodes"]
    history = nodes[0]["train"][0]["history"]
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    assert np.isfinite(history[0]["val_loss"])
    for r in nodes[1:]:
        for got, want in zip(r["train"][0]["history"], history):
            for key in ("train_loss", "val_loss", "val_dice", "lr"):
                assert got[key] == want[key], key
    # the TensorBoard file names carry the time: compare the directories
    written = [{f.split("/")[0] for f in r["train"][0]["files"]} for r in nodes]
    assert {"Dataset.json", "history.json", "last.ckpt", "logs"} <= written[0]
    assert written[2] == written[0] and written[1] == written[3] == set()


def test_the_f32_step_on_two_nodes_matches_the_jax_mesh_and_one_process(runs):
    got = [r["steps"][0] for r in runs["nodes"]]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        for k in got[0]["state"]:
            np.testing.assert_array_equal(r["state"][k], got[0]["state"][k], err_msg=k)
    (j0, j1) = runs["jax"]
    assert j0["layout"] == (0, 2, 4) and j1["layout"] == (1, 2, 4)
    assert j0["step"][0] == j1["step"][0]
    jax_losses, jax_state = j0["step"]
    np.testing.assert_allclose(got[0]["losses"], jax_losses, rtol=1e-5)
    np.testing.assert_allclose(got[0]["losses"], runs["one_step"]["losses"], rtol=1e-5)
    assert_state_close(got[0]["state"], jax_state)
    assert_state_close(got[0]["state"], runs["one_step"]["state"])


def test_pix2pix_on_two_nodes_matches_the_jax_trainer_and_one_process(runs):
    got = [r["i2i"][0] for r in runs["nodes"]]
    (want_history, jax_params), one = runs["jax"][0]["i2i"], runs["one_i2i"]
    assert runs["jax"][1]["i2i"][0] == want_history
    for r in got[1:]:
        assert r["history"] == got[0]["history"]
    assert len(got[0]["history"]) == len(want_history) == I2I_STEPS
    for g, o, w in zip(got[0]["history"], one["history"], want_history):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=key)
            np.testing.assert_allclose(g[key], o[key], rtol=1e-4, err_msg=key)
    noise = _norm_fed_biases(one["params"])
    assert sorted(got[0]["params"]) == sorted(jax_params) == sorted(one["params"])
    for k, v in jax_params.items():
        atol = 1e-5 * np.abs(v).max() + I2I_STEPS * 2.5 * LR
        np.testing.assert_allclose(got[0]["params"][k], v, atol=atol, rtol=0, err_msg=k)
        ref = one["params"][k]
        atol = 2 * LR * I2I_STEPS if k in noise else 1e-6 * np.abs(ref).max() + 1e-3 * LR
        np.testing.assert_allclose(got[0]["params"][k], ref, atol=atol, rtol=0, err_msg=k)
    assert [r["files"] for r in got] == [["pix2pix_generator.ckpt"], [],
                                         ["pix2pix_generator.ckpt"], []]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_the_model_axis_stays_inside_a_node(runs):
    for r in runs["nodes"]:
        assert r["refused"] and "LOCAL_WORLD_SIZE" in r["refused"]


if __name__ == "__main__":
    _jax_process(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
