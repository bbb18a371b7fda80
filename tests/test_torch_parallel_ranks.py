"""Ranks for the port's multi-rank tests, and the mesh's own rules.

:func:`run_ranks` runs one of this module's ``CASES`` on ``world`` gloo CPU
ranks, each a ``python -m tests.test_torch_parallel_ranks`` subprocess (about
4.5 s for two ranks that import torch): the keyword arguments go to every rank
pickled, each rank returns its result pickled, and the process group meets in
a file store under the test's temporary directory. With ``nodes`` > 1 the
ranks are that many torchrun nodes of ``world // nodes`` ranks each, numbered
node by node: each rank passes ``local_world_size`` to
``initialize_distributed``, which exports it as torchrun's ``LOCAL_WORLD_SIZE``. This module imports torch and the port only, so the ranks
never load JAX; the ``tests/test_torch_parallel_*`` files hold the JAX side.
The tests here need no second rank: the placement rules on a mesh object,
``put_batch`` (on one node and on several) and the world of one.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import pytest
import torch

from segmantic_tpu_torch.models.unet import UNet, from_flax_variables
from segmantic_tpu_torch.parallel import mesh as pmesh

REPO = Path(__file__).resolve().parent.parent
# what torchrun sets for a rank; a test's ranks get none of it from the parent
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "GROUP_RANK", "GROUP_WORLD_SIZE", "LOCAL_WORLD_SIZE")


class Ranks:
    """``CASES[case](**kw)`` started on ``world`` gloo ranks; :meth:`wait`
    returns each rank's result, rank 0 first, or raises with the ranks'
    output if any rank fails. The caller may compute meanwhile."""

    def __init__(self, case: str, world: int, tmp: Path, nodes: int = 1, **kw):
        self.tmp = Path(tmp)
        self.tmp.mkdir(parents=True, exist_ok=True)
        (self.tmp / "in.pkl").write_bytes(pickle.dumps(kw))
        env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        self.procs = []
        for rank in range(world):
            with open(self.tmp / f"rank{rank}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.test_torch_parallel_ranks", case, str(rank),
                     str(world), str(self.tmp), str(nodes)], cwd=REPO, env=env, stdout=log,
                    stderr=subprocess.STDOUT))

    def wait(self, timeout: float = 240) -> List[Any]:
        failed = []
        for rank, proc in enumerate(self.procs):
            try:
                rc = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                rc = "timeout"
            if rc != 0:
                failed.append(f"rank {rank} ({rc}):\n"
                              + (self.tmp / f"rank{rank}.log").read_text()[-3000:])
        if failed:
            raise RuntimeError("\n".join(failed))
        return [pickle.loads((self.tmp / f"out{rank}.pkl").read_bytes())
                for rank in range(len(self.procs))]


def run_ranks(case: str, world: int, tmp: Path, **kw) -> List[Any]:
    """:class:`Ranks` started and waited for."""
    return Ranks(case, world, tmp, **kw).wait()


# -- the cases ---------------------------------------------------------------


def build_model(arch: str, model_kw: Dict, variables: Dict) -> torch.nn.Module:
    """The port's module of ``arch`` with the flax ``variables`` (f32, CPU)."""
    if arch == "unet":
        module = UNet(**model_kw)
    elif arch == "segresnet":
        from segmantic_tpu_torch.models.segresnet import SegResNet

        module = SegResNet(**model_kw)
    elif arch == "unetr":
        from segmantic_tpu_torch.models.unetr import UNETR

        module = UNETR(**model_kw)
    else:
        raise ValueError(arch)
    state = from_flax_variables(variables)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return module.train().requires_grad_(True)


def steps_case(arch, model_kw, variables, image, label, patch, n_steps=2,
               optimizer=None, aug=None, accumulate_steps=1, remat=False, zero=False,
               model=1, mesh=True, seed=0, record_augment=False):
    """``n_steps`` of ``make_train_step`` on the same global batch: the
    losses, the whole state (gathered), this rank's parameter shapes, the
    optimizer moments' bytes on this rank and, with ``record_augment``, the
    (batch, spatial subset) sizes the augmentation drew."""
    from segmantic_tpu_torch.train import augment, trainer
    from segmantic_tpu_torch.train.augment import AugmentConfig
    from segmantic_tpu_torch.train.optim import make_optimizer

    the_mesh = pmesh.make_mesh(model=model) if mesh else None
    module = pmesh.replicate(the_mesh, build_model(arch, model_kw, variables))
    if model > 1:
        pmesh.shard_params(the_mesh, module)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    opt = make_optimizer(module.parameters(), optimizer or {"optimizer": "SGD", "lr": 1e-2,
                                                             "momentum": 0.9})
    drawn = []
    if record_augment:
        real = augment.draw_params

        def spy(generator, cfg, batch, *rest):
            params = real(generator, cfg, batch, *rest)
            values = [np.asarray(v, np.float64) for v in vars(params).values()
                      if v is not None]
            drawn.append((batch, None if params.spatial_index is None
                          else len(params.spatial_index),
                          float(sum(np.abs(v).sum() for v in values))))
            return params

        augment.draw_params = spy
    step = trainer.make_train_step(
        module, opt, AugmentConfig(**(aug or dict(spatial=False, intensity=False,
                                                  flip_prob=0.0))),
        patch, False, generator=torch.Generator().manual_seed(seed),
        accumulate_steps=accumulate_steps, remat=remat, mesh=the_mesh, zero=zero)
    losses = [float(step(torch.from_numpy(image), torch.from_numpy(label)))
              for _ in range(n_steps)]
    state = {k: v.detach().numpy().copy()
             for k, v in pmesh.gather_params(the_mesh, module).items()}
    moments = sum(t.numel() * t.element_size() for st in opt.state.values()
                  for t in st.values() if torch.is_tensor(t) and t.ndim > 0)
    return dict(losses=losses, state=state, shapes=shapes, moment_bytes=moments,
                drawn=drawn)


def steps_cases(cases):
    return [steps_case(**c) for c in cases]


def forward_case(arch, model_kw, variables, image, model=1, steps=None):
    """The eval forward of the module on a mesh with a model axis of
    ``model`` (its kernels sliced by ``shard_params``): the logits and the
    sliced keys; with ``steps``, :func:`steps_case` of those keywords too."""
    the_mesh = pmesh.make_mesh(model=model)
    module = pmesh.replicate(the_mesh, build_model(arch, model_kw, variables))
    sliced = pmesh.shard_params(the_mesh, module) if model > 1 else {}
    with torch.no_grad():
        logits = module.eval()(torch.from_numpy(image)).numpy()
    out = dict(logits=logits, sliced=sorted(sliced))
    if steps is not None:
        out["steps"] = steps_case(**steps)
    return out


def forward_cases(cases):
    return [forward_case(**c) for c in cases]


def norm_case(x, groups, weight, dtype="float32"):
    """Cross-rank BatchNorm on this rank's rows of x (cast to ``dtype``):
    output, input gradient of sum(y * weight) (this rank's rows of both) and
    running statistics."""
    from segmantic_tpu_torch.models.unet import BatchNorm, cross_rank_norm

    the_mesh = pmesh.make_mesh()
    rows = torch.from_numpy(pmesh.put_batch(the_mesh, x)).to(getattr(torch, dtype))
    rows.requires_grad_(True)
    c = x.shape[-1] // groups
    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
    with cross_rank_norm(bn, the_mesh.data_group):
        y = bn(rows, groups=groups)
        (y.float() * torch.from_numpy(pmesh.put_batch(the_mesh, weight))).sum().backward()
    return dict(y=y.detach().float().numpy(), dx=rows.grad.float().numpy(),
                mean=bn.running_mean.numpy().copy(), var=bn.running_var.numpy().copy(),
                stat_dtype=str(bn.running_mean.dtype))


def no_flips(trainer):
    """Make ``trainer.train`` build its augmentation without flips (the one
    random draw left with the augmentation off), so one rank's stream and
    two ranks' streams give the same batches; returns the undo."""
    import functools

    real = trainer.AugmentConfig
    trainer.AugmentConfig = functools.partial(real, flip_prob=0.0)
    return lambda: setattr(trainer, "AugmentConfig", real)


def train_case(kw, out_root):
    """``train(**kw)`` (without flips) with ``output_dir`` per rank; the history
    and the files each rank wrote."""
    import torch.distributed as dist

    from segmantic_tpu_torch.train import trainer

    out = Path(out_root) / f"rank{dist.get_rank()}"
    undo = no_flips(trainer)
    try:
        result = trainer.train(output_dir=out, device="cpu", **kw)
    finally:
        undo()
    return dict(history=result.history,
                files=sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()),
                best=str(result.best_checkpoint) if result.best_checkpoint else None,
                state={k: v.numpy().copy() for k, v in result.model.module.state_dict().items()})


def sw_cases(cases):
    """``sliding_window_inference`` (with the mesh of all ranks) or, with
    ``direct``, ``sliding_window_inference_sharded``, per case; the predictor
    adds a ramp along the window's first axis, and records its batch sizes."""
    from segmantic_tpu_torch.infer import sliding_window as sw

    the_mesh = pmesh.make_mesh()
    calls = []

    def predictor(w):
        calls.append(w.shape[0])
        w = w.float()
        ramp = torch.arange(w.shape[1], dtype=torch.float32).reshape(
            (1, -1) + (1,) * (w.ndim - 2))
        return torch.cat([w * 2.0 + ramp * 0.01, -w, w * w], dim=-1)

    out = []
    for c in cases:
        calls.clear()
        kw = dict(overlap=c.get("overlap", 0.25), mode=c.get("mode", "gaussian"), device="cpu")
        if c.get("direct"):
            got = sw.sliding_window_inference_sharded(c["volume"], c["roi"], c["sw_batch"],
                                                      predictor, the_mesh, **kw)
        else:
            got = sw.sliding_window_inference(c["volume"], c["roi"], c["sw_batch"], predictor,
                                              mesh=the_mesh if c.get("mesh", True) else None,
                                              shard_volume=c.get("shard_volume", False), **kw)
        out.append(dict(result=got.numpy(), batches=list(calls)))
    return out


def predict_case(ckpt, images, labels, out_root, predict_kw, models=None, roi=None,
                 mesh=True):
    """``predict(mesh=)`` with an f32 forward, and ``ensemble_evaluate(mesh=)``
    over ``models`` checkpoints on ``images[0]``; rank-specific output
    directories (``mesh=False``: the mesh-less calls, one process)."""
    import torch.distributed as dist

    from segmantic_tpu_torch.infer import ensemble, predict
    from segmantic_tpu_torch.train import trainer

    f32 = lambda module: trainer.make_val_forward(module, torch.float32)  # noqa: E731
    real, predict.make_val_forward = predict.make_val_forward, f32
    the_mesh = pmesh.make_mesh() if mesh else None
    out = Path(out_root) / f"rank{dist.get_rank() if mesh else 0}"
    try:
        results = predict.predict(ckpt, images, labels, output_dir=out, mesh=the_mesh,
                                  save_confusion_plots=False, device="cpu", **predict_kw)
    finally:
        predict.make_val_forward = real
    preds = [predict.read_volume(r.saved_to).numpy() if r.saved_to else None for r in results]
    ens = None
    if models:
        loaded = [trainer.SegmentationModel.load(m, device="cpu") for m in models]
        pre = trainer.default_preprocessing(["image"], predict_kw.get("spacing", ()))
        sample = pre({"image": Path(images[0])})
        work = ensemble.ensemble_evaluate(loaded, sample, roi, sw_batch_size=3,
                                          forwards=[f32(m.module) for m in loaded],
                                          mesh=the_mesh)
        ens = [work[f"pred{i}"].numpy() for i in range(len(loaded))]
    return dict(dice=[r.dice for r in results], preds=preds, ensemble=ens,
                files=sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
                if out.exists() else [])


def i2i_case(kind, batches, kw, out_root):
    """``train_pix2pix`` / ``train_cyclegan`` over the mesh of all ranks (one
    without a process group), ``output_dir`` per rank."""
    import torch.distributed as dist

    from segmantic_tpu_torch.i2i import train as i2i

    fn = i2i.train_pix2pix if kind == "pix2pix" else i2i.train_cyclegan
    rank = dist.get_rank() if dist.is_initialized() else 0
    out = Path(out_root) / f"rank{rank}"
    result = fn(batches, device="cpu", output_dir=out, **kw)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(result.generator_params, ())
    return dict(history=result.history, params=flat,
                checkpoint=str(result.checkpoint) if result.checkpoint else None,
                files=sorted(p.name for p in out.rglob("*") if p.is_file())
                if out.exists() else [])


def i2i_cases(cases):
    return [i2i_case(**c) for c in cases]


def norm_cases(cases):
    return [norm_case(**c) for c in cases]


def train_cases(cases):
    return [train_case(**c) for c in cases]


def sampler_spy(trainer):
    """Make ``trainer.train`` build a ``PatchSampler`` that records its seed
    and its first batch; returns (the records, the undo)."""
    real = trainer.PatchSampler
    drawn = []

    class Recording(real):
        def __init__(self, *args, seed=0, **kw):
            super().__init__(*args, seed=seed, **kw)
            self._record = {"seed": seed, "batch": None}
            drawn.append(self._record)

        def sample_batch(self):
            image, label = super().sample_batch()
            if self._record["batch"] is None:
                self._record["batch"] = (np.array(image), np.array(label))
            return image, label

    trainer.PatchSampler = Recording
    return drawn, lambda: setattr(trainer, "PatchSampler", real)


def given_pix2pix(init):
    """A stand-in for ``i2i.train._init_pix2pix`` that builds the networks
    from the flax params ``init["gen"]`` / ``init["disc"]``."""
    from segmantic_tpu_torch.i2i import models as tm

    def build(src0, dst0, base_features, n_blocks, seed, device):
        nd, cs, cd = src0.ndim - 2, src0.shape[-1], dst0.shape[-1]
        gen = tm.ResnetGenerator(cs, cd, base_features, n_blocks, nd)
        disc = tm.PatchDiscriminator(cs + cd, base_features, spatial_dims=nd)
        for net, params in ((gen, init["gen"]), (disc, init["disc"])):
            state = tm.from_flax_variables({"params": params})
            net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
        return gen.to(device), disc.to(device)

    return build


def nodes_case(steps=(), i2i=(), train=(), refuse_model=None):
    """The multi-node cases, each with its node's own inputs: ``steps``
    (``steps_case`` with ``image`` / ``label`` one per node), ``i2i``
    (``i2i_case`` with ``batches`` one per node and the flax ``init`` of the
    networks handed to the trainer's seam), ``train`` (``train_case`` with the
    sampler's seed and first batch recorded), and whether ``make_mesh(model=
    refuse_model)`` raises; with this rank's node, mesh position and
    ``is_main``."""
    from segmantic_tpu_torch.i2i import train as ttrain
    from segmantic_tpu_torch.train import trainer

    the_mesh = pmesh.make_mesh()
    node = the_mesh.process_index
    out = dict(local_world_size=os.environ["LOCAL_WORLD_SIZE"],
               process_index=the_mesh.process_index,
               process_count=the_mesh.process_count, data_index=the_mesh.data_index,
               main=pmesh.is_main(the_mesh), main_no_mesh=pmesh.is_main())
    out["steps"] = [steps_case(**dict(c, image=c["image"][node], label=c["label"][node]))
                    for c in steps]
    out["i2i"] = []
    for c in i2i:
        real, ttrain._init_pix2pix = ttrain._init_pix2pix, given_pix2pix(c["init"])
        try:
            out["i2i"].append(i2i_case("pix2pix", c["batches"][node], c["kw"], c["out_root"]))
        finally:
            ttrain._init_pix2pix = real
    out["train"] = []
    for c in train:
        drawn, undo = sampler_spy(trainer)
        try:
            out["train"].append(dict(train_case(**c), drawn=drawn))
        finally:
            undo()
    if refuse_model:
        try:
            pmesh.make_mesh(model=refuse_model)
            out["refused"] = None
        except ValueError as err:
            out["refused"] = str(err)
    return out


CASES = {"steps": steps_cases, "forward": forward_cases, "norm": norm_cases,
         "train": train_cases, "sw": sw_cases, "predict": predict_case, "i2i": i2i_cases,
         "nodes": nodes_case}


def _main(case: str, rank: int, world: int, tmp: str, nodes: int = 1) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    per_node = world // nodes
    pmesh.initialize_distributed(init_method=f"file://{tmp}/store", world_size=world,
                                 rank=rank, backend="gloo", local_world_size=per_node)
    try:
        kw = pickle.loads((Path(tmp) / "in.pkl").read_bytes())
        out = CASES[case](**kw)
        (Path(tmp) / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


# -- tests that need no second rank ------------------------------------------


def _fake_mesh(data=2, model=1, position=0):
    ranks = tuple(range(data * model))
    return pmesh.Mesh({"data": data, "model": model}, ranks, ranks[position])


def test_put_batch_keeps_this_ranks_rows_when_they_divide():
    x = np.arange(8)[:, None]
    assert pmesh.put_batch(_fake_mesh(position=1), x)[:, 0].tolist() == [4, 5, 6, 7]
    assert pmesh.put_batch(_fake_mesh(data=2, model=2, position=3), x)[:, 0].tolist() \
        == [4, 5, 6, 7]  # (1, 1): data index 1
    np.testing.assert_array_equal(pmesh.put_batch(_fake_mesh(position=1), x[:5]), x[:5])
    got = pmesh.shard_batch(_fake_mesh(position=0), {"a": x, "b": (x, x)})
    assert got["a"].shape == (4, 1) and got["b"][1].shape == (4, 1)


def test_put_batch_on_two_nodes_keeps_rows_of_the_nodes_batch():
    """Two nodes of two ranks, mesh (4, 1): the global batch is the nodes'
    batches in node order, so rank 3 (node 1, data index 3) keeps the second
    half of its node's batch; a mesh (2, 2) keeps the whole node batch; a
    node batch its data rows cannot split raises."""
    def mesh(data, model, position):
        ranks = tuple(range(4))
        return pmesh.Mesh({"data": data, "model": model}, ranks, ranks[position],
                          process_index=position // 2, process_count=2)

    x = np.arange(6)[:, None]
    assert pmesh.put_batch(mesh(4, 1, 3), x)[:, 0].tolist() == [3, 4, 5]
    assert pmesh.put_batch(mesh(4, 1, 2), x)[:, 0].tolist() == [0, 1, 2]
    assert mesh(4, 1, 3).local_data_index == 1 and mesh(4, 1, 3).data_index == 3
    assert pmesh.put_batch(mesh(2, 2, 3), x).shape == (6, 1)
    assert pmesh.splits_batch(mesh(4, 1, 0), 5) is False  # no process group
    with pytest.raises(ValueError, match="does not split"):
        pmesh.put_batch(mesh(4, 1, 1), x[:5])
    assert [pmesh.is_main(mesh(4, 1, p)) for p in range(4)] == [True, False, True, False]


def test_initialize_distributed_refuses_nodes_of_unequal_ranks(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="same number of ranks"):
        pmesh.initialize_distributed(init_method="file:///nonexistent", world_size=4, rank=0,
                                     backend="gloo", local_world_size=3)
    assert "LOCAL_WORLD_SIZE" not in os.environ
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="same number of ranks"):
        pmesh._local_world_size(4)
    assert pmesh._local_world_size(6) == 3
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert pmesh._local_world_size(4) == 4


def test_a_world_of_one_needs_no_process_group():
    mesh = pmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    assert pmesh.is_main(mesh) and pmesh.initialize_distributed() is False
    with pytest.raises(ValueError, match="needs a running process group"):
        pmesh.make_mesh(devices=[0, 1])
    x = np.zeros((3, 2))
    assert pmesh.put_batch(mesh, x) is x


def test_zero_placement_on_shapes():
    mesh = _fake_mesh(data=8)
    assert pmesh.zero_placement(mesh, (3, 3, 16, 32)) == 3
    assert pmesh.zero_placement(mesh, (5, 7)) is None
    assert pmesh.zero_placement(mesh, ()) is None
    assert pmesh.zero_placement(mesh, (16, 16)) == 0  # the first of equal axes
    assert pmesh.zero_placement(_fake_mesh(data=1), (16, 16)) is None


def test_shard_opt_state_slices_every_moment_on_its_flax_axis():
    module = UNet(spatial_dims=2, in_channels=1, out_channels=3, channels=(8, 16),
                  strides=(2,), num_res_units=1)
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    full = sum(p.numel() for p in module.parameters())
    pmesh.shard_opt_state(_fake_mesh(data=2, position=1), opt, module)
    sliced = [(p, piece, axis) for p, piece, axis in opt.zero_shards if axis is not None]
    assert sliced and sum(piece.numel() for _, piece, _ in opt.zero_shards) < 0.6 * full
    for p, piece, axis in sliced:
        assert piece.shape[axis] * 2 == p.shape[axis]
        with torch.no_grad():
            piece.add_(1.0)  # a view: the update lands in the parameter
        k = piece.shape[axis]
        assert torch.equal(p.narrow(axis, k, k), piece)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]))
