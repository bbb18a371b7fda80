"""pix2pix / CycleGAN training loops, on one card or over the ranks of a mesh.

Port of ``segmantic_tpu/i2i/train.py``: LSGAN objectives, L1 /
cycle-consistency / identity terms, alternating G/D optimisation with Adam
(b1 0.5, b2 0.999, eps 1e-8) for both. Each iteration runs the D step first,
against the current G (its fakes under ``no_grad``, the reference's
``stop_gradient``), then the G step against the D just updated; during the G
step the discriminators' parameters take no gradient (``jax.value_and_grad``
differentiates with respect to G alone). The trainers run over the mesh of
all ranks (``parallel.make_mesh``), as the JAX ones over all devices: the
networks are replicated from rank 0, each rank takes its rows of every batch
whose row count the data axis divides (``put_batch``), the D and G
gradients and losses are averaged over the data axis in one flat
``all_reduce`` each (the average GSPMD gives the JAX package), and the first
rank of each node writes the checkpoint and prints. On several torchrun
nodes each node passes its own ``batches`` and the global batch is the
nodes' batches in node order (the JAX multi-host ``put_batch``): each rank
takes its rows of its node's batch. A world of one (no process group) is
the single-card loop.

The networks of a run are built by :func:`_init_pix2pix` /
:func:`_init_cyclegan` from one seed (a ``torch.Generator`` re-seeded before
each network, as the reference initialises all of them from one key); the
steps of one iteration are :func:`make_pix2pix_steps` /
:func:`make_cyclegan_steps`. Checkpoints are the JAX package's: the flax
parameter tree with the same hparams, readable by either package's
``load_generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops._cuda import resolve_device
from ..parallel.comm import mean_grads_
from ..parallel.mesh import (
    initialize_distributed, is_main, make_mesh, put_batch, replicate, splits_batch)
from ..train.checkpoint import save_checkpoint
from .models import PatchDiscriminator, ResnetGenerator, to_flax_variables

__all__ = [
    "lsgan_loss", "I2IResult", "train_pix2pix", "train_cyclegan",
    "make_pix2pix_steps", "make_cyclegan_steps",
]


def lsgan_loss(logits: torch.Tensor, is_real: bool) -> torch.Tensor:
    target = 1.0 if is_real else 0.0
    return torch.mean((logits.float() - target) ** 2)


def _l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x.float() - y.float()))


@dataclasses.dataclass
class I2IResult:
    generator_params: Dict
    history: List[Dict[str, float]]
    checkpoint: Optional[Path] = None


def _make_optim(params, lr: float) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8)


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _init_pix2pix(src0: np.ndarray, dst0: np.ndarray, base_features: int, n_blocks: int,
                  seed: int, device) -> Tuple[ResnetGenerator, PatchDiscriminator]:
    """The generator and discriminator of a pix2pix run, on ``device``."""
    nd, cs, cd = src0.ndim - 2, src0.shape[-1], dst0.shape[-1]
    gen = ResnetGenerator(cs, cd, base_features, n_blocks, nd, generator=_seeded(seed))
    disc = PatchDiscriminator(cs + cd, base_features, spatial_dims=nd, generator=_seeded(seed))
    return gen.to(device), disc.to(device)


def _init_cyclegan(a0: np.ndarray, b0: np.ndarray, base_features: int, n_blocks: int,
                   seed: int, device) -> Dict[str, torch.nn.Module]:
    """``gen_ab``, ``gen_ba``, ``disc_a``, ``disc_b`` of a CycleGAN run, on
    ``device``."""
    nd, ca, cb = a0.ndim - 2, a0.shape[-1], b0.shape[-1]
    nets = {
        "gen_ab": ResnetGenerator(ca, cb, base_features, n_blocks, nd, generator=_seeded(seed)),
        "gen_ba": ResnetGenerator(cb, ca, base_features, n_blocks, nd, generator=_seeded(seed)),
        "disc_a": PatchDiscriminator(ca, base_features, spatial_dims=nd, generator=_seeded(seed)),
        "disc_b": PatchDiscriminator(cb, base_features, spatial_dims=nd, generator=_seeded(seed)),
    }
    return {k: v.to(device) for k, v in nets.items()}


@contextlib.contextmanager
def _frozen(nets):
    """The parameters of ``nets`` take no gradient inside."""
    for n in nets:
        n.requires_grad_(False)
    try:
        yield
    finally:
        for n in nets:
            n.requires_grad_(True)


def _on_rows(mesh, device, *batch):
    """This rank's rows of each batch array on ``device`` (on one node of the
    global batch, all of them at a data axis of 1; on several nodes of this
    node's batch), and the group to average over (None without a process
    group, or on one node when the data axis does not divide the rows: the
    rows are the whole batch)."""
    local = all(splits_batch(mesh, b.shape[0]) for b in batch)
    rows = [torch.as_tensor(put_batch(mesh, b) if local else b, device=device)
            for b in batch]
    return rows, mesh.data_group if local else None


def _opt_params(optimizer):
    return [p for g in optimizer.param_groups for p in g["params"]]


def _device_of(module) -> torch.device:
    return next(module.parameters()).device


def make_pix2pix_steps(gen, disc, g_opt, d_opt, lambda_l1: float, mesh=None
                       ) -> Tuple[Callable, Callable]:
    """``d_step(src, dst) -> d_loss`` and ``g_step(src, dst) -> (loss, adv,
    l1)`` of one pix2pix iteration: src and dst are the global batch (numpy or
    tensors); with a ``mesh`` each rank takes its rows and the gradients and
    losses are averaged over the data axis. The losses stay on the device."""
    device = _device_of(gen)

    def d_step(src, dst):
        (src, dst), group = _on_rows(mesh, device, src, dst)
        with torch.no_grad():
            fake = gen(src)
        d_opt.zero_grad(set_to_none=True)
        real_pred = disc(torch.cat([src, dst], -1))
        fake_pred = disc(torch.cat([src, fake], -1))
        loss = 0.5 * (lsgan_loss(real_pred, True) + lsgan_loss(fake_pred, False))
        loss.backward()
        (loss,) = mean_grads_(_opt_params(d_opt), [loss], group)
        d_opt.step()
        return loss

    def g_step(src, dst):
        (src, dst), group = _on_rows(mesh, device, src, dst)
        g_opt.zero_grad(set_to_none=True)
        with _frozen([disc]):
            fake = gen(src)
            adv = lsgan_loss(disc(torch.cat([src, fake], -1)), True)
            l1 = _l1(fake, dst)
            loss = adv + lambda_l1 * l1
            loss.backward()
        out = mean_grads_(_opt_params(g_opt), [loss, adv, l1], group)
        g_opt.step()
        return tuple(out)

    return d_step, g_step


def make_cyclegan_steps(nets: Dict[str, torch.nn.Module], g_opt, d_opt, lambda_cycle: float,
                        lambda_identity: float, mesh=None) -> Tuple[Callable, Callable]:
    """``d_step(a, b) -> d_loss`` and ``g_step(a, b) -> (loss, adv, cycle)``
    of one CycleGAN iteration (the identity term weighted by
    ``lambda_cycle * lambda_identity``, as the reference weighs it); a and b
    and the ``mesh`` as in :func:`make_pix2pix_steps`."""
    gen_ab, gen_ba, disc_a, disc_b = (nets[k] for k in ("gen_ab", "gen_ba", "disc_a", "disc_b"))
    device = _device_of(gen_ab)

    def d_step(a, b):
        (a, b), group = _on_rows(mesh, device, a, b)
        with torch.no_grad():
            fake_b, fake_a = gen_ab(a), gen_ba(b)
        d_opt.zero_grad(set_to_none=True)
        loss = lsgan_loss(disc_b(b), True)
        loss = loss + lsgan_loss(disc_b(fake_b), False)
        loss = loss + lsgan_loss(disc_a(a), True)
        loss = loss + lsgan_loss(disc_a(fake_a), False)
        loss = 0.5 * loss
        loss.backward()
        (loss,) = mean_grads_(_opt_params(d_opt), [loss], group)
        d_opt.step()
        return loss

    def g_step(a, b):
        (a, b), group = _on_rows(mesh, device, a, b)
        g_opt.zero_grad(set_to_none=True)
        with _frozen([disc_a, disc_b]):
            fake_b, fake_a = gen_ab(a), gen_ba(b)
            adv = lsgan_loss(disc_b(fake_b), True) + lsgan_loss(disc_a(fake_a), True)
            cyc = _l1(gen_ba(fake_b), a) + _l1(gen_ab(fake_a), b)
            idt = _l1(gen_ab(b), b) + _l1(gen_ba(a), a)
            loss = adv + lambda_cycle * cyc + lambda_cycle * lambda_identity * idt
            loss.backward()
        out = mean_grads_(_opt_params(g_opt), [loss, adv, cyc], group)
        g_opt.step()
        return tuple(out)

    return d_step, g_step


def _next_batch(batches, iter_batches, last):
    """The next batch; an exhausted source is re-``iter``-ed, and when even
    that yields nothing the last batch is reused (as the reference does)."""
    try:
        return iter_batches, next(iter_batches)
    except StopIteration:
        try:
            iter_batches = iter(batches)
            return iter_batches, next(iter_batches)
        except StopIteration:
            return iter_batches, last  # exhausted generator: keep reusing the last batch


def _params(module) -> Dict:
    return to_flax_variables(module.state_dict())["params"]


def train_pix2pix(
    batches: Iterator[Tuple[np.ndarray, np.ndarray]],
    steps: int = 1000,
    lambda_l1: float = 100.0,
    lr: float = 2e-4,
    base_features: int = 64,
    n_blocks: int = 6,
    seed: int = 0,
    output_dir: Optional[Path] = None,
    log_every: int = 100,
    extra_hparams: Optional[Dict] = None,
    device="cuda",
) -> I2IResult:
    """Paired translation: generator(src) ~ dst with LSGAN + L1, on ``device``.

    ``batches`` yields (source, target) channel-last arrays of identical
    static shapes; on N ranks of one node each rank iterates the same global
    batches and takes its rows, on several nodes each node its own batches
    (the module's docstring)."""
    device = resolve_device(device)
    initialize_distributed(backend="gloo" if device.type == "cpu" else "nccl")
    mesh = make_mesh()
    src0, dst0 = next(iter_batches := iter(batches))
    gen, disc = _init_pix2pix(src0, dst0, base_features, n_blocks, seed, device)
    replicate(mesh, gen)
    replicate(mesh, disc)
    g_opt, d_opt = _make_optim(gen.parameters(), lr), _make_optim(disc.parameters(), lr)
    d_step, g_step = make_pix2pix_steps(gen, disc, g_opt, d_opt, lambda_l1, mesh=mesh)

    history: List[Dict[str, float]] = []
    batch = (src0, dst0)
    for step in range(steps):
        d_loss = d_step(*batch)
        g_loss, _, l1 = g_step(*batch)
        if step % log_every == 0 or step == steps - 1:
            rec = {
                "step": step,
                "g_loss": float(g_loss),
                "d_loss": float(d_loss),
                "l1": float(l1),
            }
            history.append(rec)
            if is_main(mesh):
                print(f"pix2pix step {step}: g={rec['g_loss']:.4f} d={rec['d_loss']:.4f} "
                      f"l1={rec['l1']:.4f}")
        iter_batches, batch = _next_batch(batches, iter_batches, batch)

    params = _params(gen)
    ckpt = None
    if output_dir and is_main(mesh):
        output_dir = Path(output_dir)
        ckpt = output_dir / "pix2pix_generator.ckpt"
        save_checkpoint(
            ckpt,
            {"params": params},
            hparams={
                "model": "pix2pix",
                "out_channels": dst0.shape[-1],
                "base_features": base_features,
                "n_blocks": n_blocks,
                **(extra_hparams or {}),
            },
            metrics=history[-1] if history else {},
        )
    return I2IResult(params, history, ckpt)


def train_cyclegan(
    batches: Iterator[Tuple[np.ndarray, np.ndarray]],
    steps: int = 1000,
    lambda_cycle: float = 10.0,
    lambda_identity: float = 0.5,
    lr: float = 2e-4,
    base_features: int = 32,
    n_blocks: int = 4,
    seed: int = 0,
    output_dir: Optional[Path] = None,
    log_every: int = 100,
    extra_hparams: Optional[Dict] = None,
    device="cuda",
) -> I2IResult:
    """Unpaired translation: G_AB/G_BA + D_A/D_B with cycle + identity, on
    ``device``.

    ``batches`` yields (domain_A, domain_B) channel-last arrays (unpaired),
    on N ranks as in :func:`train_pix2pix`."""
    device = resolve_device(device)
    initialize_distributed(backend="gloo" if device.type == "cpu" else "nccl")
    mesh = make_mesh()
    a0, b0 = next(iter_batches := iter(batches))
    nets = _init_cyclegan(a0, b0, base_features, n_blocks, seed, device)
    for net in nets.values():
        replicate(mesh, net)
    g_opt = _make_optim([*nets["gen_ab"].parameters(), *nets["gen_ba"].parameters()], lr)
    d_opt = _make_optim([*nets["disc_a"].parameters(), *nets["disc_b"].parameters()], lr)
    d_step, g_step = make_cyclegan_steps(nets, g_opt, d_opt, lambda_cycle, lambda_identity,
                                         mesh=mesh)

    history: List[Dict[str, float]] = []
    batch = (a0, b0)
    for step in range(steps):
        d_loss = d_step(*batch)
        g_loss, _, cyc = g_step(*batch)
        if step % log_every == 0 or step == steps - 1:
            rec = {
                "step": step,
                "g_loss": float(g_loss),
                "d_loss": float(d_loss),
                "cycle": float(cyc),
            }
            history.append(rec)
            if is_main(mesh):
                print(f"cyclegan step {step}: g={rec['g_loss']:.4f} d={rec['d_loss']:.4f} "
                      f"cycle={rec['cycle']:.4f}")
        iter_batches, batch = _next_batch(batches, iter_batches, batch)

    gens = {"gen_ab": _params(nets["gen_ab"]), "gen_ba": _params(nets["gen_ba"])}
    ckpt = None
    if output_dir and is_main(mesh):
        output_dir = Path(output_dir)
        ckpt = output_dir / "cyclegan_generators.ckpt"
        save_checkpoint(
            ckpt,
            {"params": gens},
            hparams={
                "model": "cyclegan",
                "base_features": base_features,
                "n_blocks": n_blocks,
                "a_channels": a0.shape[-1],
                "b_channels": b0.shape[-1],
                **(extra_hparams or {}),
            },
            metrics=history[-1] if history else {},
        )
    return I2IResult(gens, history, ckpt)
