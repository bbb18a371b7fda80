"""The ``train()`` orchestrator: data -> train step on the device -> ckpts.

Port of ``segmantic_tpu/train/trainer.py``: ``default_preprocessing``,
``SegmentationModel`` (create / load for ``arch="unet"``, ``"segresnet"``
and ``"unetr"``), ``make_train_step``, ``make_val_forward``, ``validate``
and ``train`` with the JAX package's keyword signature plus ``device``, on
one card or on the ranks of a mesh (``parallel/``: data parallelism with
cross-rank BatchNorm, ZeRO-1, tensor-parallel convs).

- Deterministic preprocessing runs once per volume into a host RAM cache
  with per-class crop indices (``data/cache.py``); each step a background
  thread crops the next class-balanced batch of patches (margin patches
  under ``augment_spatial``). A ``preprocessing`` config replaces the default
  pipeline; an ``augmentation`` config replaces the sampler by the user's
  Compose, run per step on the host in numpy (``_host_augment_batch``), as
  in the JAX package.
- The train step runs on ``device``: the augmentation (``train/augment.py``:
  rotation + zoom through the shear-group kernel, intensity ops, flips), then
  the model's forward
  and backward with explicit casts like the JAX step (bf16 image and weights
  cast at use under ``mixed_precision``, f32 master parameters, f32 norm
  statistics; no autocast), the phase-major Dice where the UNet's top stage
  runs in phase space (the plain Dice otherwise), and the optimizer update,
  every ``accumulate_steps`` micro-batches (``optax.MultiSteps`` semantics),
  optionally with the forward recomputed in the backward (``remat``). On the
  card every stride-1 3^3 conv and every phase-space conv runs on the
  hand-written kernels, forward and backward.
- Validation: sliding-window inference (roi 160^nd, Gaussian or constant
  blend) through the folded executor, or the module's own eval forward where
  the executor does not apply, + Dice, the LR scheduler stepped per
  validation epoch, top-3
  checkpoints by val_dice plus ``last.ckpt``, early stopping; the epoch's
  scalars go to ``history.json`` and to TensorBoard under ``output_dir/logs``
  (a warning when no writer package is installed); with ``profile_dir`` a
  ``torch.profiler`` trace of epoch 1's steps goes there.

2D (``spatial_dims=2``) and 3D models train, validate, save and load alike.
Dropout in training raises as the JAX trainer does
(``models.unet.DROPOUT_REFUSAL``), and so do the JAX ``train()``'s refusals of
a mesh it cannot build; nothing is skipped silently and nothing falls back to
the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from ..data.dataset import PairedDataSet
from ..utils.json import PathEncoder

from ..data.cache import PatchSampler, PrefetchLoader, VolumeCache
from ..image.labels import load_decathlon_tissuelist, load_tissue_list
from ..infer.sliding_window import BLEND_MODES, sliding_window_inference
from ..metrics.overlap import confusion_matrix, dice_from_confusion
from ..models.segresnet import SegResNet
from ..models.unet import (
    DROPOUT_REFUSAL, UNet, cross_rank_norm, from_flax_variables, frozen_running_stats,
    to_flax_variables,
)
from ..models.unetr import UNETR
from ..ops.fast_conv import space_to_depth
from ..ops._cuda import resolve_device
from ..ops.fused_conv import at_least_f32
from ..parallel.comm import mean_grads_
from ..parallel.mesh import (
    gather_params, initialize_distributed, is_main, make_mesh, put_batch, replicate,
    splits_batch,
    shard_opt_state, shard_params, unshard_params,
)
from ..transforms import spatial as TS
from ..transforms.base import Compose
from ..transforms.registry import build_pipeline
from .augment import AugmentConfig, augment_batch
from .checkpoint import TopKCheckpoints, load_checkpoint, save_checkpoint
from .losses import dice_loss, dice_loss_phase
from .optim import (
    DEFAULT_LR_SCHEDULING, DEFAULT_OPTIMIZER, LRScheduler, make_optimizer,
    set_learning_rate,
)


def default_preprocessing(keys: Sequence[str], spacing: Sequence[float] = ()) -> Compose:
    """orient(RAS) -> z-score -> crop-foreground -> cast [-> spacing-resample]."""
    keys = list(keys)
    xforms: List[Any] = [
        TS.LoadImaged(keys=keys),
        TS.Orientationd(keys=keys),
        TS.NormalizeIntensityd(keys="image", nonzero=False, channel_wise=True),
        TS.CropForegroundd(
            keys=keys, source_key="label" if "label" in keys else "image"
        ),
        TS.EnsureTyped(keys=keys),
    ]
    if spacing:
        xforms.append(TS.Spacingd(keys=keys, pixdim=list(spacing)))
    return Compose(xforms)


@dataclasses.dataclass
class SegmentationModel:
    """Model bundle: torch module (UNet, SegResNet or UNETR; eval mode, on
    ``device``) + hparams."""

    module: torch.nn.Module
    hparams: Dict[str, Any]

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def spatial_dims(self) -> int:
        return self.module.spatial_dims

    @property
    def num_classes(self) -> int:
        return self.module.out_channels

    @property
    def spatial_size(self) -> List[int]:
        return list(self.hparams.get("spatial_size") or [96] * self.spatial_dims)

    @property
    def variables(self) -> Dict[str, Dict]:
        """The flax-shaped variables tree (numpy), as checkpoints store it."""
        return to_flax_variables(self.module.state_dict())

    def save(self, path: Path, metrics: Optional[Dict[str, float]] = None) -> None:
        save_checkpoint(path, self.variables, self.hparams, metrics)

    @staticmethod
    def create(
        *,
        num_classes: int,
        num_channels: int = 1,
        spatial_dims: int = 3,
        spatial_size: Optional[Sequence[int]] = None,
        channels: Tuple[int, ...] = (16, 32, 64, 128, 256),
        strides: Tuple[int, ...] = (2, 2, 2, 2),
        dropout: float = 0.0,
        act: str = "PRELU",
        num_res_units: int = 2,
        norm: str = "BATCH",
        arch: str = "unet",
        arch_params: Optional[dict] = None,
        seed: int = 0,
        device="cuda",
    ) -> "SegmentationModel":
        """A freshly initialised model (weights from ``torch.Generator(seed)``:
        the JAX package's initialisers, not its random numbers), on ``device``:
        the card unless the caller asks for the CPU; asking for CUDA where
        there is none raises.

        ``arch`` selects the architecture: ``unet`` (configured by channels /
        strides / num_res_units / norm / act), ``segresnet`` (``arch_params``:
        init_filters / blocks_down / blocks_up / norm / act) or ``unetr``
        (``arch_params``: hidden_size / num_layers / num_heads / mlp_dim /
        feature_size / patch_size / norm; needs ``spatial_size``), with the JAX
        package's defaults. The UNet's top-level keys do not apply to the
        other two."""
        arch = (arch or "unet").lower()
        ap = dict(arch_params or {})
        hparams = {
            "num_classes": num_classes,
            "num_channels": num_channels,
            "spatial_dims": spatial_dims,
            "spatial_size": list(spatial_size) if spatial_size else None,
            "channels": list(channels),
            "strides": list(strides),
            "dropout": dropout,
            "act": act,
            "num_res_units": num_res_units,
            "norm": norm,
            "arch": arch,
            "arch_params": ap,
        }
        generator = torch.Generator().manual_seed(seed)
        if arch == "unet":
            module = UNet(
                spatial_dims=spatial_dims, in_channels=num_channels,
                out_channels=num_classes, channels=tuple(channels),
                strides=tuple(strides), dropout=dropout, act=act,
                num_res_units=num_res_units, norm=norm, generator=generator,
            )
        elif arch == "segresnet":
            blocks_down = tuple(ap.get("blocks_down", (1, 2, 2, 4)))
            module = SegResNet(
                spatial_dims=spatial_dims, in_channels=num_channels,
                out_channels=num_classes, init_filters=int(ap.get("init_filters", 8)),
                blocks_down=blocks_down,
                blocks_up=tuple(ap.get("blocks_up", (1,) * (len(blocks_down) - 1))),
                norm=ap.get("norm", "GROUP"), act=ap.get("act", "RELU"),
                dropout=dropout, generator=generator,
            )
        elif arch == "unetr":
            # the position embedding ties the parameters to the token grid
            if not spatial_size:
                raise ValueError("arch='unetr' requires spatial_size")
            module = UNETR(
                spatial_size=tuple(spatial_size), spatial_dims=spatial_dims,
                in_channels=num_channels, out_channels=num_classes,
                hidden_size=int(ap.get("hidden_size", 768)),
                num_layers=int(ap.get("num_layers", 12)),
                num_heads=int(ap.get("num_heads", 12)),
                mlp_dim=int(ap.get("mlp_dim", 3072)),
                feature_size=int(ap.get("feature_size", 16)),
                patch_size=int(ap.get("patch_size", 16)),
                norm=ap.get("norm", "INSTANCE"), generator=generator,
            )
        else:
            raise ValueError(f"unsupported arch {arch!r}")
        module = module.eval().requires_grad_(False).to(resolve_device(device))
        return SegmentationModel(module=module, hparams=hparams)

    @staticmethod
    def load(path: Path, device="cuda") -> "SegmentationModel":
        """Rebuild from a ``STPUCKP1`` checkpoint (either package's) on
        ``device``; as in :meth:`create`, the card is the default and asking
        for it without one raises."""
        ckpt = load_checkpoint(path)
        h = dict(ckpt.get("hparams") or {})
        sidecar = Path(path).with_suffix(".json")
        if sidecar.exists():  # legacy settings next to the checkpoint win
            warnings.warn(f"loading legacy model settings from {sidecar}")
            h.update(json.loads(sidecar.read_text()))
        model = SegmentationModel.create(
            num_classes=h["num_classes"],
            num_channels=h.get("num_channels", 1),
            spatial_dims=h.get("spatial_dims", 3),
            spatial_size=h.get("spatial_size"),
            channels=tuple(h.get("channels", (16, 32, 64, 128, 256))),
            strides=tuple(h.get("strides", (2, 2, 2, 2))),
            dropout=h.get("dropout", 0.0),
            act=h.get("act", "PRELU"),
            num_res_units=h.get("num_res_units", 2),
            norm=h.get("norm", "BATCH"),
            arch=h.get("arch", "unet"),
            arch_params=h.get("arch_params"),
            device=device,
        )
        stored = dict(ckpt["variables"])
        template_cols = model.variables
        # empty collections on either side are no mismatch (the JAX package's
        # rule): a GroupNorm model has no batch_stats, the trainers save {}
        extra = sorted(k for k, v in stored.items() if k not in template_cols and v)
        if extra:
            raise ValueError(f"checkpoint has unexpected variable collections: {extra}")
        missing = sorted(k for k, v in template_cols.items() if v and k not in stored)
        if missing:
            raise ValueError(f"checkpoint is missing variable collections: {missing}")
        state = from_flax_variables(stored)
        template = model.module.state_dict()
        missing = sorted(set(template) - set(state))
        extra = sorted(set(state) - set(template))
        if missing or extra:
            raise ValueError(
                f"checkpoint does not match the model: missing {missing}, "
                f"unexpected {extra}"
            )
        model.module.load_state_dict({
            k: torch.as_tensor(v.copy()).reshape(template[k].shape).to(template[k].dtype)
            for k, v in state.items()
        })
        return model


def make_val_forward(module: torch.nn.Module, compute_dtype: torch.dtype = torch.bfloat16):
    """Eval forward ``windows -> f32 logits`` on the model's device. Windows
    are cast to ``compute_dtype`` (bf16 by default, as the JAX package) and
    logits come back in f32 for blending. The folded executor runs the UNets
    it supports (BATCH / NONE norm, PReLU / ReLU); every other model, SegResNet
    and UNETR among them, runs its own forward in eval mode (the JAX
    package's ``module.apply`` fallback), whose convs launch the kernels
    too."""
    from ..infer.executor import executor_supported, make_eval_forward

    if executor_supported(module):
        return make_eval_forward(module, compute_dtype)

    def val_forward(windows: torch.Tensor) -> torch.Tensor:
        module.eval()  # the train step leaves the module in train mode
        with torch.inference_mode():
            return module(windows.to(compute_dtype)).float()

    return val_forward


@dataclasses.dataclass
class TrainResult:
    output_dir: Path
    best_checkpoint: Optional[Path]
    best_val_dice: float
    best_val_epoch: int
    history: List[Dict[str, float]]
    model: SegmentationModel


def _resolve_num_classes(num_classes: int, tissue_list: Optional[Path], datalist) -> int:
    """num_classes > 0 wins; otherwise tissue_list, then decathlon labels."""
    if num_classes > 0 and tissue_list:
        raise ValueError(
            "'num_classes' and 'tissue_list' are redundant. Prefer 'num_classes'.")
    if num_classes <= 0:
        if tissue_list:
            tissues = load_tissue_list(Path(tissue_list))
        elif datalist:
            first = datalist[0] if isinstance(datalist, (list, tuple)) else datalist
            tissues = load_decathlon_tissuelist(Path(first))
        else:
            raise ValueError("need num_classes, tissue_list, or datalist labels")
        num_classes = max(tissues.values()) + 1
        if len(tissues) != num_classes:
            raise ValueError("Expecting contiguous labels in range [0,N-1]")
    if num_classes <= 1:
        raise ValueError("'num_classes' is expected to be > 1")
    return num_classes


def _rank_generator(generator: Optional[torch.Generator], index: int) -> torch.Generator:
    """The augmentation stream of data index ``index``: a CPU generator seeded
    from ``generator``'s seed and the index (the counterpart of the JAX
    step's ``fold_in(key, axis_index("data"))``)."""
    base = generator.initial_seed() if generator is not None else torch.initial_seed()
    seed = np.random.SeedSequence([base, index]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed >> np.uint64(1)))


def make_train_step(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    aug_cfg: AugmentConfig, patch_size: Sequence[int],
                    mixed_precision: bool, generator: Optional[torch.Generator] = None,
                    accumulate_steps: int = 1, remat: bool = False, mesh=None,
                    zero: bool = False):
    """``step(image, label) -> loss``: augmentation, forward, Dice, backward
    and the optimizer update, in place on ``module`` (parameters and
    BatchNorm running statistics) and ``optimizer``.

    image (B, *margin patch, C) and label (B, *margin patch), the global batch
    on the host or on the module's device (moved there without blocking),
    the margin patch being the sampler's (the patch itself without
    spatial augmentation). The image is augmented in f32, except that a bf16
    image whose first augmentation is the bf16 interpolation is not upcast
    for it, and under ``mixed_precision`` it is fed to the model in bf16.
    Returns the loss as a 0-d device tensor (no synchronisation).
    The Dice consumes the top phase stage's phase-major logits directly when
    that stage runs in phase space and the patch is even (exact: Dice sums
    are invariant to permuting voxels).

    ``accumulate_steps`` k > 1: ``optax.MultiSteps`` semantics. The
    optimizer steps on every k-th micro-batch with the running mean of the k
    micro-batch gradients (``acc + (g - acc) / (n + 1)``, as optax sums
    them); the parameters stay as they are in between, the optimizer's step
    count advances once per k micro-batches, and the BatchNorm running
    statistics are updated at every micro-batch. ``remat``: the forward is
    recomputed in the backward (``torch.utils.checkpoint``, as
    ``jax.checkpoint`` over the JAX package's forward); the recomputation
    leaves the running statistics alone. A step of a module with dropout > 0
    raises ``DROPOUT_REFUSAL`` from its training forward, as the JAX step
    cannot run one.

    ``mesh`` (:func:`..parallel.make_mesh`, with a process group): the
    per-rank step of the JAX package's ``shard_map`` body, taken when the
    data axis is > 1 and divides the batch (``parallel.splits_batch``). Each
    rank keeps its rows of the batch (``put_batch``: of the global batch on
    one node, of its node's batch on several), augments them with its own
    stream (seeded from ``generator``'s seed and its global data index; the
    exact-count subsets are ``round(p * local_B)``), runs the forward and
    backward on them (kernels at local shapes; BatchNorm statistics reduced
    over the data group), and the loss and gradients are averaged over the
    data group in one flat ``all_reduce``; the update stays replicated. On
    one node a batch the data axis does not divide, or a data axis of 1,
    runs whole on every rank with the caller's ``generator`` and no
    collective of the step's own (the JAX package's GSPMD step). Layers that ``shard_params`` made column-parallel
    gather their channels over the model group themselves.
    ``zero`` (ZeRO-1, data axis > 1): the optimizer steps this rank's slices
    (``parallel.shard_opt_state``): the gradients are reduce-scattered into
    them, and the parameters all-gathered after the update (the bytes of one
    all-reduce). A mesh without a process group (a world of one) is the
    mesh-less step."""
    if accumulate_steps < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
    if mesh is not None and not mesh.distributed:
        mesh = None
    n_data = mesh.shape["data"] if mesh is not None else 1
    if zero and n_data < 2:
        raise ValueError("zero=True needs a mesh with a data axis > 1")
    if zero and mesh.shape["model"] > 1:
        raise ValueError("zero_optimizer does not combine with model_parallel")
    # bf16 interpolation only when the step computes in bf16 anyway (the cast
    # after the augmentation would round as much)
    aug_cfg = dataclasses.replace(
        aug_cfg, interp_bf16=aug_cfg.interp_bf16 and mixed_precision)
    patch_size = tuple(int(p) for p in patch_size)
    use_phase_logits = module.phase_top_ok() and all(p % 2 == 0 for p in patch_size)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if zero:
        shard_opt_state(mesh, optimizer, module)
    # what the optimizer steps: the parameters, or under ZeRO their slices
    targets = [p for group in optimizer.param_groups for p in group["params"]]
    rank_generator = _rank_generator(generator, mesh.data_index) if n_data > 1 else None
    device = next(module.parameters()).device
    acc: Dict[torch.Tensor, torch.Tensor] = {}  # running mean of the micro-batch grads
    micro = [0]  # micro-batches in acc

    def forward(image: torch.Tensor) -> torch.Tensor:
        return module(image, phase_logits=use_phase_logits)

    def recompute_context():
        return contextlib.nullcontext(), frozen_running_stats(module)

    def sync(loss: torch.Tensor, group) -> torch.Tensor:
        """Average the loss and the gradients over ``group`` (None: this rank's
        batch was the whole one); under ZeRO the gradients go to the slices."""
        if zero:
            return _zero_grads(optimizer.zero_shards, loss, group, mesh)
        return mean_grads_(params, [loss], group)[0]

    def step(image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        module.train()
        local = n_data > 1 and splits_batch(mesh, image.shape[0])
        if local:
            image, label = put_batch(mesh, image), put_batch(mesh, label)
        image = image.to(device, non_blocking=True)
        label = label.to(device, non_blocking=True)
        if not (aug_cfg.spatial and aug_cfg.interp_bf16
                and image.dtype == torch.bfloat16):
            image = at_least_f32(image)
        image, label = augment_batch(image, label, rank_generator if local else generator,
                                     aug_cfg, patch_size)
        if mixed_precision:
            image = image.to(torch.bfloat16)
        optimizer.zero_grad(set_to_none=True)
        group = mesh.data_group if local else None
        with cross_rank_norm(module, group):
            if remat:
                out = torch.utils.checkpoint.checkpoint(
                    forward, image.contiguous(), use_reentrant=False,
                    context_fn=recompute_context)
            else:
                out = forward(image.contiguous())
            if use_phase_logits:
                loss = dice_loss_phase(out, space_to_depth(label[..., None]))
            else:
                loss = dice_loss(out, label)
            loss.backward()
        loss = sync(loss.detach(), group)
        if accumulate_steps > 1:
            n = micro[0]
            with torch.no_grad():
                for p in targets:
                    if p.grad is None:
                        continue
                    if n == 0:
                        acc[p] = p.grad.clone()
                    else:
                        acc[p].add_((p.grad - acc[p]) / (n + 1))
            micro[0] = n + 1
            if micro[0] < accumulate_steps:
                return loss
            for p in targets:
                p.grad = acc.pop(p, None)
            micro[0] = 0
        optimizer.step()
        if zero:
            _zero_gather(optimizer.zero_shards, mesh)
        return loss

    return step


def _zero_grads(shards, loss: torch.Tensor, group, mesh) -> torch.Tensor:
    """ZeRO-1's gradient placement: each slice takes the mean over the data
    group of its part of the gradient (``reduce_scatter``), a whole leaf the
    mean of all of it (one flat ``all_reduce`` with the loss). ``group`` None:
    every rank has the whole batch's gradient and slices its part."""
    n, i = mesh.shape["data"], mesh.data_index
    whole = []
    for p, piece, axis in shards:
        g, p.grad = p.grad, None
        if g is None:
            continue
        if axis is None:
            piece.grad = g
            whole.append(piece)
        elif group is None:
            k = piece.shape[axis]
            piece.grad = g.narrow(axis, i * k, k).clone()
        else:
            full = g.movedim(axis, 0).contiguous()
            part = torch.empty((full.shape[0] // n,) + full.shape[1:], dtype=g.dtype,
                               device=g.device)
            dist.reduce_scatter_tensor(part, full, group=group)
            piece.grad = (part / n).movedim(0, axis)
    return mean_grads_(whole, [loss], group)[0]


def _zero_gather(shards, mesh) -> None:
    """ZeRO-1's parameter all-gather after the update of the slices."""
    n = mesh.shape["data"]
    with torch.no_grad():
        for p, piece, axis in shards:
            if axis is None:
                continue
            local = piece.movedim(axis, 0).contiguous()
            full = torch.empty((n * local.shape[0],) + local.shape[1:], dtype=local.dtype,
                               device=local.device)
            dist.all_gather_into_tensor(full, local, group=mesh.data_group)
            p.copy_(full.movedim(0, axis))


def validate(
    module: torch.nn.Module,
    cache: VolumeCache,
    num_classes: int,
    roi: Optional[Sequence[int]] = None,
    sw_batch_size: int = 4,
    val_forward=None,
    overlap: float = 0.25,
    blend_mode: str = "gaussian",
    mesh=None,
) -> Tuple[float, float]:
    """Sliding-window validation -> (mean val_dice excluding background,
    mean val_loss), on the module's device: Dice loss on the blended
    logits (``blend_mode`` "gaussian" or "constant"), per-class Dice over the
    classes present in label or prediction. ``roi`` defaults to 160 along
    each of the module's ``spatial_dims`` axes. With a ``mesh`` the windows
    of each volume are shared over its data axis and every rank gets the same
    blended logits, hence the same numbers."""
    roi = list(roi) if roi else [160] * module.spatial_dims
    device = next(module.parameters()).device
    if val_forward is None:
        val_forward = make_val_forward(module)
    dices, losses = [], []
    for i in range(len(cache)):
        vol = cache[i]
        image = np.moveaxis(vol.image.numpy(), 0, -1)  # (*spatial, C)
        logits = sliding_window_inference(image, roi, sw_batch_size, val_forward,
                                          overlap=overlap, mode=blend_mode,
                                          num_classes=num_classes, device=device, mesh=mesh)
        # beside the logits: on the host where the volume was streamed
        label = torch.as_tensor(vol.label.numpy()[0].astype(np.int64), device=logits.device)
        with torch.no_grad():
            losses.append(float(dice_loss(logits[None], label[None])))
        cm = confusion_matrix(num_classes, label, logits.argmax(-1)).cpu().numpy()
        per_class = dice_from_confusion(cm)
        sel = (cm.sum(0) > 0) | (cm.sum(1) > 0)  # present in label or prediction
        sel[0] = False  # exclude background
        dices.append(float(per_class[sel].mean()) if sel.any() else float("nan"))
    return float(np.nanmean(dices)), float(np.mean(losses))


def _check_parallel(*, model_parallel: int, zero_optimizer: bool, world: int) -> None:
    """The JAX ``train()``'s refusals of a mesh it cannot build, with its
    messages (a rank of the port stands for a device there)."""
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the device count "
                         f"({world})")
    if zero_optimizer and model_parallel > 1:
        raise ValueError("zero_optimizer does not combine with model_parallel")
    if zero_optimizer and world // model_parallel < 2:
        raise ValueError("zero_optimizer needs more than one device")


def _start_profiler(device: torch.device):
    """A started ``torch.profiler`` over the host and, on the card, CUDA."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: Path, device: torch.device) -> Path:
    """Stop ``profiler`` and write its Chrome trace under ``profile_dir``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    profile_dir.mkdir(parents=True, exist_ok=True)
    path = profile_dir / "train_epoch1.pt.trace.json"
    profiler.export_chrome_trace(str(path))
    return path


_TB_TAGS = ("train_loss", "val_loss", "val_dice", "lr", "train_voxels_per_sec")


def _make_tb_writer(output_dir: Path):
    """TensorBoard writer for ``output_dir/logs`` (``tensorboardX``, else
    ``torch.utils.tensorboard``), or None with a warning: the scalars are never
    dropped silently. Both packages are optional, so they are imported here."""
    logs = str(Path(output_dir) / "logs")
    errors = []
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir=logs)
    except Exception as err:
        errors.append(f"tensorboardX: {err}")
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=logs)
    except Exception as err:
        errors.append(f"torch.utils.tensorboard: {err}")
    warnings.warn(
        f"no TensorBoard writer available ({'; '.join(errors)}) — scalar logs will "
        "only go to history.json and the console"
    )
    return None


def train(
    *,
    datalist: Optional[Path] = None,
    image_dir: Optional[Path] = None,
    labels_dir: Optional[Path] = None,
    output_dir: Path,
    checkpoint_file: Optional[Path] = None,
    num_classes: int = 0,
    num_channels: int = 1,
    spatial_dims: int = 3,
    spatial_size: Sequence[int] = (),
    preprocessing: dict = {},
    augmentation: dict = {},
    augment_intensity: bool = False,
    augment_spatial: bool = False,
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256),
    strides: Tuple[int, ...] = (2, 2, 2, 2),
    dropout: float = 0.0,
    act: str = "PRELU",
    num_res_units: int = 2,
    norm: str = "BATCH",
    arch: str = "unet",
    arch_params: dict = {},
    num_samples: int = 4,
    optimizer: Optional[dict] = None,
    lr_scheduling: Optional[dict] = None,
    max_epochs: int = 600,
    early_stop_patience: int = 50,
    mixed_precision: bool = True,
    cache_rate: float = 1.0,
    gpu_ids: Sequence[int] = (0,),
    model_parallel: int = 1,
    accumulate_steps: int = 1,
    remat: bool = False,
    zero_optimizer: bool = False,
    tissue_list: Optional[Path] = None,
    batch_size: int = 2,
    spacing: Sequence[float] = (),
    val_roi_size: Sequence[int] = (),
    val_overlap: float = 0.25,
    val_blend_mode: str = "gaussian",
    profile_dir: Optional[Path] = None,
    seed: int = 0,
    device: str = "cuda",
) -> TrainResult:
    """Train a segmentation model (``arch``: the residual UNet, SegResNet or
    UNETR) on ``device``; returns the best checkpoint and the history. Same
    keywords as the JAX package's ``train`` (``gpu_ids`` is accepted for
    config compatibility; the device is ``device``, which must exist:
    ``"cuda"`` without CUDA raises). ``preprocessing`` and ``augmentation``
    are ``_target_`` configs (``transforms/registry.py``): the first replaces
    the default preprocessing that fills the volume cache; the second runs per
    step on the host in numpy, as in the JAX package, and feeds the step on
    ``device`` (``augment_spatial`` / ``augment_intensity`` are the
    augmentation on the device). ``accumulate_steps`` and ``remat`` are
    :func:`make_train_step`'s; ``val_blend_mode`` ("gaussian" or "constant")
    is the validation's window blend; ``profile_dir`` receives a
    ``torch.profiler`` trace of the steps of epoch 1 (with CUDA activity on
    the card), as the JAX package writes a ``jax.profiler`` trace there.

    On N ranks (``torchrun --nproc-per-node N``, on one node or several:
    ``--nnodes M``; :func:`..parallel.initialize_distributed` reads its
    environment) every rank trains on a (N / ``model_parallel``,
    ``model_parallel``) mesh: gradients and BatchNorm statistics reduce over
    the data axis, ``model_parallel`` > 1 makes the wide kernels
    column-parallel over the model axis (``parallel.shard_params``; it must
    divide a node's ranks), and ``zero_optimizer`` slices the optimizer
    moments over the data axis (ZeRO-1). The batch is the JAX package's
    multi-host rule with a node for a host: each node's sampler draws
    ``batch_size * num_samples`` rows seeded ``seed + process_index``, the
    global batch is the nodes' batches in node order, and each rank keeps its
    rows of its node's batch; on one node that is ``batch_size *
    num_samples`` whatever N. As in the JAX package, the config-driven host
    ``augmentation`` is seeded (seed, epoch, step) alone, so every node feeds
    the same rows there, and ``train_voxels_per_sec`` counts
    ``batch_size * num_samples`` patches a step. Validation on N ranks shares
    each volume's windows over the data axis (in memory: a mesh never
    streams), so every rank computes the same val_dice and val_loss and the
    schedule and early stopping agree. The first rank of each node writes the
    files (Dataset.json, checkpoints, history.json, TensorBoard scalars, the
    profiler trace) and prints the epochs, as every JAX process does; on one
    node that is rank 0."""
    if dropout > 0:
        raise NotImplementedError(DROPOUT_REFUSAL)
    if val_blend_mode not in BLEND_MODES:
        raise ValueError(f"val_blend_mode must be one of {BLEND_MODES}, got {val_blend_mode!r}")
    device = resolve_device(device)
    initialize_distributed(backend="gloo" if device.type == "cpu" else "nccl")
    _check_parallel(model_parallel=model_parallel, zero_optimizer=zero_optimizer,
                    world=dist.get_world_size() if dist.is_initialized() else 1)
    mesh = make_mesh(model=model_parallel)
    main = is_main(mesh)
    optimizer_cfg = dict(DEFAULT_OPTIMIZER)
    optimizer_cfg.update(optimizer or {})
    scheduler_cfg = dict(DEFAULT_LR_SCHEDULING)
    scheduler_cfg.update(lr_scheduling or {})

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    num_classes = _resolve_num_classes(num_classes, tissue_list, datalist)

    # --- model -------------------------------------------------------------
    if checkpoint_file and Path(checkpoint_file).exists():
        model = SegmentationModel.load(Path(checkpoint_file), device=device)
        num_classes = model.num_classes
    else:
        model = SegmentationModel.create(
            num_classes=num_classes, num_channels=num_channels,
            spatial_dims=spatial_dims,
            spatial_size=list(spatial_size) if spatial_size else None,
            channels=tuple(channels), strides=tuple(strides), dropout=dropout,
            act=act, num_res_units=num_res_units, norm=norm, arch=arch,
            arch_params=arch_params, seed=seed, device=device,
        )
    module = replicate(mesh, model.module.train().requires_grad_(True))
    if model_parallel > 1:
        shard_params(mesh, module)
        # validation runs the whole model: a replica of it on every rank
        val_model = SegmentationModel.create(**model.hparams, device=device)
    else:
        val_model = model
    patch_size = model.spatial_size
    val_roi = list(val_roi_size) if val_roi_size else [160] * model.spatial_dims
    if isinstance(module, UNETR) and tuple(val_roi) != module.spatial_size:
        raise ValueError(
            f"UNETR validates on windows of its spatial_size {list(module.spatial_size)} "
            f"(its position embedding ties the token grid to it), not val_roi_size "
            f"{val_roi}: pass val_roi_size={list(module.spatial_size)}")

    # --- data --------------------------------------------------------------
    if datalist:
        dataset = PairedDataSet.load_from_json(datalist)
    elif image_dir and labels_dir:
        dataset = PairedDataSet(Path(image_dir), "*.nii.gz", Path(labels_dir), "*.nii.gz",
                                random_seed=seed)
    else:
        raise ValueError("provide either datalist or image_dir+labels_dir")
    if main:
        (output_dir / "Dataset.json").write_text(dataset.dump_dataset())

    pre = build_pipeline(preprocessing) or default_preprocessing(["image", "label"], spacing)
    train_cache = VolumeCache(dataset.training_files(), pre, num_classes,
                              cache_rate=cache_rate)
    val_cache = VolumeCache(dataset.validation_files(), pre, num_classes,
                            cache_rate=cache_rate)
    # the margin feeds the rotation + zoom on the device (real-data borders)
    margin = max(patch_size) // 4 if augment_spatial else 0
    # the bf16 wire halves the upload when the step computes in bf16 anyway;
    # each node draws its own rows (the JAX seed + process_index)
    sampler = PatchSampler(train_cache, patch_size=patch_size,
                           batch_size=batch_size * num_samples,
                           num_samples=num_samples, margin=margin,
                           seed=seed + mesh.process_index,
                           image_wire_dtype=torch.bfloat16 if mixed_precision else np.float32)

    host_augment = build_pipeline(augmentation)  # user-config path (host)

    # --- step --------------------------------------------------------------
    opt = make_optimizer(module.parameters(), optimizer_cfg)
    aug_cfg = AugmentConfig(spatial=augment_spatial, intensity=augment_intensity)
    train_step = make_train_step(module, opt, aug_cfg, patch_size, mixed_precision,
                                 generator=torch.Generator().manual_seed(seed),
                                 accumulate_steps=accumulate_steps, remat=remat,
                                 mesh=mesh, zero=zero_optimizer)
    scheduler = LRScheduler(optimizer_cfg["lr"], scheduler_cfg)
    ckpts = TopKCheckpoints(output_dir, k=3)
    steps_per_epoch = max(1, math.ceil(len(train_cache) / batch_size))
    voxels_per_step = batch_size * num_samples * int(np.prod(patch_size))

    best_dice, best_epoch, since_best = 0.0, -1, 0
    history: List[Dict[str, float]] = []
    writer = _make_tb_writer(output_dir) if main else None
    loader = PrefetchLoader(sampler) if host_augment is None else None
    profiler = None
    try:
        for epoch in range(max_epochs):
            if profile_dir and epoch == 1 and main:
                profiler = _start_profiler(device)
            t0 = time.time()
            epoch_loss = 0.0
            for step_i in range(steps_per_epoch):
                if loader is not None:
                    image_b, label_b = loader.next()
                else:
                    image_b, label_b = _host_augment_batch(
                        train_cache, host_augment, batch_size, num_samples, seed, epoch,
                        step_i)
                # the sampler's bf16 wire is a CPU bf16 tensor; the host
                # augmentation hands over f32 numpy, as in the JAX trainer; the
                # step uploads this rank's rows
                image_t = image_b if torch.is_tensor(image_b) else torch.from_numpy(image_b)
                epoch_loss += float(train_step(image_t, torch.from_numpy(label_b)))
            epoch_loss /= steps_per_epoch
            train_seconds = time.time() - t0
            if profiler is not None:
                trace = _stop_profiler(profiler, Path(profile_dir), device)
                profiler = None
                print(f"wrote profiler trace to {trace}")
            # labelled voxels per second of the training epoch, batch_size *
            # num_samples patches a step as the JAX trainer counts them (one
            # node's batch on several; host clock; float(loss) synchronises)
            voxels_per_sec = voxels_per_step * steps_per_epoch / max(train_seconds, 1e-9)

            # the whole state on every rank: column-parallel kernels gathered
            state = gather_params(mesh, module)
            if val_model is not model:
                val_model.module.load_state_dict(state)

            # --- validation epoch ------------------------------------------
            if len(val_cache) > 0:
                val_dice, val_loss = validate(
                    val_model.module, val_cache, num_classes, roi=val_roi,
                    val_forward=make_val_forward(val_model.module), overlap=val_overlap,
                    blend_mode=val_blend_mode,
                    # a world of one keeps the mesh-less window's streaming rule
                    mesh=mesh if mesh.distributed else None,
                )
            else:
                val_dice, val_loss = float("nan"), epoch_loss

            lr = scheduler.step(val_loss)
            set_learning_rate(opt, lr)
            record = {
                "epoch": epoch,
                "train_loss": epoch_loss,
                "val_loss": val_loss,
                "val_dice": val_dice,
                "lr": lr,
                "seconds": time.time() - t0,
                "train_voxels_per_sec": voxels_per_sec,
            }
            history.append(record)
            if writer is not None:
                for tag in _TB_TAGS:
                    writer.add_scalar(tag, record[tag], epoch)
            if main:
                print(f"epoch {epoch}: train_loss={epoch_loss:.4f} val_loss={val_loss:.4f} "
                      f"val_dice={val_dice:.4f} lr={lr:.2e}")

            if not np.isfinite(val_loss):
                if main:
                    print("non-finite val_loss — stopping")
                break
            if np.isfinite(val_dice) and val_dice > best_dice:
                best_dice, best_epoch, since_best = val_dice, epoch, 0
            else:
                since_best += 1
            if main:
                variables = to_flax_variables(state)
                if np.isfinite(val_dice):
                    ckpts.update(epoch, val_loss, val_dice, variables, model.hparams)
                # always-current snapshot for interrupted-run resume
                save_checkpoint(output_dir / "last.ckpt", variables, model.hparams,
                                metrics={"epoch": epoch, "val_loss": val_loss,
                                         "val_dice": val_dice})
            if since_best >= early_stop_patience:
                if main:
                    print(f"early stopping at epoch {epoch} (patience {early_stop_patience})")
                break
    finally:
        if profiler is not None:
            profiler.stop()
        if loader is not None:
            loader.stop()
        if writer is not None:
            writer.close()

    unshard_params(mesh, module).eval().requires_grad_(False)
    if main:
        (output_dir / "history.json").write_text(
            json.dumps(history, cls=PathEncoder, indent=2))
    return TrainResult(output_dir=output_dir, best_checkpoint=ckpts.best,
                       best_val_dice=best_dice, best_val_epoch=best_epoch,
                       history=history, model=model)


def _host_augment_batch(
    cache: VolumeCache,
    augment: Compose,
    batch_size: int,
    num_samples: int,
    seed: int,
    epoch: int,
    step: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Config-driven augmentation path: run the user's Compose per volume on
    the host, collate the patches: (f32 images channel-last, int32 labels).
    The generator is seeded by (seed, epoch, step), so a batch is a function of
    those three and the cache."""
    rng = np.random.default_rng((seed, epoch, step))
    images, labels = [], []
    for _ in range(batch_size):
        idx = int(rng.integers(len(cache)))
        vol = cache[idx]
        sample = {"image": vol.image, "label": vol.label}
        out = augment(sample, rng)
        items = out if isinstance(out, list) else [out]
        for item in items:
            images.append(np.moveaxis(item["image"].numpy(), 0, -1))
            labels.append(item["label"].numpy()[0])
    image_b = np.stack(images).astype(np.float32)
    label_b = np.stack(labels).astype(np.int32)
    return image_b, label_b
