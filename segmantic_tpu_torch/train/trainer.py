"""The ``train()`` orchestrator: data -> train step on the device -> ckpts.

Port of the single-device path of ``segmantic_tpu/train/trainer.py``:
``default_preprocessing``, ``SegmentationModel`` (create / load for
``arch="unet"``), ``make_train_step``, ``make_val_forward``, ``validate``
and ``train`` with the JAX package's keyword signature plus ``device``.

- Deterministic preprocessing runs once per volume into a host RAM cache
  with per-class crop indices (``data/cache.py``); each step a background
  thread crops the next class-balanced batch of patches.
- The train step runs on ``device``: flips, then the UNet forward and
  backward with explicit casts like the JAX step (bf16 image and weights cast
  at use under ``mixed_precision``, f32 master parameters, f32 BatchNorm
  statistics; no autocast), the phase-major Dice, and the optimizer update.
  On the card every stride-1 3^3 conv and every phase-space conv runs on the
  hand-written kernels, forward and backward.
- Validation: sliding-window inference (roi 160^3) through the folded
  executor + Dice, the LR scheduler stepped per validation epoch, top-3
  checkpoints by val_dice plus ``last.ckpt``, early stopping.

Options of the JAX ``train()`` that the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item; nothing is skipped
silently and nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from segmantic_tpu.data.dataset import PairedDataSet
from segmantic_tpu.utils.json import PathEncoder

from ..data.cache import PatchSampler, PrefetchLoader, VolumeCache
from ..image.labels import load_decathlon_tissuelist, load_tissue_list
from ..infer.sliding_window import sliding_window_inference
from ..metrics.overlap import confusion_matrix, dice_from_confusion
from ..models.unet import UNet, from_flax_variables, to_flax_variables
from ..ops.fast_conv import space_to_depth
from ..ops.fused_conv import at_least_f32
from ..transforms import spatial as TS
from ..transforms.base import Compose
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


def resolve_device(device) -> torch.device:
    """The requested device; asking for CUDA without CUDA raises (the port
    never moves to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' explicitly "
            "to run on the CPU"
        )
    return device


@dataclasses.dataclass
class SegmentationModel:
    """Model bundle: torch UNet (eval mode, on ``device``) + hparams."""

    module: UNet
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
        device="cpu",
    ) -> "SegmentationModel":
        """A freshly initialised model (weights from ``torch.Generator(seed)``:
        the JAX package's initialisers, not its random numbers)."""
        arch = (arch or "unet").lower()
        if arch in ("segresnet", "unetr"):
            raise NotImplementedError(
                f"arch={arch!r} is not ported yet (ROADMAP Queue 1: "
                "models/segresnet.py, models/unetr.py)"
            )
        if arch != "unet":
            raise ValueError(f"unsupported arch {arch!r}")
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
            "arch_params": dict(arch_params or {}),
        }
        module = UNet(
            spatial_dims=spatial_dims, in_channels=num_channels,
            out_channels=num_classes, channels=tuple(channels),
            strides=tuple(strides), dropout=dropout, act=act,
            num_res_units=num_res_units, norm=norm,
            generator=torch.Generator().manual_seed(seed),
        )
        module = module.eval().requires_grad_(False).to(resolve_device(device))
        return SegmentationModel(module=module, hparams=hparams)

    @staticmethod
    def load(path: Path, device="cpu") -> "SegmentationModel":
        """Rebuild from a ``STPUCKP1`` checkpoint (either package's)."""
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
        state = from_flax_variables(ckpt["variables"])
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


def make_val_forward(module: UNet, compute_dtype: torch.dtype = torch.bfloat16):
    """Eval forward ``windows -> f32 logits`` on the model's device: the
    folded executor on the hand-written kernels. Windows are cast to
    ``compute_dtype`` (bf16 by default, as the JAX package) and logits come
    back in f32 for blending. (Every UNet a checkpoint describes is one the
    executor supports; the JAX package's ``module.apply`` fallback covers
    configurations the port does not build.)"""
    from ..infer.executor import make_eval_forward

    return make_eval_forward(module, compute_dtype)


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


def make_train_step(module: UNet, optimizer: torch.optim.Optimizer,
                    aug_cfg: AugmentConfig, patch_size: Sequence[int],
                    mixed_precision: bool, generator: Optional[torch.Generator] = None):
    """``step(image, label) -> loss``: flips, forward, phase-major Dice,
    backward and the optimizer update, in place on ``module`` (parameters and
    BatchNorm running statistics) and ``optimizer``.

    image (B, *patch, C) and label (B, *patch) on the module's device; the
    image is augmented in f32 and, under ``mixed_precision``, fed to the model
    in bf16. Returns the loss as a 0-d device tensor (no synchronisation).
    The Dice consumes the top phase stage's phase-major logits directly when
    that stage runs in phase space and the patch is even (exact: Dice sums
    are invariant to permuting voxels)."""
    aug_cfg.check_ported()
    patch_size = tuple(int(p) for p in patch_size)
    use_phase_logits = module.phase_top_ok() and all(p % 2 == 0 for p in patch_size)

    def step(image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        module.train()
        image, label = augment_batch(at_least_f32(image), label, generator, aug_cfg)
        if mixed_precision:
            image = image.to(torch.bfloat16)
        optimizer.zero_grad(set_to_none=True)
        out = module(image.contiguous(), phase_logits=use_phase_logits)
        if use_phase_logits:
            loss = dice_loss_phase(out, space_to_depth(label[..., None]))
        else:
            loss = dice_loss(out, label)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def validate(
    module: UNet,
    cache: VolumeCache,
    num_classes: int,
    roi: Optional[Sequence[int]] = None,
    sw_batch_size: int = 4,
    val_forward=None,
    overlap: float = 0.25,
) -> Tuple[float, float]:
    """Sliding-window validation -> (mean val_dice excluding background,
    mean val_loss), on the module's device: Dice loss on the blended
    logits, per-class Dice over the classes present in label or prediction."""
    roi = list(roi) if roi else [160] * 3
    device = next(module.parameters()).device
    if val_forward is None:
        val_forward = make_val_forward(module)
    dices, losses = [], []
    for i in range(len(cache)):
        vol = cache[i]
        image = np.moveaxis(vol.image.numpy(), 0, -1)  # (*spatial, C)
        label = torch.as_tensor(vol.label.numpy()[0].astype(np.int64), device=device)
        logits = sliding_window_inference(image, roi, sw_batch_size, val_forward,
                                          overlap=overlap, device=device)
        with torch.no_grad():
            losses.append(float(dice_loss(logits[None], label[None])))
        cm = confusion_matrix(num_classes, label, logits.argmax(-1)).cpu().numpy()
        per_class = dice_from_confusion(cm)
        sel = (cm.sum(0) > 0) | (cm.sum(1) > 0)  # present in label or prediction
        sel[0] = False  # exclude background
        dices.append(float(per_class[sel].mean()) if sel.any() else float("nan"))
    return float(np.nanmean(dices)), float(np.mean(losses))


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1: {item})")


def _check_ported(*, preprocessing, augmentation, augment_spatial, augment_intensity,
                  arch, model_parallel, accumulate_steps, remat, zero_optimizer,
                  profile_dir, val_blend_mode) -> None:
    if preprocessing or augmentation:
        raise _not_ported("config-driven preprocessing/augmentation pipelines",
                          "transforms/registry.py")
    if augment_spatial or augment_intensity:
        AugmentConfig(spatial=augment_spatial, intensity=augment_intensity).check_ported()
    if (arch or "unet").lower() != "unet":
        raise _not_ported(f"arch={arch!r}", "models/segresnet.py, models/unetr.py")
    if model_parallel != 1 or zero_optimizer:
        raise _not_ported("model_parallel > 1 and zero_optimizer", "Parallel")
    if accumulate_steps != 1 or remat or profile_dir:
        raise _not_ported("accumulate_steps > 1, remat and profile_dir",
                          "train() extras")
    if val_blend_mode != "gaussian":
        raise _not_ported(f"val_blend_mode={val_blend_mode!r}", "train() extras")


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
    """Train a residual UNet on ``device``; returns the best checkpoint and
    the history. Same keywords as the JAX package's ``train`` (``gpu_ids`` is
    accepted for config compatibility; the device is ``device``, which must
    exist: ``"cuda"`` without CUDA raises)."""
    _check_ported(preprocessing=preprocessing, augmentation=augmentation,
                  augment_spatial=augment_spatial, augment_intensity=augment_intensity,
                  arch=arch, model_parallel=model_parallel,
                  accumulate_steps=accumulate_steps, remat=remat,
                  zero_optimizer=zero_optimizer, profile_dir=profile_dir,
                  val_blend_mode=val_blend_mode)
    device = resolve_device(device)
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
    module = model.module.train().requires_grad_(True)
    patch_size = model.spatial_size

    # --- data --------------------------------------------------------------
    if datalist:
        dataset = PairedDataSet.load_from_json(datalist)
    elif image_dir and labels_dir:
        dataset = PairedDataSet(Path(image_dir), "*.nii.gz", Path(labels_dir), "*.nii.gz",
                                random_seed=seed)
    else:
        raise ValueError("provide either datalist or image_dir+labels_dir")
    (output_dir / "Dataset.json").write_text(dataset.dump_dataset())

    pre = default_preprocessing(["image", "label"], spacing)
    train_cache = VolumeCache(dataset.training_files(), pre, num_classes,
                              cache_rate=cache_rate)
    val_cache = VolumeCache(dataset.validation_files(), pre, num_classes,
                            cache_rate=cache_rate)
    sampler = PatchSampler(train_cache, patch_size=patch_size,
                           batch_size=batch_size * num_samples,
                           num_samples=num_samples, seed=seed)

    # --- step --------------------------------------------------------------
    opt = make_optimizer(module.parameters(), optimizer_cfg)
    train_step = make_train_step(module, opt, AugmentConfig(), patch_size, mixed_precision,
                                 generator=torch.Generator().manual_seed(seed))
    scheduler = LRScheduler(optimizer_cfg["lr"], scheduler_cfg)
    ckpts = TopKCheckpoints(output_dir, k=3)
    steps_per_epoch = max(1, math.ceil(len(train_cache) / batch_size))
    voxels_per_step = batch_size * num_samples * int(np.prod(patch_size))

    best_dice, best_epoch, since_best = 0.0, -1, 0
    history: List[Dict[str, float]] = []
    loader = PrefetchLoader(sampler)
    try:
        for epoch in range(max_epochs):
            t0 = time.time()
            epoch_loss = 0.0
            for _ in range(steps_per_epoch):
                image_b, label_b = loader.next()
                image_d = torch.from_numpy(image_b).to(device, non_blocking=True)
                label_d = torch.from_numpy(label_b).to(device, non_blocking=True)
                epoch_loss += float(train_step(image_d, label_d))
            epoch_loss /= steps_per_epoch
            train_seconds = time.time() - t0
            # labelled voxels per second of the training epoch (host clock;
            # float(loss) synchronises every step)
            voxels_per_sec = voxels_per_step * steps_per_epoch / max(train_seconds, 1e-9)

            # --- validation epoch ------------------------------------------
            if len(val_cache) > 0:
                val_dice, val_loss = validate(
                    module, val_cache, num_classes,
                    roi=list(val_roi_size) if val_roi_size else None,
                    val_forward=make_val_forward(module), overlap=val_overlap,
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
            print(f"epoch {epoch}: train_loss={epoch_loss:.4f} val_loss={val_loss:.4f} "
                  f"val_dice={val_dice:.4f} lr={lr:.2e}")

            if not np.isfinite(val_loss):
                print("non-finite val_loss — stopping")
                break
            if np.isfinite(val_dice) and val_dice > best_dice:
                best_dice, best_epoch, since_best = val_dice, epoch, 0
            else:
                since_best += 1
            variables = model.variables
            if np.isfinite(val_dice):
                ckpts.update(epoch, val_loss, val_dice, variables, model.hparams)
            # always-current snapshot for interrupted-run resume
            save_checkpoint(output_dir / "last.ckpt", variables, model.hparams,
                            metrics={"epoch": epoch, "val_loss": val_loss,
                                     "val_dice": val_dice})
            if since_best >= early_stop_patience:
                print(f"early stopping at epoch {epoch} (patience {early_stop_patience})")
                break
    finally:
        loader.stop()

    module.eval().requires_grad_(False)
    (output_dir / "history.json").write_text(json.dumps(history, cls=PathEncoder, indent=2))
    return TrainResult(output_dir=output_dir, best_checkpoint=ckpts.best,
                       best_val_dice=best_dice, best_val_epoch=best_epoch,
                       history=history, model=model)
