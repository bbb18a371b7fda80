"""Model bundle, preprocessing and eval forward of the serving path.

Port of the serving subset of ``segmantic_tpu/train/trainer.py``:
``default_preprocessing``, ``SegmentationModel.create`` / ``.load`` for
``arch="unet"`` and ``make_val_forward``. Training itself is not ported yet
(ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.unet import UNet, from_flax_variables, to_flax_variables
from ..transforms import spatial as TS
from ..transforms.base import Compose
from .checkpoint import load_checkpoint, save_checkpoint


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
