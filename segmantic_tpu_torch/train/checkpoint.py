"""Single-file checkpoints in the JAX package's ``STPUCKP1`` format.

Port of ``segmantic_tpu/train/checkpoint.py`` (save/load, the
``epoch=E-val_loss=L-val_dice=D.ckpt`` names, ``parse_val_dice`` that reads
them back for the ``mean`` ensemble's weights, and ``TopKCheckpoints``): ``STPUCKP1``
magic, u64 little-endian header length, JSON header
({"hparams", "metrics", "has_opt_state"}), then the msgpack of
``{"variables": ...}`` exactly as ``flax.serialization.to_bytes`` writes it
(nested maps, arrays as ext type 1). Files written here load in the JAX
package and vice versa. The variables are the flax-shaped nested dict of
numpy arrays; :func:`segmantic_tpu_torch.models.unet.from_flax_variables`
turns them into a torch ``state_dict``.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import msgpack

_MAGIC = b"STPUCKP1"


def _as_numpy_tree(tree):
    if isinstance(tree, dict):
        return {str(k): _as_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_checkpoint(
    path: Path,
    variables: Dict[str, Any],
    hparams: Dict[str, Any],
    metrics: Optional[Dict[str, float]] = None,
) -> None:
    """Write ``variables`` (nested dict of arrays, flax naming) + metadata."""
    blob = msgpack.packb({"variables": _as_numpy_tree(variables)})
    header = json.dumps(
        {"hparams": hparams, "metrics": metrics or {}, "has_opt_state": False}
    ).encode()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(blob)


def _parse_header(raw: bytes, path: Path) -> Tuple[Dict[str, Any], int]:
    if raw[:8] != _MAGIC:
        raise ValueError(f"{path}: not a segmantic-tpu checkpoint")
    (hlen,) = struct.unpack("<Q", raw[8:16])
    return json.loads(raw[16:16 + hlen].decode()), hlen


def load_checkpoint(path: Path) -> Dict[str, Any]:
    """-> {"variables": nested dict of numpy arrays, "hparams", "metrics"}.

    An optimizer state stored by the JAX trainer is skipped (serving does
    not need it)."""
    raw = Path(path).read_bytes()
    header, hlen = _parse_header(raw, path)
    payload = msgpack.unpackb(raw[16 + hlen:])
    return {
        "variables": payload["variables"],
        "hparams": header["hparams"],
        "metrics": header["metrics"],
    }


def checkpoint_filename(epoch: int, val_loss: float, val_dice: float) -> str:
    return f"epoch={epoch}-val_loss={val_loss:.2f}-val_dice={val_dice:.4f}.ckpt"


_DICE_RE = re.compile(r"val_dice=([0-9]*\.?[0-9]+)")


def parse_val_dice(path: Path) -> Optional[float]:
    """Parse val_dice from a checkpoint filename (ensemble weighting), else
    from the metrics stored in the checkpoint; None when neither has it."""
    m = _DICE_RE.search(Path(path).name)
    if m:
        return float(m.group(1))
    try:  # fall back to the metrics in the header
        with open(path, "rb") as f:
            head = f.read(16)
            head += f.read(struct.unpack("<Q", head[8:16])[0])
        return float(_parse_header(head, path)[0]["metrics"]["val_dice"])
    except (OSError, ValueError, KeyError, TypeError, struct.error):
        return None


class TopKCheckpoints:
    """Keep the best-k checkpoints by val_dice (deletes evicted files)."""

    def __init__(self, output_dir: Path, k: int = 3):
        self.output_dir = Path(output_dir)
        self.k = k
        self.kept: List[Tuple[float, Path]] = []

    def update(self, epoch: int, val_loss: float, val_dice: float,
               variables: Dict[str, Any], hparams: Dict[str, Any]) -> Optional[Path]:
        if len(self.kept) >= self.k and val_dice <= min(d for d, _ in self.kept):
            return None
        path = self.output_dir / checkpoint_filename(epoch, val_loss, val_dice)
        save_checkpoint(path, variables, hparams,
                        metrics={"epoch": epoch, "val_loss": val_loss, "val_dice": val_dice})
        self.kept.append((val_dice, path))
        self.kept.sort(key=lambda t: -t[0])
        while len(self.kept) > self.k:
            _, evicted = self.kept.pop()
            evicted.unlink(missing_ok=True)
        return path

    @property
    def best(self) -> Optional[Path]:
        return self.kept[0][1] if self.kept else None
