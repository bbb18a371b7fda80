"""``segmantic-i2i-torch``: image-to-image style-transfer CLI (pix2pix /
CycleGAN) on PyTorch / CUDA.

Port of ``segmantic_tpu/commands/i2i_cli.py``: the ``pix2pix`` (paired),
``cyclegan`` (unpaired) and ``translate`` subcommands with the JAX flags and
defaults, plus ``--device`` (default ``cuda``, which fails where CUDA is not
available). Checkpoints are the JAX package's, readable by either CLI.
``pix2pix`` and ``cyclegan`` train data-parallel on N cards when launched by
torchrun, one process a card (each rank takes its rows of every batch)::

    torchrun --nproc-per-node N -m segmantic_tpu_torch.commands.i2i_cli pix2pix ...

On M nodes (``--nnodes M --node-rank m --rdzv-backend c10d --rdzv-endpoint
host:port`` on each) every node feeds its own batches, as every JAX process
does, and the global batch is the nodes' batches in node order. The first
rank of each node writes the checkpoint, so on a filesystem the nodes share
each node needs its own ``--output-dir``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import click

from ..utils.file_iterators import find_matching_files


@click.group()
def app() -> None:
    """Image-to-image translation (pix2pix / CycleGAN) on PyTorch / CUDA."""


def _paired_dataset(
    source: str,
    target: str,
    batch_size: int,
    slice_axis: int,
    spacing: Tuple[float, ...],
    seed: int,
):
    from ..i2i.data import PairedSliceDataset

    pairs = [
        (s, t) for s, t in find_matching_files([Path(source), Path(target)])
    ]
    if not pairs:
        raise click.UsageError(
            f"no stem-matched volume pairs from {source!r} / {target!r}"
        )
    return PairedSliceDataset(
        pairs,
        batch_size=batch_size,
        axis=slice_axis,
        spacing=tuple(spacing) if spacing else None,
        seed=seed,
    )


_shared = [
    click.option("--source", "-s", required=True,
                 help="source-domain glob, e.g. 'data/*_t1.nii.gz'"),
    click.option("--target", "-t", required=True,
                 help="target-domain glob (stem-matched against --source)"),
    click.option("--output-dir", "-r", type=click.Path(path_type=Path),
                 required=True),
    click.option("--steps", type=int, default=1000, show_default=True),
    click.option("--batch-size", type=int, default=16, show_default=True),
    click.option("--slice-axis", type=int, default=2, show_default=True,
                 help="volume axis perpendicular to the training slices"),
    click.option("--spacing", type=float, multiple=True,
                 help="optional target spacing (resampled on device)"),
    click.option("--base-features", type=int, default=64, show_default=True),
    click.option("--n-blocks", type=int, default=6, show_default=True),
    click.option("--lr", type=float, default=2e-4, show_default=True),
    click.option("--seed", type=int, default=0, show_default=True),
    click.option("--log-every", type=int, default=100, show_default=True),
    click.option("--device", default="cuda", show_default=True,
                 help="torch device ('cuda' fails where CUDA is not available)"),
]


def _with_shared(fn):
    for opt in reversed(_shared):
        fn = opt(fn)
    return fn


@app.command("pix2pix")
@_with_shared
@click.option("--lambda-l1", type=float, default=100.0, show_default=True)
def pix2pix_cmd(
    source: str,
    target: str,
    output_dir: Path,
    steps: int,
    batch_size: int,
    slice_axis: int,
    spacing: Tuple[float, ...],
    base_features: int,
    n_blocks: int,
    lr: float,
    seed: int,
    log_every: int,
    device: str,
    lambda_l1: float,
) -> None:
    """Train a paired pix2pix translator on stem-matched volume pairs.

    On N cards: torchrun --nproc-per-node N -m
    segmantic_tpu_torch.commands.i2i_cli pix2pix ... (data-parallel)."""
    from ..i2i.train import train_pix2pix

    data = _paired_dataset(
        source, target, batch_size, slice_axis, spacing, seed=seed
    )
    click.echo(
        f"pix2pix: {data.num_slices} slices @ {data.slice_shape}, "
        f"{len(data)} batches/epoch"
    )
    result = train_pix2pix(
        data,
        steps=steps,
        lambda_l1=lambda_l1,
        lr=lr,
        base_features=base_features,
        n_blocks=n_blocks,
        seed=seed,
        output_dir=output_dir,
        log_every=log_every,
        device=device,
        extra_hparams={
            "slice_axis": slice_axis,
            "source_window": list(data.source_window),
            "target_window": list(data.target_window),
        },
    )
    click.echo(f"saved generator checkpoint: {result.checkpoint}")


@app.command("cyclegan")
@_with_shared
@click.option("--lambda-cycle", type=float, default=10.0, show_default=True)
@click.option("--lambda-identity", type=float, default=0.5, show_default=True)
def cyclegan_cmd(
    source: str,
    target: str,
    output_dir: Path,
    steps: int,
    batch_size: int,
    slice_axis: int,
    spacing: Tuple[float, ...],
    base_features: int,
    n_blocks: int,
    lr: float,
    seed: int,
    log_every: int,
    device: str,
    lambda_cycle: float,
    lambda_identity: float,
) -> None:
    """Train an unpaired CycleGAN between two volume domains.

    The two globs are independent — no stem matching is required (CycleGAN
    is an unpaired method); every volume each glob hits joins its domain.
    On N cards: torchrun --nproc-per-node N -m
    segmantic_tpu_torch.commands.i2i_cli cyclegan ... (data-parallel).
    """
    from ..i2i.data import UnpairedSliceDataset
    from ..i2i.train import train_cyclegan

    a_glob, b_glob = Path(source), Path(target)
    a_files = sorted(a_glob.parent.glob(a_glob.name))
    b_files = sorted(b_glob.parent.glob(b_glob.name))
    if not a_files or not b_files:
        raise click.UsageError(
            f"empty domain: {source!r} -> {len(a_files)} file(s), "
            f"{target!r} -> {len(b_files)} file(s)"
        )
    data = UnpairedSliceDataset(
        a_files,
        b_files,
        batch_size=batch_size,
        axis=slice_axis,
        spacing=tuple(spacing) if spacing else None,
        seed=seed,
    )
    click.echo(
        f"cyclegan: {data.num_slices} slices @ {data.slice_shape}, "
        f"{len(data)} batches/epoch"
    )
    result = train_cyclegan(
        data,
        steps=steps,
        lambda_cycle=lambda_cycle,
        lambda_identity=lambda_identity,
        lr=lr,
        base_features=base_features,
        n_blocks=n_blocks,
        seed=seed,
        output_dir=output_dir,
        log_every=log_every,
        device=device,
        extra_hparams={
            "slice_axis": slice_axis,
            "source_window": list(data.source_window),
            "target_window": list(data.target_window),
        },
    )
    click.echo(f"saved generator checkpoint: {result.checkpoint}")


@app.command("translate")
@click.option("--model-file", "-m", type=click.Path(path_type=Path),
              required=True, help="pix2pix/cyclegan generator checkpoint")
@click.option("--input", "-i", "input_glob", required=True,
              help="input volume file or glob")
@click.option("--output-dir", "-r", type=click.Path(path_type=Path),
              required=True)
@click.option("--direction", type=click.Choice(["ab", "ba"]), default="ab",
              show_default=True, help="generator direction (cyclegan only)")
@click.option("--batch-size", type=int, default=16, show_default=True)
@click.option("--slice-axis", type=int, default=None,
              help="override the slice axis stored in the checkpoint")
@click.option("--raw-tanh", is_flag=True, default=False,
              help="keep outputs in [-1, 1] instead of the training "
                   "target intensity window")
@click.option("--device", default="cuda", show_default=True,
              help="torch device ('cuda' fails where CUDA is not available)")
def translate_cmd(
    model_file: Path,
    input_glob: str,
    output_dir: Path,
    direction: str,
    batch_size: int,
    slice_axis: Optional[int],
    raw_tanh: bool,
    device: str,
) -> None:
    """Translate whole volumes with a trained generator, save as NIfTI."""
    from ..i2i.data import load_generator, translate_volume
    from ..io.nifti import read_volume, write_volume

    in_path = Path(input_glob)
    files = (
        [in_path]
        if in_path.exists()
        else sorted(in_path.parent.glob(in_path.name))
    )
    if not files:
        raise click.UsageError(f"no input volumes match {input_glob!r}")

    apply_fn, hparams = load_generator(model_file, direction=direction, device=device)
    axis = slice_axis if slice_axis is not None else int(
        hparams.get("slice_axis", 2)
    )
    out_window = None
    if not raw_tanh:
        key = "target_window" if direction == "ab" else "source_window"
        if hparams.get(key):
            out_window = tuple(hparams[key])

    output_dir.mkdir(parents=True, exist_ok=True)
    for f in files:
        vol = read_volume(f)
        out = translate_volume(
            apply_fn, vol, axis=axis, batch_size=batch_size,
            output_window=out_window,
        )
        dst = output_dir / f.name.replace(".nii", "_translated.nii")
        if dst == output_dir / f.name:  # non-NIfTI suffix: append instead
            dst = output_dir / (f.name + "_translated.nii.gz")
        write_volume(dst, out)
        click.echo(f"translated {f} -> {dst}")


def main() -> None:
    app()


if __name__ == "__main__":
    main()
