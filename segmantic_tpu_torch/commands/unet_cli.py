"""``segmantic-unet-torch`` CLI: the ported subcommands of ``segmantic-unet``.

Port of ``segmantic_tpu/commands/unet_cli.py``: ``train``, ``train-config``
and ``serve`` so far (prediction, ensembling and cross-validation follow the
ROADMAP). ``train-config`` binds its config keys to the keyword signature of
the port's ``train()`` (the JAX package's plus ``device``), with
``--print-defaults`` scaffolding and unknown-key rejection.
"""

from __future__ import annotations

import inspect
from pathlib import Path
from typing import Optional

import click


@click.group()
def app() -> None:
    """Semantic segmentation on PyTorch / CUDA (segmantic-unet-torch)."""


@app.command("train-config")
@click.option("--config-file", "-c", type=click.Path(path_type=Path), default=None,
              help="config file in json/yaml format")
@click.option("--print-defaults", is_flag=True, default=False,
              help="write a default config scaffold and exit")
def train_config(config_file: Optional[Path], print_defaults: bool) -> None:
    """Train UNet with configuration provided as json/yaml file.

    The config keys mirror the keyword signature of
    ``segmantic_tpu_torch.train.trainer.train`` (``device`` defaults to
    'cuda', which fails where CUDA is not available).
    """
    from segmantic_tpu.utils import config
    from segmantic_tpu.utils.schema import (
        default_args_from_signature, validate_against_signature,
    )

    from ..train import trainer

    sig = inspect.signature(trainer.train)
    if print_defaults:
        config.dump(default_args_from_signature(sig), config_file=config_file)
        return
    if not config_file:
        raise click.UsageError("Invalid '--config-file' argument")
    trainer.train(**validate_against_signature(config.load(config_file), sig))


@app.command("train")
@click.option("--datalist", "-d", "datalist_file", type=click.Path(path_type=Path),
              required=True, help="decathlon style datalist json file")
@click.option("--tissue-list", "-t", type=click.Path(path_type=Path), default=None,
              help="label descriptors in iSEG format")
@click.option("--output-dir", "-r", type=click.Path(path_type=Path),
              default=Path("results"), help="output directory for checkpoints/logs")
@click.option("--num-channels", type=int, default=1)
@click.option("--max-epochs", type=int, default=600)
@click.option("--gpu-ids", type=int, multiple=True, default=(0,))
@click.option("--model-parallel", type=int, default=1,
              help="not ported yet: values other than 1 raise")
@click.option("--accumulate-steps", type=int, default=1,
              help="not ported yet: values other than 1 raise")
@click.option("--remat/--no-remat", default=False, help="not ported yet: --remat raises")
@click.option("--zero-optimizer/--no-zero-optimizer", default=False,
              help="not ported yet: --zero-optimizer raises")
@click.option("--arch", type=click.Choice(["unet", "segresnet", "unetr"]), default="unet",
              help="segmentation architecture (the port has unet)")
@click.option("--device", type=str, default="cuda",
              help="torch device; 'cuda' fails where CUDA is not available")
def train_cmd(datalist_file: Path, tissue_list: Optional[Path], output_dir: Path,
              num_channels: int, max_epochs: int, gpu_ids: tuple, model_parallel: int,
              accumulate_steps: int, remat: bool, zero_optimizer: bool, arch: str,
              device: str) -> None:
    """Train a segmentation model directly from flags."""
    from ..train import trainer

    trainer.train(
        datalist=datalist_file, tissue_list=tissue_list, num_channels=num_channels,
        max_epochs=max_epochs, output_dir=output_dir, gpu_ids=list(gpu_ids),
        model_parallel=model_parallel, accumulate_steps=accumulate_steps, remat=remat,
        zero_optimizer=zero_optimizer, arch=arch, device=device,
    )


@app.command("serve")
@click.option("--model-file", "-m", type=click.Path(path_type=Path), required=True,
              help="trained checkpoint to serve (either package's)")
@click.option("--host", type=str, default="127.0.0.1")
@click.option("--port", type=int, default=8765)
@click.option("--spacing", type=float, multiple=True, default=(),
              help="resample to this spacing before inference")
@click.option("--sw-batch-size", type=int, default=4)
@click.option("--overlap", type=float, default=0.25)
@click.option("--device", type=str, default="cuda",
              help="torch device; 'cuda' fails where CUDA is not available")
def serve_cmd(model_file: Path, host: str, port: int, spacing, sw_batch_size,
              overlap, device):
    """Serve the model over HTTP: POST NIfTI to /v1/segment."""
    from ..serve import serve

    serve(model_file, host=host, port=port, spacing=list(spacing),
          sw_batch_size=sw_batch_size, overlap=overlap, device=device)


def main() -> None:
    app()


if __name__ == "__main__":
    main()
