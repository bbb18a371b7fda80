"""``segmantic-unet-torch`` CLI: the ported subcommands of ``segmantic-unet``.

Port of ``segmantic_tpu/commands/unet_cli.py``: ``train``, ``train-config``,
``cross-validate``, ``predict``, ``ensemble-predict`` and ``serve``, with the
JAX flags plus ``--device`` (default ``cuda``, which fails where CUDA is not
available). ``train-config`` and ``cross-validate`` bind their config keys to
the keyword signatures of the port's ``train()`` / ``cross_validate()`` (the
JAX package's plus ``device``), with ``--print-defaults`` scaffolding and
unknown-key rejection.

``train`` and ``train-config`` train on N cards of one host when launched by
torchrun, one process a card::

    torchrun --nproc-per-node N -m segmantic_tpu_torch.commands.unet_cli \
        train-config -c cfg.json

and on M hosts by one torchrun agent a host, each given the same rendezvous::

    torchrun --nnodes M --node-rank m --nproc-per-node N --rdzv-backend c10d \
        --rdzv-endpoint host0:29400 -m segmantic_tpu_torch.commands.unet_cli \
        train-config -c cfg.json

A node is a JAX process there: its sampler draws ``batch_size * num_samples``
rows seeded ``seed + node``, the global batch is M times that, and the first
rank of each node writes the run's files, so on a filesystem the nodes share
each node's config needs its own ``output_dir`` (``model_parallel`` must
divide N; ``model_parallel`` / ``zero_optimizer`` split the mesh as in the
JAX package). ``cross-validate`` launches each fold's ``train-config``
through ``python -m torch.distributed.run --standalone --nproc-per-node N``
when the scenario trains on the card (``device: cuda``) and N > 1 cards are
visible (``torch.cuda.device_count()``, which honours
``CUDA_VISIBLE_DEVICES``), so a fold trains on every card of the host, as the
JAX fold takes every local chip; with one card, a named card (``cuda:k``) or
``device: cpu``, a fold is one plain process.
"""

from __future__ import annotations

import inspect
from pathlib import Path
from typing import Optional

import click

from ..image.labels import load_decathlon_tissuelist, load_tissue_list
from ..utils import config
from ..utils.schema import default_args_from_signature, validate_against_signature


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
    from ..train import trainer

    sig = inspect.signature(trainer.train)
    if print_defaults:
        config.dump(default_args_from_signature(sig), config_file=config_file)
        return
    if not config_file:
        raise click.UsageError("Invalid '--config-file' argument")
    trainer.train(**validate_against_signature(config.load(config_file), sig))


@app.command("cross-validate")
@click.option("--config-file", "-c", type=click.Path(path_type=Path), default=None,
              help="config file in json/yaml format")
@click.option("--print-defaults", is_flag=True, default=False)
def cross_validate_cmd(config_file: Optional[Path], print_defaults: bool) -> None:
    """Run one or several k-fold cross-validations.

    The outer config (this command's schema, the keyword signature of
    ``segmantic_tpu_torch.train.cross_validate.cross_validate``) points at a
    directory of per-scenario train-config files; each scenario trains on
    every fold in a subprocess, then the produced checkpoints are evaluated
    on the test directory if given.
    """
    from ..train import cross_validate as cv

    sig = inspect.signature(cv.cross_validate)
    if print_defaults:
        config.dump(default_args_from_signature(sig), config_file=config_file)
        return
    if not config_file:
        raise click.UsageError("Invalid '--config-file' argument")
    cv.cross_validate(**validate_against_signature(config.load(config_file), sig))


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
              help="tensor-parallel ranks per model replica; it must divide the "
                   "ranks of a 'torchrun --nproc-per-node N -m "
                   "segmantic_tpu_torch.commands.unet_cli train ...' launch")
@click.option("--accumulate-steps", type=int, default=1,
              help="average gradients over this many micro-batches per update")
@click.option("--remat/--no-remat", default=False,
              help="recompute the forward in the backward to save device memory")
@click.option("--zero-optimizer/--no-zero-optimizer", default=False,
              help="ZeRO-1: slice the optimizer moments over the data-parallel ranks "
                   "(needs more than one rank: launch with torchrun --nproc-per-node N)")
@click.option("--arch", type=click.Choice(["unet", "segresnet", "unetr"]), default="unet",
              help="segmentation architecture (unetr needs spatial_size and a "
                   "val_roi_size equal to it: configure them via train-config)")
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


def _test_cases(datalist_file: Path, datalist_key: str, tissue_list: Optional[Path]):
    """(images, labels or None, tissue dict or None) of a datalist section."""
    from ..data.datalist import load_decathlon_datalist

    datalist = load_decathlon_datalist(datalist_file, data_list_key=datalist_key)
    test_images = [Path(d["image"]) for d in datalist]
    test_labels = [Path(d["label"]) for d in datalist if "label" in d]
    if tissue_list is not None:
        tissue_dict = load_tissue_list(tissue_list)
    else:
        try:
            tissue_dict = load_decathlon_tissuelist(datalist_file)
        except KeyError:
            tissue_dict = None
    return test_images, test_labels or None, tissue_dict


@app.command("predict")
@click.option("--datalist", "-d", "datalist_file", type=click.Path(path_type=Path),
              required=True, help="decathlon style datalist json file")
@click.option("--model-file", "-m", type=click.Path(path_type=Path), required=True,
              help="saved model checkpoint")
@click.option("--tissue-list", "-t", type=click.Path(path_type=Path), default=None,
              help="label descriptors in iSEG format")
@click.option("--results-dir", "-r", type=click.Path(path_type=Path), default=None,
              help="output directory")
@click.option("--spacing", type=float, multiple=True, default=(),
              help="if specified, the image is first resampled")
@click.option("--gpu-ids", type=int, multiple=True, default=(0,))
@click.option("--datalist-key", type=str, default="test")
@click.option("--device", type=str, default="cuda",
              help="torch device; 'cuda' fails where CUDA is not available")
def predict_cmd(datalist_file: Path, model_file: Path, tissue_list: Optional[Path],
                results_dir: Optional[Path], spacing: tuple, gpu_ids: tuple,
                datalist_key: str, device: str) -> None:
    """Predict segmentations for a datalist's test section."""
    from ..infer.predict import predict

    test_images, test_labels, tissue_dict = _test_cases(datalist_file, datalist_key,
                                                        tissue_list)
    predict(model_file=model_file, test_images=test_images, test_labels=test_labels,
            tissue_dict=tissue_dict, output_dir=results_dir, spacing=list(spacing),
            gpu_ids=list(gpu_ids), device=device)


@app.command("ensemble-predict")
@click.option("--datalist", "-d", "datalist_file", type=click.Path(path_type=Path),
              required=True, help="decathlon style datalist json file")
@click.option("--models-dir", "-m", type=click.Path(path_type=Path), required=True,
              help="directory of saved model checkpoints")
@click.option("--tissue-list", "-t", type=click.Path(path_type=Path), default=None)
@click.option("--results-dir", "-r", type=click.Path(path_type=Path), default=None)
@click.option("--combination-mode", "-cm",
              type=click.Choice(["mean", "vote", "select_best"]), required=True)
@click.option("--candidate-yaml", "-cy", "candidate_per_tissue_path",
              type=click.Path(path_type=Path), default=None,
              help="yaml with best model for tissues")
@click.option("--spacing", type=float, multiple=True, default=())
@click.option("--gpu-ids", type=int, multiple=True, default=(0,))
@click.option("--datalist-key", type=str, default="test")
@click.option("--device", type=str, default="cuda",
              help="torch device; 'cuda' fails where CUDA is not available")
def ensemble_predict_cmd(datalist_file: Path, models_dir: Path, tissue_list: Optional[Path],
                         results_dir: Optional[Path], combination_mode: str,
                         candidate_per_tissue_path: Optional[Path], spacing: tuple,
                         gpu_ids: tuple, datalist_key: str, device: str) -> None:
    """Ensemble-based prediction over all checkpoints in a directory."""
    from ..infer.ensemble import ensemble_creator

    test_images, test_labels, tissue_dict = _test_cases(datalist_file, datalist_key,
                                                        tissue_list)
    ensemble_creator(
        model_files=sorted(
            p for p in Path(models_dir).glob("*.ckpt") if p.name != "last.ckpt"
        ),
        test_images=test_images, test_labels=test_labels, tissue_dict=tissue_dict,
        output_dir=results_dir, combination_mode=combination_mode,
        candidate_per_tissue_path=candidate_per_tissue_path, spacing=list(spacing),
        gpu_ids=list(gpu_ids), device=device,
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
