"""``segmantic-unet-torch`` CLI: the ported subcommands of ``segmantic-unet``.

Port of ``segmantic_tpu/commands/unet_cli.py``; only ``serve`` so far (the
training, prediction and ensemble subcommands follow the ROADMAP).
"""

from __future__ import annotations

from pathlib import Path

import click


@click.group()
def app() -> None:
    """Semantic segmentation on PyTorch / CUDA (segmantic-unet-torch)."""


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
