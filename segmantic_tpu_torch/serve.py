"""HTTP inference serving: NIfTI in -> segmented NIfTI out.

Port of ``segmantic_tpu/serve.py``: a stdlib ``http.server`` endpoint around
one loaded checkpoint, requests served one at a time per process (one
device stream), NIfTI (.nii or .nii.gz) bytes both ways.

API:
  GET  /v1/health  -> {"status": "ok"}
  GET  /v1/info    -> model hyperparameters json
  POST /v1/segment -> body: NIfTI image; response: NIfTI label map
                      (application/gzip), same grid/affine as the input.

CLI: ``segmantic-unet-torch serve -m model.ckpt --port 8765 [--device cuda]``.
The device is explicit: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import json
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Sequence

from segmantic_tpu.io.nifti import read_volume, write_volume

from .infer.predict import segment_volume
from .train.trainer import SegmentationModel, make_val_forward


class InferenceSession:
    """One loaded model and its eval forward, shared across requests."""

    def __init__(
        self,
        model_file: Path,
        spacing: Sequence[float] = (),
        sw_batch_size: int = 4,
        overlap: float = 0.25,
        device="cuda",
    ):
        self.model = SegmentationModel.load(Path(model_file), device=device)
        self.val_forward = make_val_forward(self.model.module)
        self.spacing = list(spacing)
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self._lock = threading.Lock()  # one device stream: serialize inference

    @property
    def info(self) -> dict:
        return dict(self.model.hparams)

    def segment_bytes(self, payload: bytes) -> bytes:
        """NIfTI bytes in -> predicted label-map NIfTI (.nii.gz) bytes out."""
        with tempfile.TemporaryDirectory() as td:
            in_path = Path(td) / "input.nii.gz"
            in_path.write_bytes(payload)
            vol = read_volume(in_path)
            with self._lock:
                pred, _ = segment_volume(
                    self.model, vol, val_forward=self.val_forward,
                    spacing=self.spacing, sw_batch_size=self.sw_batch_size,
                    overlap=self.overlap,
                )
            out_path = Path(td) / "pred.nii.gz"
            write_volume(out_path, pred)
            return out_path.read_bytes()


def make_server(session: InferenceSession, host: str = "127.0.0.1",
                port: int = 8765) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server around a session."""

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/v1/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/info":
                self._json(200, session.info)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/segment":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._json(400, {"error": "empty body; POST NIfTI bytes"})
                return
            payload = self.rfile.read(length)
            try:
                out = session.segment_bytes(payload)
            except Exception as err:  # surface decode/shape errors to the client
                self._json(400, {"error": f"segmentation failed: {err}"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/gzip")
            self.send_header("Content-Disposition", 'attachment; filename="pred.nii.gz"')
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve(
    model_file: Path,
    host: str = "127.0.0.1",
    port: int = 8765,
    spacing: Sequence[float] = (),
    sw_batch_size: int = 4,
    overlap: float = 0.25,
    device="cuda",
) -> None:
    """Load the model and serve until interrupted."""
    session = InferenceSession(model_file, spacing=spacing,
                               sw_batch_size=sw_batch_size, overlap=overlap,
                               device=device)
    server = make_server(session, host, port)
    print(f"serving {model_file} on http://{host}:{server.server_address[1]}"
          f" ({session.model.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
