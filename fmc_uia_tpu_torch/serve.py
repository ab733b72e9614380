"""HTTP model server: a REST front over the ``StreamingPredictor`` batcher
(port of ``fmc_uia_tpu/serve.py``), on the standard library's
``http.server``.

    python -m fmc_uia_tpu_torch.serve --checkpoint outputs/exp_... \\
        [--config <yaml>] [--port 8000] [--device cuda|cpu]

API (the JAX package's routes, status codes and JSON bodies):
  GET  /healthz               liveness + torch device + task count
  GET  /v1/tasks              task registry: id, type, num_classes
  GET  /v1/stats              request counters + micro-batch dispatch stats
  POST /v1/predict/<task_id>  body = encoded image bytes
        segmentation   -> image/png class-id mask at the ORIGINAL resolution
        classification -> {"class": k}
        detection      -> {"x_min","y_min","x_max","y_max"} pixel coords
        Regression     -> {"points": [[x, y], ...]} pixel coords

A PNG body is decoded by the port's own decoder (``data/image_io.py``);
an interlaced PNG, which that decoder refuses, and another format (JPEG,
BMP, ...) through cv2 or PIL when one of them is installed, else they get
the 400 of an undecodable body. Masks are resized
(nearest) to the frame's size and encoded by ``encode_png``. Each request
runs on its own server thread (``ThreadingHTTPServer``): decode and resize
on the host, then the request joins its task's queue, where the
dispatcher coalesces concurrent requests into padded micro-batches.

``--checkpoint`` is the experiment dir that ``fit`` wrote: its
``config.yaml`` snapshot (JSON text, read without PyYAML) and
``best_model.pt``; PyYAML is read only for a ``--config`` YAML file.
"""

from __future__ import annotations

import json
import threading
import time
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from fmc_uia_tpu_torch.data.dataset import _resize_image
from fmc_uia_tpu_torch.data.image_io import (
    PNG_SIGNATURE,
    _Corrupt,
    _read_other,
    decode_png,
    encode_png,
    resize_nearest,
)
from fmc_uia_tpu_torch.serving import StreamingPredictor
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    SEGMENTATION,
    TaskRegistry,
)


def _decode_image_bytes(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes -> RGB uint8 [H, W, 3], None when they cannot
    be decoded (a corrupt PNG; an interlaced PNG or another format
    without cv2 or PIL, or one they cannot read)."""
    try:
        if data.startswith(PNG_SIGNATURE):
            try:
                return decode_png(data, gray=False)
            except ValueError:  # interlaced: cv2 or PIL may read it
                pass
        return _read_other("<request body>", data, gray=False)
    except (_Corrupt, ValueError):
        return None


class ServingApp:
    """Model + batcher + counters; shared by all handler threads."""

    def __init__(self, model, registry: TaskRegistry, mean, std,
                 image_size: int, max_batch: int = 16,
                 max_delay_ms: float = 5.0, autoscale: bool = True,
                 request_timeout_s: float = 120.0, device="cuda"):
        self.registry = registry
        self.image_size = int(image_size)
        self.request_timeout_s = float(request_timeout_s)
        self.service = StreamingPredictor(
            model, registry, mean, std, image_size, max_batch=max_batch,
            max_delay_ms=max_delay_ms, autoscale=autoscale, device=device)
        self.device = self.service.predictor.device
        self.started = time.time()
        self.counters: Counter = Counter()
        self._lock = threading.Lock()

    def count(self, key: str) -> None:
        with self._lock:
            self.counters[key] += 1

    def close(self) -> None:
        self.service.close()

    # -- request handling ---------------------------------------------------
    def predict(self, task_id: str, body: bytes) -> Tuple[int, str, bytes]:
        """-> (http_status, content_type, payload)."""
        if task_id not in self.registry:
            self.count("bad_task")
            return (404, "application/json", json.dumps(
                {"error": f"unknown task_id {task_id!r}"}).encode())
        img = _decode_image_bytes(body)
        if img is None:
            self.count("bad_image")
            return (400, "application/json",
                    b'{"error": "could not decode image body"}')
        oh, ow = img.shape[:2]
        fut = self.service.submit(_resize_image(img, self.image_size),
                                  task_id)
        pred = fut.result(timeout=self.request_timeout_s)
        spec = self.registry[task_id]
        self.count(f"ok_{spec.task_name}")
        if spec.task_name == SEGMENTATION:
            mask = np.asarray(pred).astype(np.uint8)
            if mask.shape[:2] != (oh, ow):
                mask = resize_nearest(mask, oh, ow)
            return (200, "image/png", encode_png(mask))
        if spec.task_name == CLASSIFICATION:
            return (200, "application/json",
                    json.dumps({"class": int(pred)}).encode())
        if spec.task_name == DETECTION:
            box = np.asarray(pred, np.float64)
            return (200, "application/json", json.dumps({
                "x_min": float(box[0] * ow), "y_min": float(box[1] * oh),
                "x_max": float(box[2] * ow), "y_max": float(box[3] * oh),
            }).encode())
        pts = np.asarray(pred, np.float64)[: spec.num_classes * 2]
        coords = [[float(pts[2 * k] * ow), float(pts[2 * k + 1] * oh)]
                  for k in range(spec.num_classes)]
        return (200, "application/json",
                json.dumps({"points": coords}).encode())

    def tasks_payload(self) -> bytes:
        rows = [{"task_id": t, "task_type": self.registry[t].task_name,
                 "num_classes": int(self.registry[t].num_classes)}
                for t in self.registry.task_ids]
        return json.dumps(rows).encode()

    def stats_payload(self) -> bytes:
        svc = self.service.stats
        with self._lock:
            requests = dict(self.counters)
        return json.dumps({
            "uptime_s": round(time.time() - self.started, 3),
            "requests": requests,
            "dispatches": svc["dispatches"],
            "pad_images": svc["pad_images"],
            "by_batch_size": {str(k): v
                              for k, v in sorted(svc["by_size"].items())},
        }).encode()

    def health_payload(self) -> bytes:
        dev = self.device
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return json.dumps({"ok": True, "backend": dev.type,
                           "device": name, "image_size": self.image_size,
                           "tasks": len(self.registry)}).encode()


def _make_handler(app: ServingApp):
    class Handler(BaseHTTPRequestHandler):
        # one TCP connection can carry many requests
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, status: int, ctype: str, payload: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path == "/healthz":
                self._send(200, "application/json", app.health_payload())
            elif self.path == "/v1/tasks":
                self._send(200, "application/json", app.tasks_payload())
            elif self.path == "/v1/stats":
                self._send(200, "application/json", app.stats_payload())
            else:
                self._send(404, "application/json",
                           b'{"error": "not found"}')

        def do_POST(self):  # noqa: N802
            prefix = "/v1/predict/"
            if not self.path.startswith(prefix):
                self._send(404, "application/json",
                           b'{"error": "not found"}')
                return
            task_id = self.path[len(prefix):]
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                self._send(411, "application/json",
                           b'{"error": "Content-Length required"}')
                return
            body = self.rfile.read(length)
            try:
                status, ctype, payload = app.predict(task_id, body)
            except Exception as e:  # device/timeout failure: a 500
                app.count("server_error")
                status, ctype = 500, "application/json"
                payload = json.dumps({"error": str(e)}).encode()
            self._send(status, ctype, payload)

    return Handler


def make_server(app: ServingApp, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    """Bind (but don't start) the HTTP server; port 0 picks a free port."""
    server = ThreadingHTTPServer((host, port), _make_handler(app))
    server.daemon_threads = True
    return server


def main(argv=None):
    import argparse
    import os

    parser = argparse.ArgumentParser(
        description="Serve the multi-task model over HTTP")
    parser.add_argument("--config", type=str, default=None,
                        help="config path; defaults to the experiment "
                             "dir's config.yaml snapshot")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="experiment dir containing best_model.pt")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=16)
    parser.add_argument("--max-delay-ms", type=float, default=5.0)
    parser.add_argument("--no-autoscale", action="store_true",
                        help="always pad micro-batches to --max-batch")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip running every (task type, batch size) "
                             "once before serving")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from fmc_uia_tpu_torch import checkpoint as ckpt_lib
    from fmc_uia_tpu_torch.device import resolve_device
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.predict import load_snapshot_config

    dev = resolve_device(args.device)
    config_path = args.config
    if config_path is None:
        config_path = os.path.join(args.checkpoint, "config.yaml")
        if not os.path.exists(config_path):
            raise FileNotFoundError(
                f"No --config given and {config_path} not found")
    config = load_snapshot_config(config_path)
    registry = TaskRegistry.from_config(config)
    model = build_model(config, registry, device=dev, init=False)
    model.load_state_dict(ckpt_lib.load_best_params(args.checkpoint, dev))

    app = ServingApp(
        model, registry,
        config.get("data.augmentation.normalize.mean"),
        config.get("data.augmentation.normalize.std"),
        config.image_size, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, autoscale=not args.no_autoscale,
        device=dev)
    if not args.no_warmup:
        print("warmup: every (task type, batch size) once ...", flush=True)
        app.service.warmup()
    server = make_server(app, args.host, args.port)
    print(f"serving {len(registry)} tasks on "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        server.server_close()
        app.close()


if __name__ == "__main__":
    main()
