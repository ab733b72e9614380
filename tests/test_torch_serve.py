"""The port's HTTP front (``fmc_uia_tpu_torch/serve.py``) on the CPU with a
tiny model (swin_micro at 32², device="cpu"), covering what
tests/test_serve.py covers for the JAX package — health, the task list,
one predict per task type, the errors, concurrent requests — with every
answer held against the port's ``Predictor`` on the same resized frame:
mask PNGs decoded equal to its mask resized (nearest) to the frame, class
ids equal, boxes and points within 1e-4 of the frame's size (the server
batches requests, so a sum may run at another batch size). A non-PNG
body, and an interlaced PNG (which the port's decoder refuses), decode
through cv2 or PIL, and get a 400 when neither can be imported. ``main``
serves an experiment dir in a subprocess.
"""

import json
import os
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from fmc_uia_tpu_torch import checkpoint as ckpt_lib
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.dataset import _resize_image
from fmc_uia_tpu_torch.data.image_io import (
    PNG_SIGNATURE,
    decode_png,
    encode_png,
    resize_nearest,
)
from fmc_uia_tpu_torch.export import Predictor
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.serve import ServingApp, make_server
from fmc_uia_tpu_torch.tasks import TaskRegistry
from helpers import TINY_CONFIG, make_tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 32
OH, OW = 48, 40  # the frame's size: not the model's, on purpose
NORM = TINY_CONFIG["data"]["augmentation"]["normalize"]
TASKS = ("T2A_organ_a", "T1_planes", "T4_box", "T5_points")


def _config():
    return Config(config_dict=make_tiny_config(
        data={"image_size": S},
        model={"encoder": {"name": "swin_micro", "window_size": 8,
                           "fused_block": True, "fused_mlp": True}}).config)


def bmp_bytes(rgb: np.ndarray) -> bytes:
    """A 24-bit BMP of an RGB uint8 image (bottom-up BGR rows padded to 4
    bytes): a lossless format that is not PNG."""
    h, w, _ = rgb.shape
    row = (3 * w + 3) // 4 * 4
    px = np.zeros((h, row), np.uint8)
    px[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHI", b"BM", 54 + px.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, px.size, 2835,
                       2835, 0, 0)
    return head + info + px.tobytes()


def interlaced_png(rgb: np.ndarray) -> bytes:
    """An Adam7-interlaced 8-bit RGB PNG of ``rgb`` (every row unfiltered)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\0" + row.tobytes()
                   for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8),
                                          (0, 4, 4, 8), (2, 0, 4, 4),
                                          (0, 2, 2, 4), (1, 0, 2, 2),
                                          (0, 1, 1, 2))
                   for row in rgb[y0::dy, x0::dx])

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def served():
    cfg = _config()
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    app = ServingApp(model, reg, NORM["mean"], NORM["std"], S, max_batch=4,
                     max_delay_ms=5.0, device="cpu")
    server = make_server(app, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    pred = Predictor(model, reg, NORM["mean"], NORM["std"], S, device="cpu")
    yield dict(url=f"http://127.0.0.1:{server.server_address[1]}", app=app,
               reg=reg, pred=pred)
    server.shutdown()
    server.server_close()
    app.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=240) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _frame(seed):
    return np.random.RandomState(seed).randint(
        0, 256, (OH, OW, 3)).astype(np.uint8)


def check_answer(served, task_id, img, status, ctype, body):
    """One answer against ``Predictor`` on the same resized frame."""
    assert status == 200
    spec = served["reg"][task_id]
    ref = served["pred"].predict_images(_resize_image(img, S)[None],
                                        task_id)[0]
    if spec.task_name == "segmentation":
        assert ctype == "image/png"
        mask = decode_png(body, gray=True)
        np.testing.assert_array_equal(
            mask, resize_nearest(ref.astype(np.uint8), OH, OW))
        return
    assert ctype == "application/json"
    got = json.loads(body)
    if spec.task_name == "classification":
        assert got == {"class": int(ref)}
        return
    if spec.task_name == "detection":
        vals = [got["x_min"], got["y_min"], got["x_max"], got["y_max"]]
        want = ref[:4]
    else:
        assert len(got["points"]) == spec.num_classes
        vals = [v for pt in got["points"] for v in pt]
        want = ref[:2 * spec.num_classes]
    for k, (g, v) in enumerate(zip(vals, want)):
        dim = OW if k % 2 == 0 else OH
        assert abs(g - float(v) * dim) <= 1e-4 * dim, (k, g, v)


def test_health_and_tasks(served):
    status, ctype, body = _get(served["url"] + "/healthz")
    assert status == 200 and ctype == "application/json"
    assert json.loads(body) == {"ok": True, "backend": "cpu",
                                "device": "cpu", "image_size": S,
                                "tasks": 6}
    status, _, body = _get(served["url"] + "/v1/tasks")
    rows = json.loads(body)
    reg = served["reg"]
    assert rows == [{"task_id": t, "task_type": reg[t].task_name,
                     "num_classes": reg[t].num_classes}
                    for t in reg.task_ids]


def test_predict_each_type_matches_predictor(served):
    img = _frame(0)
    before = json.loads(_get(served["url"] + "/v1/stats")[2])
    for task_id in TASKS:
        check_answer(served, task_id, img,
                     *_post(served["url"] + f"/v1/predict/{task_id}",
                            encode_png(img)))
    stats = json.loads(_get(served["url"] + "/v1/stats")[2])
    assert stats["dispatches"] >= before["dispatches"] + 4
    for t in ("segmentation", "classification", "detection", "Regression"):
        assert (stats["requests"][f"ok_{t}"]
                == before["requests"].get(f"ok_{t}", 0) + 1)


def test_non_png_body_decodes_through_cv2_or_pil(served):
    img = _frame(1)
    for task_id in ("T2A_organ_a", "T5_points"):
        check_answer(served, task_id, img,
                     *_post(served["url"] + f"/v1/predict/{task_id}",
                            bmp_bytes(img)))


def test_non_png_body_without_cv2_or_pil_gets_400(served, monkeypatch):
    for mod in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)  # import raises
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served["url"] + "/v1/predict/T1_planes", bmp_bytes(_frame(2)))
    assert e.value.code == 400
    assert json.loads(e.value.read()) == {
        "error": "could not decode image body"}
    # a PNG still decodes without them
    check_answer(served, "T1_planes", _frame(2),
                 *_post(served["url"] + "/v1/predict/T1_planes",
                        encode_png(_frame(2))))


def test_interlaced_png_body_decodes_through_cv2_or_pil(served,
                                                        monkeypatch):
    img = _frame(3)
    body = interlaced_png(img)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(body, gray=False)
    for task_id in ("T4_box", "T1_planes"):
        check_answer(served, task_id, img,
                     *_post(served["url"] + f"/v1/predict/{task_id}", body))
    for mod in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)  # import raises
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served["url"] + "/v1/predict/T4_box", body)
    assert e.value.code == 400
    assert json.loads(e.value.read()) == {
        "error": "could not decode image body"}


def test_concurrent_requests_batch(served):
    imgs = [_frame(10 + i) for i in range(8)]
    before = json.loads(_get(served["url"] + "/v1/stats")[2])
    results = [None] * 8

    def call(i):
        results[i] = _post(served["url"] + "/v1/predict/T1_planes",
                           encode_png(imgs[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads)
    for img, r in zip(imgs, results):
        check_answer(served, "T1_planes", img, *r)
    stats = json.loads(_get(served["url"] + "/v1/stats")[2])
    assert (stats["requests"]["ok_classification"]
            == before["requests"].get("ok_classification", 0) + 8)
    served_imgs = sum(int(k) * v for k, v in stats["by_batch_size"].items())
    assert served_imgs == (sum(int(k) * v for k, v in
                               before["by_batch_size"].items()) + 8
                           + stats["pad_images"] - before["pad_images"])


def test_errors(served):
    url = served["url"]
    img = encode_png(_frame(3))
    for path, body, code in (("/v1/predict/nope", img, 404),
                             ("/v1/predict/T1_planes", b"not an image", 400),
                             ("/v1/other", img, 404),
                             ("/v1/predict/T1_planes", b"", 411)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + path, body)
        assert e.value.code == code, path
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url + "/nope")
    assert e.value.code == 404
    stats = json.loads(_get(url + "/v1/stats")[2])
    assert stats["requests"]["bad_task"] >= 1
    assert stats["requests"]["bad_image"] >= 1


def test_main_serves_an_experiment_dir(tmp_path):
    """``python -m fmc_uia_tpu_torch.serve --checkpoint <dir> --device cpu``
    on a dir with fit's snapshot (JSON text) and best_model.pt."""
    cfg = _config()
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    (tmp_path / "config.yaml").write_text(json.dumps(cfg.config))
    ckpt_lib.save_best_params(tmp_path, model)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fmc_uia_tpu_torch.serve", "--checkpoint",
         str(tmp_path), "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--max-batch", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = ""
        while not line.startswith("serving"):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-3000:]
        assert line.startswith("serving 6 tasks on http://127.0.0.1:")
        url = line.split()[-1]
        assert json.loads(_get(url + "/healthz")[2])["backend"] == "cpu"
        pred = Predictor(model, reg, NORM["mean"], NORM["std"], S,
                         device="cpu")
        img = _frame(4)
        status, _, body = _post(url + "/v1/predict/T1_planes",
                                encode_png(img))
        ref = pred.predict_images(_resize_image(img, S)[None], "T1_planes")
        assert status == 200 and json.loads(body) == {"class": int(ref[0])}
    finally:
        proc.kill()
        proc.communicate(timeout=30)
