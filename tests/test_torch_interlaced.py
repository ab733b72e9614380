"""Interlaced (Adam7) PNGs on the port's read path: ``read_image``,
``read_mask``, the dataset and ``export_predictions``, with cv2/PIL
importable (the file is read as the JAX package reads it) and with both
hidden (None for an image and ``Undecodable`` for a mask, one message a
process, the dataset's corrupt-image retry for either, the frame skipped
by export).

Tolerances: pixels and masks exact against the JAX package's cv2 decode;
the dataset's resized image within 1 of the JAX package's (cv2 resizes in
fixed point), its labels exact.
"""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

from fmc_uia_tpu.data.dataset import MultiTaskDataset as JaxDataset
from fmc_uia_tpu.data.dataset import _decode_image, _decode_mask
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data import image_io
from fmc_uia_tpu_torch.data.dataset import MultiTaskDataset
from fmc_uia_tpu_torch.data.device_cache import DeviceDatasetCache
from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset
from fmc_uia_tpu_torch.export import export_predictions
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.tasks import TaskRegistry
from helpers import make_tiny_config

S = 32
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def interlaced_png(a: np.ndarray) -> bytes:
    """An Adam7-interlaced 8-bit PNG of gray [H, W] or RGB [H, W, 3]
    ``a`` (every row unfiltered)."""
    h, w = a.shape[:2]
    ctype = 0 if a.ndim == 2 else 2
    raw = b"".join(b"\0" + row.tobytes() for x0, y0, dx, dy in _ADAM7
                   for row in a[y0::dy, x0::dx])

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def hide_cv2_and_pil(monkeypatch):
    for mod in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)  # import raises
    monkeypatch.setattr(image_io, "_interlace_noted", False)


@pytest.fixture()
def frames(tmp_path):
    rng = np.random.RandomState(5)
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    mask = rng.randint(0, 3, (9, 11)).astype(np.uint8)
    paths = {"rgb": str(tmp_path / "rgb.png"), "mask": str(tmp_path / "m.png")}
    with open(paths["rgb"], "wb") as f:
        f.write(interlaced_png(rgb))
    with open(paths["mask"], "wb") as f:
        f.write(interlaced_png(mask))
    return rgb, mask, paths


def test_read_image_and_mask_match_jax(frames):
    rgb, mask, paths = frames
    with pytest.raises(ValueError, match="interlaced"):
        image_io.decode_png(open(paths["rgb"], "rb").read(), False)
    got = image_io.read_image(paths["rgb"])
    np.testing.assert_array_equal(got, _decode_image(paths["rgb"]))
    np.testing.assert_array_equal(got, rgb)
    got = image_io.read_mask(paths["mask"])
    np.testing.assert_array_equal(got, _decode_mask(paths["mask"]))
    np.testing.assert_array_equal(got, mask)


def test_without_cv2_and_pil_gives_none_once_noted(frames, monkeypatch,
                                                   capsys):
    _, _, paths = frames
    hide_cv2_and_pil(monkeypatch)
    assert image_io.read_image(paths["rgb"]) is None
    # a mask raises instead: the dataset skips its row (a zero label would
    # train on background)
    with pytest.raises(image_io.Undecodable, match="m.png"):
        image_io.read_mask(paths["mask"])
    out = capsys.readouterr().out
    assert out.count("[data]") == 1 and "rgb.png: an interlaced PNG" in out
    # a file that is not a PNG still raises without both
    other = os.path.join(os.path.dirname(paths["rgb"]), "x.bmp")
    with open(other, "wb") as f:
        f.write(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="neither cv2 nor PIL"):
        image_io.read_image(other)


@pytest.fixture()
def dataset_root(tmp_path):
    """A synthetic dataset whose first segmentation frame and its mask are
    rewritten interlaced."""
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, samples_per_task=4, seed=2)
    ds = MultiTaskDataset(root, image_size=S)
    idx = next(i for i, r in enumerate(ds.rows)
               if r["task_name"] == "segmentation")
    row = ds.rows[idx]
    for key, read in (("image_path", image_io.read_image),
                      ("mask_path", image_io.read_mask)):
        path = os.path.join(ds.csv_path, row[key])
        a = read(path)
        with open(path, "wb") as f:
            f.write(interlaced_png(a))
    return root, idx


def test_dataset_reads_interlaced_rows(dataset_root, monkeypatch):
    root, idx = dataset_root
    got = MultiTaskDataset(root, image_size=S)[idx]
    ref = JaxDataset(root, image_size=S)[idx]
    assert got["source_index"] == ref["source_index"] == idx
    assert np.abs(got["image"].astype(int) - ref["image"]).max() <= 1
    np.testing.assert_array_equal(got["label"], ref["label"])
    assert got["label"].any()  # the mask was read, not zeros
    # without cv2 and PIL: the image row falls to the next row (the
    # corrupt-image retry), whose own mask is read
    hide_cv2_and_pil(monkeypatch)
    ds = MultiTaskDataset(root, image_size=S)
    item = ds[idx]
    assert item["source_index"] == idx + 1
    np.testing.assert_array_equal(item["image"], ds[idx + 1]["image"])


def test_dataset_retries_a_row_whose_mask_is_undecodable(tmp_path,
                                                         monkeypatch):
    """A plain image with an interlaced mask: with cv2 the mask is read as
    the JAX package reads it; without cv2 and PIL the row is retried like
    a corrupt image (not trained on an all-background label), and the
    device cache records the substitution."""
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, samples_per_task=4, seed=2)
    ds = MultiTaskDataset(root, image_size=S)
    idx = next(i for i, r in enumerate(ds.rows)
               if r["task_name"] == "segmentation")
    path = os.path.join(ds.csv_path, ds.rows[idx]["mask_path"])
    mask = image_io.read_mask(path)
    with open(path, "wb") as f:
        f.write(interlaced_png(mask))
    got = MultiTaskDataset(root, image_size=S)[idx]
    assert got["source_index"] == idx and got["label"].any()
    np.testing.assert_array_equal(got["label"],
                                  JaxDataset(root, image_size=S)[idx]["label"])
    hide_cv2_and_pil(monkeypatch)
    ds = MultiTaskDataset(root, image_size=S)
    item = ds[idx]
    assert item["source_index"] == idx + 1
    np.testing.assert_array_equal(item["label"], ds[idx + 1]["label"])
    registry = TaskRegistry(ds.derive_task_configs())
    cache = DeviceDatasetCache(ds, range(len(ds)), registry, device="cpu")
    assert cache.substituted == [(idx, idx + 1)]


def test_export_reads_or_skips_interlaced_frames(dataset_root, tmp_path,
                                                 monkeypatch):
    root, idx = dataset_root
    cfg = Config(config_dict=make_tiny_config(
        model={"encoder": {"name": "swin_micro", "window_size": 8}},
        data={"image_size": S}).config)
    ds = MultiTaskDataset(root, image_size=S)
    registry = TaskRegistry(ds.derive_task_configs())
    cfg.set_task_configs_from_dataset(ds.derive_task_configs())
    model = build_model(cfg, registry, device="cpu")
    norm = cfg.get("data.augmentation.normalize")
    tid = ds.rows[idx]["task_id"]
    n_rows = sum(r["task_id"] == tid for r in ds.rows)

    def records(out):
        paths = export_predictions(model, root, str(out), registry,
                                   norm["mean"], norm["std"], S,
                                   batch_size=4, device="cpu")
        with open(paths[tid]) as f:
            return json.load(f)

    assert len(records(tmp_path / "with")) == n_rows
    hide_cv2_and_pil(monkeypatch)
    assert len(records(tmp_path / "without")) == n_rows - 1
