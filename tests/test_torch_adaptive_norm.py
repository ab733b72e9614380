"""Adaptive normalisation (``data.use_adaptive_norm``, ``data.bg_threshold``)
in numpy against the JAX package's cv2 branch, on seeded synthetic frames:
ultrasound-like fans of speckle on a dark background, and uniform noise.

Tolerances:
- Otsu's threshold: equal to cv2's ``THRESH_OTSU``.
- The valid mask: exact for 'auto' and a number. For 'adaptive', at most
  0.5 % of the pixels may differ: cv2 blurs in f32 in its own order and
  rounds the mean to uint8, so a pixel whose blurred mean lies within an
  ulp of x.5, at 10 or 11 below the pixel, may fall on the other side of
  the threshold.
- The normalised frame: exact, with the port's own mask wherever it
  agrees with JAX's on the whole frame (always, for 'auto' and a number),
  and on every frame given JAX's mask (the same numpy calls on the same
  mask).
- The resized f32 frame: within 1e-6 of cv2's INTER_LINEAR.
- The fit: finite losses, the identity input prep (K3 not called).
"""

import copy
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from fmc_uia_tpu.data import dataset as J
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data import dataset as P
from fmc_uia_tpu_torch.data.image_io import resize_bilinear_f32
from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset
from fmc_uia_tpu_torch.fit import fit
from fmc_uia_tpu_torch.ops import image as image_ops
from helpers import TINY_CONFIG

ADAPTIVE_SHARE = 0.005


def fan_frame(rng, h, w):
    """An ultrasound-like frame: a speckled fan on a dark, faintly noisy
    background, gray replicated to 3 channels."""
    yy, xx = np.mgrid[:h, :w]
    cy, cx = -0.1 * h, w / 2
    r = np.hypot(yy - cy, xx - cx)
    ang = np.arctan2(xx - cx, yy - cy)
    fan = ((r > 0.2 * h) & (r < 1.05 * h)
           & (np.abs(ang) < rng.uniform(0.5, 0.8)))
    img = rng.gamma(2.0, rng.uniform(20, 50), (h, w)) * fan
    img += rng.uniform(0, 8) * rng.rand(h, w)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.stack([img] * 3, -1)


def frames(n=12, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        h, w = rng.randint(40, 200), rng.randint(40, 260)
        out.append(fan_frame(rng, h, w) if k % 4 else
                   rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    # a frame with no pixel above 5: the 'auto' threshold stays at 10
    out.append(np.full((48, 64, 3), 3, np.uint8))
    return out


def test_otsu_matches_cv2():
    for img in frames():
        g = img[..., 0]
        ref, _ = cv2.threshold(g, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        assert P.otsu_threshold(g) == ref


@pytest.mark.parametrize("mode", ["auto", 20, 7.5, "adaptive"])
def test_valid_mask_matches_jax(mode):
    for img in frames():
        ref = J.detect_valid_mask(img, mode)
        got = P.detect_valid_mask(img, mode)
        assert got.dtype == bool and got.shape == ref.shape
        share = float((got != ref).mean())
        if mode == "adaptive":
            assert share <= ADAPTIVE_SHARE, share
        else:
            assert share == 0.0, (mode, share)


@pytest.mark.parametrize("mode", ["auto", "adaptive", 30])
def test_adaptive_normalize_matches_jax(mode, monkeypatch):
    for img in frames(6, seed=1):
        ref = J.adaptive_normalize(img, mode)
        got = P.adaptive_normalize(img, mode)
        assert got.dtype == np.float32
        same = (P.detect_valid_mask(img, mode)
                == J.detect_valid_mask(img, mode)).all()
        assert same or mode == "adaptive"
        if same:
            np.testing.assert_array_equal(got, ref)
        # every frame: the port's normalisation over JAX's own mask
        with monkeypatch.context() as m:
            m.setattr(P, "detect_valid_mask", J.detect_valid_mask)
            np.testing.assert_array_equal(P.adaptive_normalize(img, mode),
                                          ref)


def test_f32_resize_matches_cv2():
    rng = np.random.RandomState(3)
    for src, dst in (((180, 260), (96, 128)), ((576, 768), (64, 64)),
                     ((37, 53), (64, 64)), ((128, 128), (64, 64))):
        a = rng.randn(*src, 3).astype(np.float32)
        ref = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(resize_bilinear_f32(a, *dst), ref,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["auto", "adaptive", 12])
def test_dataset_items_match_jax(tmp_path, mode):
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, samples_per_task=3, seed=4)
    ref = J.MultiTaskDataset(root, image_size=64, use_adaptive_norm=True,
                             bg_threshold=mode)
    got = P.MultiTaskDataset(root, image_size=64, use_adaptive_norm=True,
                             bg_threshold=mode)
    for i in range(0, len(got), 5):
        a, b = ref[i], got[i]
        assert b["image"].dtype == np.float32
        np.testing.assert_allclose(b["image"], a["image"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(b["label"], a["label"])


def test_fit_with_adaptive_norm(tmp_path, monkeypatch):
    """As the JAX package's ``test_fit_with_adaptive_norm_input_prep``:
    f32 batches pass the identity input prep, K3 is not called, the losses
    are finite."""
    root = tmp_path / "data"
    generate_synthetic_dataset(str(root), samples_per_task=8, seed=1)
    d = copy.deepcopy(TINY_CONFIG)
    d["data"].update(root_path=str(root), batch_size=4, image_size=64,
                     use_adaptive_norm=True, force_grayscale=True,
                     bg_threshold="adaptive", fused_preprocess=True)
    d["data"]["augmentation"]["normalize"] = {"mean": [0, 0, 0],
                                              "std": [1, 1, 1]}
    d["model"]["encoder"] = {"name": "swin_micro", "window_size": 8}
    d["experiment"]["output_dir"] = str(tmp_path / "out")
    d["training"].update(num_epochs=1, steps_per_epoch=3)

    def no_k3(*a, **k):
        raise AssertionError("K3 called under adaptive normalisation")

    monkeypatch.setattr(image_ops, "fused_augment_normalize", no_k3)
    result = fit(config=Config(config_dict=d), device="cpu")
    assert np.isfinite(result["best_score"])
    hist = json.loads((Path(result["experiment_dir"])
                       / "training_history.json").read_text())
    for e in hist:
        for stats in e["train_losses"].values():
            assert np.isfinite(stats["mean"])
