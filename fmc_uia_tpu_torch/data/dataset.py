"""Multi-task dataset: CSV index + host-side decode/resize (port of
``fmc_uia_tpu/data/dataset.py``).

Same on-disk contract: ``<root>/csv_files/*.csv`` read in sorted order
into one index; per row ``image_path`` (relative to the csv_files dir),
``task_id``, ``task_name``, ``num_classes`` and the task's label columns —
``mask_path`` (seg), ``mask`` (cls class id), ``point_{i}_xy`` JSON
(Regression), ``x_min..y_max`` (det). The host decodes and resizes to the
static training size (image bilinear, mask nearest, boxes scaled and
clipped, points normalized by the ORIGINAL size); photometric augmentation
and normalization run on the device.

The index is read with ``csv`` as pandas reads it (``pd.read_csv`` per file,
``pd.concat``): a column whose cells all parse as integers holds ints, one
whose cells all parse as numbers holds floats, any other holds strings; an
empty cell, pandas' NA strings and an absent column are missing
(``pd.notna`` false). Images and masks are decoded by ``image_io`` (no cv2,
PIL or pandas).

``data.use_adaptive_norm`` standardises each frame on the host over its
valid (non-background) region, as the JAX package does with cv2; here in
numpy (``detect_valid_mask``, ``adaptive_normalize``), to cv2's numbers:
Otsu's threshold as ``THRESH_OTSU`` picks it, the 5x5 ellipse, closing and
opening with a border that neither dilates nor erodes, and the Gaussian
adaptive threshold with its mean rounded to uint8. The frames are then
f32, resized as cv2 resizes float images.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fmc_uia_tpu_torch.data.image_io import (
    Undecodable,
    read_image,
    read_mask,
    resize_bilinear,
    resize_bilinear_f32,
    resize_nearest,
    to_grayscale_3ch,
)

INVALID_BOX = np.array([-1.0, -1.0, -1.0, -1.0], dtype=np.float32)
# pandas' default NA strings (pd.read_csv na_values)
_NA = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def _parse_column(cells: Sequence[Optional[str]]) -> List:
    """One CSV column as pandas types it: NA strings -> None; then int if
    every present cell is an integer, float if every one is a number, else
    the strings."""
    cells = [None if c is None or c in _NA else c for c in cells]
    present = [c for c in cells if c is not None]
    for conv in (int, float):
        try:
            parsed = iter([conv(c) for c in present])
        except ValueError:
            continue
        return [None if c is None else next(parsed) for c in cells]
    return cells


def read_index(csv_files: Sequence[str]) -> List[Dict]:
    """The rows of the CSV files, in file order then row order; each row a
    dict of its file's columns, a missing cell None."""
    rows: List[Dict] = []
    for path in csv_files:
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv.DictReader(f)
            raw = list(reader)
            fields = reader.fieldnames or []
        cols = {k: _parse_column([r.get(k) for r in raw]) for k in fields}
        rows += [{k: cols[k][i] for k in fields} for i in range(len(raw))]
    return rows


def _resize_image(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] == size and img.shape[1] == size:
        return img
    if img.dtype == np.float32:
        return resize_bilinear_f32(img, size, size)
    return resize_bilinear(img, size, size)


# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
_ELLIPSE_5 = np.array([[0, 0, 1, 0, 0],
                       [1, 1, 1, 1, 1],
                       [1, 1, 1, 1, 1],
                       [1, 1, 1, 1, 1],
                       [0, 0, 1, 0, 0]], bool)
_ADAPTIVE_BLOCK = 51  # cv2.adaptiveThreshold(..., GAUSSIAN_C, 51, -10)
_ADAPTIVE_C = 10


def otsu_threshold(gray: np.ndarray) -> float:
    """cv2's ``THRESH_OTSU`` threshold of a uint8 image: the first level
    of largest between-class variance, in cv2's order of f64 operations
    (``getThreshVal_Otsu_8u``)."""
    hist = np.bincount(gray.ravel(), minlength=256).tolist()
    scale = 1.0 / gray.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = max_sigma = 0.0
    max_val = 0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, i
    return float(max_val)


def _gaussian_mean_u8(gray: np.ndarray) -> np.ndarray:
    """The mean of cv2's Gaussian adaptive threshold: the 51-tap Gaussian
    (sigma 0.3 * ((51 - 1) * 0.5 - 1) + 0.8 = 8) over the f32 image with a
    replicated border, rows then columns, rounded to uint8."""
    r = _ADAPTIVE_BLOCK // 2
    sigma = 0.3 * ((_ADAPTIVE_BLOCK - 1) * 0.5 - 1) + 0.8
    x = np.arange(_ADAPTIVE_BLOCK) - r
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    k = (k / k.sum()).astype(np.float32)
    pad = np.pad(gray.astype(np.float32), r, mode="edge")
    view = np.lib.stride_tricks.sliding_window_view
    rows = view(pad, _ADAPTIVE_BLOCK, axis=1) @ k
    blur = view(rows, _ADAPTIVE_BLOCK, axis=0) @ k
    return np.clip(np.rint(blur), 0, 255).astype(np.uint8)


def _morph(mask: np.ndarray, dilate: bool) -> np.ndarray:
    """cv2 dilate / erode of a bool mask by the 5x5 ellipse; the border is
    neutral (absent for a dilation, set for an erosion), as the default
    border of ``cv2.morphologyEx``."""
    H, W = mask.shape
    pad = np.pad(mask, 2, constant_values=not dilate)
    out = None
    for dy, dx in zip(*np.nonzero(_ELLIPSE_5)):
        win = pad[dy:dy + H, dx:dx + W]
        if out is None:
            out = win.copy()
        elif dilate:
            out |= win
        else:
            out &= win
    return out


def detect_valid_mask(image: np.ndarray, bg_threshold="auto") -> np.ndarray:
    """The valid (non-background) region of an ultrasound frame, as the
    JAX package's cv2 branch finds it: a threshold (``'auto'``: Otsu's
    level x 0.5, at least 10; ``'adaptive'``: above the Gaussian local
    mean by more than 10; a number: above it), then closing and opening by
    the 5x5 ellipse; under 10 % coverage, ``gray > 5``."""
    gray = image[:, :, 0]
    if gray.dtype != np.uint8:
        gray = (np.clip(gray, 0, 1) * 255).astype(np.uint8)
    if bg_threshold == "auto":
        threshold = 10
        if (gray > 5).sum() > 0:
            threshold = max(otsu_threshold(gray) * 0.5, 10)
        mask = gray > threshold
    elif bg_threshold == "adaptive":
        mask = (gray.astype(np.int16) - _gaussian_mean_u8(gray)
                > _ADAPTIVE_C)
    else:
        mask = gray > float(bg_threshold)
    mask = _morph(_morph(mask, dilate=True), dilate=False)   # close
    mask = _morph(_morph(mask, dilate=False), dilate=True)   # open
    if mask.sum() < mask.size * 0.1:
        mask = gray > 5
    return mask.astype(bool)


def adaptive_normalize(image: np.ndarray, bg_threshold="auto"
                       ) -> np.ndarray:
    """f32 [H, W, C] of ``image``/255 standardised per channel over the
    valid region (f32 mean and std; a std below 1e-6 counts as 1); the
    background keeps ``image``/255."""
    valid = detect_valid_mask(image, bg_threshold)
    out = image.astype(np.float32) / 255.0
    if valid.sum() > 0:
        for c in range(out.shape[2]):
            pixels = out[:, :, c][valid]
            mean = pixels.mean()
            std = pixels.std()
            if std < 1e-6:
                std = 1.0
            out[:, :, c][valid] = (pixels - mean) / std
    return out


def _resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    if mask.shape[0] == size and mask.shape[1] == size:
        return mask
    return resize_nearest(mask, size, size)


class MultiTaskDataset:
    """Index of all task CSVs with per-item load/resize.

    Args:
      data_root: directory containing ``csv_files/``.
      image_size: static square resolution all samples are resized to.
      max_reg_points: pad regression labels to this many points (per-type
        head-bank padding); defaults to the max seen in the index.
      force_grayscale: luma replicated to 3 channels.
      use_adaptive_norm: gray frames standardised over their valid region
        (``adaptive_normalize``), f32.
      bg_threshold: the valid region's threshold (``detect_valid_mask``).
      cache_samples: keep decoded + resized samples in host RAM (every
        step of an item is deterministic, so the sample is a pure function
        of its row).
    """

    def __init__(self, data_root: str, image_size: int = 224,
                 max_reg_points: Optional[int] = None,
                 force_grayscale: bool = False,
                 use_adaptive_norm: bool = False,
                 bg_threshold="auto",
                 cache_samples: bool = False):
        self.data_root = data_root
        self.image_size = int(image_size)
        self.force_grayscale = bool(force_grayscale)
        self.use_adaptive_norm = bool(use_adaptive_norm)
        self.bg_threshold = bg_threshold
        self.cache_samples = bool(cache_samples)
        self._sample_cache: Dict[int, Dict] = {}
        self.csv_path = os.path.join(data_root, "csv_files")
        if not os.path.isdir(self.csv_path):
            raise FileNotFoundError(f"CSV path not found: {self.csv_path}")
        csv_files = sorted(glob.glob(os.path.join(self.csv_path, "*.csv")))
        if not csv_files:
            raise FileNotFoundError(f"No CSV files found in {self.csv_path}")
        self.rows = read_index(csv_files)

        reg = [r["num_classes"] for r in self.rows
               if r.get("task_name") == "Regression"]
        if max_reg_points is not None:
            self.max_reg_points = int(max_reg_points)
        elif reg:
            self.max_reg_points = int(max(reg))
        else:
            self.max_reg_points = 0

    def __len__(self) -> int:
        return len(self.rows)

    def derive_task_configs(self) -> List[Dict]:
        """First-seen-order task configs from the index."""
        configs, seen = [], set()
        for row in self.rows:
            tid = row["task_id"]
            if tid in seen:
                continue
            seen.add(tid)
            configs.append({"task_id": tid, "task_name": row["task_name"],
                            "num_classes": int(row["num_classes"])})
        return configs

    def __getitem__(self, idx: int) -> Dict:
        if self.cache_samples:
            hit = self._sample_cache.get(idx)
            if hit is not None:
                return hit
        out = self._load_item(idx)
        if self.cache_samples:
            self._sample_cache[idx] = out
        return out

    def _load_item(self, idx: int) -> Dict:
        record = self.rows[idx]
        task_id = record["task_id"]
        task_name = record["task_name"]
        S = self.image_size

        image = read_image(os.path.normpath(
            os.path.join(self.csv_path, record["image_path"])))
        if image is None:
            # skip-corrupt-image retry (the neighbour's sample, stamped
            # with its own source_index)
            return self[(idx + 1) % len(self)]
        if self.force_grayscale or self.use_adaptive_norm:
            image = to_grayscale_3ch(image)
        if self.use_adaptive_norm:
            image = adaptive_normalize(image, self.bg_threshold)
        orig_h, orig_w = image.shape[:2]
        image = _resize_image(image, S)

        if task_name == "segmentation":
            mask = None
            if record.get("mask_path") is not None:
                try:
                    mask = read_mask(os.path.normpath(os.path.join(
                        self.csv_path, record["mask_path"])))
                except Undecodable:
                    # an interlaced mask no installed decoder reads: the
                    # corrupt-image retry, not an all-background label
                    return self[(idx + 1) % len(self)]
            if mask is None:
                label = np.zeros((S, S), np.int32)
            else:
                label = _resize_mask(mask, S).astype(np.int32)

        elif task_name == "classification":
            # class id in the 'mask' column; absent at inference -> -1
            raw = record.get("mask")
            label = np.int32(raw) if raw is not None else np.int32(-1)

        elif task_name == "Regression":
            num_points = int(record["num_classes"])
            coords = []
            for i in range(1, num_points + 1):
                value = record.get(f"point_{i}_xy")
                if value is not None:
                    coords.extend(json.loads(value))
                else:
                    coords.extend([0, 0])
            pts = np.asarray(coords, np.float32)
            pts[0::2] /= orig_w  # normalized by the ORIGINAL size
            pts[1::2] /= orig_h
            label = np.zeros((self.max_reg_points * 2,), np.float32)
            label[: pts.shape[0]] = pts

        elif task_name == "detection":
            cols = ["x_min", "y_min", "x_max", "y_max"]
            if all(record.get(c) is not None for c in cols):
                box = np.asarray([float(record[c]) for c in cols], np.float32)
                # scale to the resized frame, clip, normalize by its size
                box[[0, 2]] *= S / orig_w
                box[[1, 3]] *= S / orig_h
                box = np.clip(box, 0.0, S)
                if box[2] <= box[0] or box[3] <= box[1]:
                    label = INVALID_BOX.copy()
                else:
                    label = box / S
            else:
                label = INVALID_BOX.copy()
        else:
            raise ValueError(f"Unknown task_name: {task_name}")

        return {"image": image, "label": label, "task_id": task_id,
                "source_index": idx}
