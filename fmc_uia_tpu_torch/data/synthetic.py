"""Synthetic dataset generator (port of ``fmc_uia_tpu/data/synthetic.py``).

Writes a dataset in the FMC_UIA challenge layout: ``<root>/csv_files/
<task>.csv`` with image (and mask) paths relative to it, covering the 4
task types. Images are a bright ellipse on gamma speckle, so masks, boxes
and points agree with the pixels. The ``np.random.RandomState`` calls are
those of the JAX generator in the same order, so one seed gives the same
pixels, masks, boxes and points; PNGs are written by ``image_io`` and
CSVs by ``csv`` (no cv2, PIL or pandas).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fmc_uia_tpu_torch.data.image_io import write_png


def _speckle_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    base = rng.gamma(2.0, 30.0, (h, w)).clip(0, 255)
    return base.astype(np.uint8)


def _ellipse_params(rng: np.random.RandomState, h: int, w: int):
    cy = rng.uniform(0.3, 0.7) * h
    cx = rng.uniform(0.3, 0.7) * w
    ry = rng.uniform(0.1, 0.25) * h
    rx = rng.uniform(0.1, 0.25) * w
    return cy, cx, ry, rx


def _ellipse_mask(h, w, cy, cx, ry, rx) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0)


DEFAULT_TASKS = [
    {"task_id": "T2A_syn_organ", "task_name": "segmentation", "num_classes": 2},
    {"task_id": "T2B_syn_lesion", "task_name": "segmentation", "num_classes": 2},
    {"task_id": "T1_syn_planes", "task_name": "classification", "num_classes": 3},
    {"task_id": "T3_syn_nodule", "task_name": "classification", "num_classes": 2},
    {"task_id": "T4_syn_box", "task_name": "detection", "num_classes": 1},
    {"task_id": "T5_syn_points", "task_name": "Regression", "num_classes": 4},
]


def _write_csv(path: str, rows: List[Dict]) -> None:
    """The rows under the union of their keys in first-seen order, as
    ``pd.DataFrame(rows).to_csv(index=False)`` writes them."""
    fields: List[str] = []
    for row in rows:
        fields += [k for k in row if k not in fields]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def generate_synthetic_dataset(
    root: str,
    tasks: Optional[Sequence[Dict]] = None,
    samples_per_task: int = 16,
    image_hw: tuple = (96, 112),  # non-square: exercises resize paths
    seed: int = 0,
) -> List[Dict]:
    """Create the dataset under ``root``; returns the task configs."""
    tasks = list(tasks if tasks is not None else DEFAULT_TASKS)
    rng = np.random.RandomState(seed)
    csv_dir = os.path.join(root, "csv_files")
    img_dir = os.path.join(root, "images")
    os.makedirs(csv_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    h, w = image_hw

    for task in tasks:
        rows = []
        tid, tname, ncls = (task["task_id"], task["task_name"],
                            task["num_classes"])
        for i in range(samples_per_task):
            img = _speckle_image(rng, h, w)
            cy, cx, ry, rx = _ellipse_params(rng, h, w)
            blob = _ellipse_mask(h, w, cy, cx, ry, rx)
            cls_label = int(rng.randint(0, ncls)) if tname == "classification" else 0
            brightness = 80 + 40 * cls_label
            img = img.astype(np.int32)
            img[blob] = np.clip(img[blob] + brightness, 0, 255)
            img = np.stack([img] * 3, axis=-1).astype(np.uint8)

            img_name = f"{tid}_{i:04d}.png"
            write_png(os.path.join(img_dir, img_name), img)
            row = {
                "image_path": os.path.join("..", "images", img_name),
                "task_id": tid,
                "task_name": tname,
                "num_classes": ncls,
            }

            if tname == "segmentation":
                mask_name = f"{tid}_{i:04d}_mask.png"
                write_png(os.path.join(img_dir, mask_name),
                          blob.astype(np.uint8))
                row["mask_path"] = os.path.join("..", "images", mask_name)
            elif tname == "classification":
                row["mask"] = cls_label
            elif tname == "detection":
                ys, xs = np.where(blob)
                row.update({
                    "x_min": float(xs.min()), "y_min": float(ys.min()),
                    "x_max": float(xs.max() + 1), "y_max": float(ys.max() + 1),
                })
            elif tname == "Regression":
                pts = [
                    (cx, cy - ry), (cx + rx, cy), (cx, cy + ry), (cx - rx, cy)
                ][:ncls]
                for j, (px, py) in enumerate(pts, start=1):
                    row[f"point_{j}_xy"] = json.dumps(
                        [round(float(px), 2), round(float(py), 2)])
            rows.append(row)
        _write_csv(os.path.join(csv_dir, f"{tid}.csv"), rows)
    return tasks
