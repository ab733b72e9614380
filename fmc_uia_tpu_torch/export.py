"""Batched inference over the 4 task types and the challenge-format export
(port of ``fmc_uia_tpu/export.py``).

``export_predictions`` writes the FMC_UIA output contract:

  segmentation   -> class-id mask PNG at the ORIGINAL image resolution
  classification -> predicted class id (JSON)
  detection      -> pixel-space corner box (JSON)
  Regression     -> pixel-space keypoint list (JSON)

Per-task JSON files land in ``<out_dir>/<task_id>.json``; masks in
``<out_dir>/masks/``. Images are decoded and resized by the port's own
``data/`` (no cv2, PIL or pandas).
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from fmc_uia_tpu_torch.data.dataset import _resize_image, read_index
from fmc_uia_tpu_torch.data.image_io import (
    read_image,
    resize_nearest,
    write_png,
)
from fmc_uia_tpu_torch.device import resolve_device
from fmc_uia_tpu_torch.metrics import masked_argmax
from fmc_uia_tpu_torch.models.layers import take
from fmc_uia_tpu_torch.ops.centernet import decode_detection
from fmc_uia_tpu_torch.ops.image import normalize_images
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    REGRESSION,
    SEGMENTATION,
    TaskRegistry,
)


class Predictor:
    """One forward + decode per task type, on ``device``.

    Outputs per image: seg a class-id mask [S, S], cls a class id, det a
    normalized corner box [4] (f32), reg 2P normalized coordinates (f32).
    """

    def __init__(self, model, registry: TaskRegistry, mean, std,
                 image_size: int, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.registry = registry
        self.image_size = image_size
        # on the device once: a per-call copy from host memory would
        # synchronize the stream and stall the serving dispatcher
        self.mean = torch.tensor([float(m) for m in mean],
                                 device=self.device)
        self.std = torch.tensor([float(s) for s in std], device=self.device)
        self.nc_table = torch.as_tensor(registry.num_classes_table,
                                        dtype=torch.long, device=self.device)
        # device-resident task indices: no host->device copy per batch
        self._task_index = {
            s.task_id: torch.tensor(s.global_index, dtype=torch.long,
                                    device=self.device) for s in registry}

    def _to_device(self, images_u8: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(images_u8, np.uint8))
        if self.device.type == "cuda":
            # pinned + async: the dispatcher does not wait on the stream
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def predict_device(self, images_u8: np.ndarray, task_id: str
                       ) -> torch.Tensor:
        """Run one batch; returns the decoded output still on the device
        (possibly in flight) — callers that overlap dispatch with readback
        (serving.py) bring it to the host themselves."""
        spec = self.registry[task_id]
        tidx = self._task_index[task_id]
        x = normalize_images(self._to_device(images_u8), self.mean,
                             self.std, dtype=torch.float32)
        out = self.model(x, spec.task_name, tidx)
        if isinstance(out, tuple):  # deep supervision: main only
            out = out[0]
        if spec.task_name in (SEGMENTATION, CLASSIFICATION):
            # int32 class ids, as jnp.argmax returns
            return masked_argmax(out, take(self.nc_table, tidx)).int()
        if spec.task_name == DETECTION:
            return decode_detection(out)
        assert spec.task_name == REGRESSION
        return out.float()

    def predict_images(self, images_u8: np.ndarray, task_id: str
                       ) -> np.ndarray:
        """images_u8: [B, S, S, 3] resized uint8 batch -> per-type output."""
        return self.predict_device(images_u8, task_id).cpu().numpy()


_IO_THREADS = 8


def _write_mask(path: str, mask: np.ndarray, h: int, w: int) -> None:
    """A class-id mask resized (nearest) to (h, w), as a PNG."""
    mask = mask.astype(np.uint8)
    if mask.shape[:2] != (h, w):
        mask = resize_nearest(mask, h, w)
    write_png(path, mask)


def _records(spec, preds: np.ndarray, names: List[str], sizes, mask_dir,
             pool) -> List[Dict]:
    """One batch's records, as the JAX package writes them; seg masks are
    written as PNGs at the original size on ``pool``'s threads."""
    out, masks = [], []
    for j, name in enumerate(names):
        oh, ow = sizes[j]
        if spec.task_name == SEGMENTATION:
            mask_name = os.path.splitext(name)[0] + "_mask.png"
            masks.append((os.path.join(mask_dir, mask_name), preds[j], oh,
                          ow))
            out.append({"image": name, "mask": mask_name})
        elif spec.task_name == CLASSIFICATION:
            out.append({"image": name, "class": int(preds[j])})
        elif spec.task_name == DETECTION:
            box = preds[j]
            out.append({"image": name,
                        "x_min": float(box[0] * ow),
                        "y_min": float(box[1] * oh),
                        "x_max": float(box[2] * ow),
                        "y_max": float(box[3] * oh)})
        else:  # Regression: the task's points of the padded 2*Pmax
            pts = preds[j][: spec.num_classes * 2]
            out.append({"image": name, "points": [
                [float(pts[2 * k] * ow), float(pts[2 * k + 1] * oh)]
                for k in range(spec.num_classes)]})
    list(pool.map(lambda job: _write_mask(*job), masks))
    return out


def _load_frame(path: str, image_size: int):
    """(original (h, w), resized uint8 image), or None if it does not
    decode."""
    img = read_image(path)
    if img is None:
        return None
    return img.shape[:2], _resize_image(img, image_size)


def export_predictions(model, data_root: str, out_dir: str,
                       registry: TaskRegistry, mean, std, image_size: int,
                       batch_size: int = 16, device="cuda"
                       ) -> Dict[str, str]:
    """Run inference over a challenge-layout dataset (``<data_root>/
    csv_files/*.csv``) and write the outputs; returns {task_id: JSON path}.

    Per task in sorted task-id order (tasks outside ``registry`` skipped),
    its rows in index order in chunks of ``batch_size``; an image that does
    not decode is skipped. A chunk's frames are decoded and resized, and its
    masks written, on ``_IO_THREADS`` threads (the JAX package does both
    one by one: zlib and the host helper release the GIL). The
    last chunk of a task runs at its own size (the JAX package pads it to
    ``batch_size`` so that jit does not recompile; each image's output
    does not depend on the others)."""
    predictor = Predictor(model, registry, mean, std, image_size,
                          device=device)
    csv_path = os.path.join(data_root, "csv_files")
    csv_files = sorted(glob.glob(os.path.join(csv_path, "*.csv")))
    if not csv_files:
        raise FileNotFoundError(f"No CSV files found in {csv_path}")
    by_task: Dict[str, List[Dict]] = defaultdict(list)
    for row in read_index(csv_files):
        by_task[row["task_id"]].append(row)
    os.makedirs(out_dir, exist_ok=True)
    mask_dir = os.path.join(out_dir, "masks")
    os.makedirs(mask_dir, exist_ok=True)

    outputs: Dict[str, str] = {}
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        for task_id, rows in sorted(by_task.items()):
            if task_id not in registry:
                continue
            spec = registry[task_id]
            records = []
            for s in range(0, len(rows), batch_size):
                chunk = rows[s:s + batch_size]
                frames = pool.map(lambda row: _load_frame(os.path.normpath(
                    os.path.join(csv_path, row["image_path"])), image_size),
                    chunk)
                kept = [(os.path.basename(str(row["image_path"])), fr)
                        for row, fr in zip(chunk, frames) if fr is not None]
                if not kept:
                    continue
                preds = predictor.predict_images(
                    np.stack([fr[1] for _, fr in kept]), task_id)
                records += _records(spec, preds, [n for n, _ in kept],
                                    [fr[0] for _, fr in kept], mask_dir,
                                    pool)
            out_path = os.path.join(out_dir, f"{task_id}.json")
            with open(out_path, "w") as f:
                json.dump(records, f, indent=1)
            outputs[task_id] = out_path
    return outputs
