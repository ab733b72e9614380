"""Metrics and the evaluation loop (port of ``fmc_uia_tpu/metrics.py``).

Accuracy + macro-F1 (classification), foreground Dice (segmentation), pixel MAE
(Regression, denormalized by the reference's fixed 224x224), corner IoU
(detection, CenterNet peak or grid argmax decode; a deep-supervision seg head
is scored on its main output). Each per-type eval function runs the model in
eval mode under ``torch.no_grad`` and returns small per-batch statistics on the
device; ``evaluate`` reads them all back at the end and aggregates per task as
the JAX package does. It returns a list of row dicts (``"Task ID"``, ``"Task
Name"``, metric columns) where the JAX package returns a DataFrame.
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.nn.utils import parametrize

from fmc_uia_tpu_torch.device import resolve_device
from fmc_uia_tpu_torch.models.layers import take
from fmc_uia_tpu_torch.ops.centernet import decode_detection
from fmc_uia_tpu_torch.ops.image import normalize_images
from fmc_uia_tpu_torch.parallel import comm
from fmc_uia_tpu_torch.parallel.activation import activation_mesh_scope
from fmc_uia_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    axis_group,
    check_mesh,
    shard_batch,
)
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    REGRESSION,
    SEGMENTATION,
    TaskRegistry,
)

MAE_DENORM_SIZE = (224, 224)  # the reference's default


def masked_argmax(logits: torch.Tensor, num_valid_classes) -> torch.Tensor:
    """Argmax over the first num_valid_classes logits (padding masked);
    ties go to the first maximum, as jnp.argmax."""
    C = logits.shape[-1]
    valid = torch.arange(C, device=logits.device) < num_valid_classes
    neg = torch.full((), float("-inf"), dtype=logits.dtype,
                     device=logits.device)
    return torch.argmax(torch.where(valid, logits, neg), dim=-1)


def dice_coefficient(labels: torch.Tensor, logits: torch.Tensor,
                     num_valid_classes=None,
                     sample_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Foreground Dice over the whole batch: one-hot both, drop class 0,
    one ratio over all foreground classes; ``sample_mask`` [B] zeroes
    padded samples."""
    C = logits.shape[-1]
    if num_valid_classes is not None:
        pred = masked_argmax(logits, num_valid_classes)
    else:
        pred = torch.argmax(logits, dim=-1)
    t = torch.nn.functional.one_hot(labels.long(), C).float()[..., 1:]
    p = torch.nn.functional.one_hot(pred, C).float()[..., 1:]
    if sample_mask is not None:
        m = sample_mask.float().reshape((-1,) + (1,) * (t.dim() - 1))
        t = t * m
        p = p * m
    inter = torch.sum(t * p)
    union = torch.sum(t) + torch.sum(p)
    return (2.0 * inter + 1e-6) / (union + 1e-6)


def mae_pixels(labels: torch.Tensor, preds: torch.Tensor,
               image_size=MAE_DENORM_SIZE, num_valid_cols=None,
               sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute error in pixels; ``num_valid_cols`` masks padded point
    columns, ``sample_mask`` [B] padded samples."""
    h, w = image_size
    D = labels.shape[-1]
    dev = labels.device
    cols = torch.arange(D, device=dev)
    scale = torch.where(cols % 2 == 0, torch.tensor(float(w), device=dev),
                        torch.tensor(float(h), device=dev))
    err = torch.abs(labels * scale - preds * scale)
    if num_valid_cols is None and sample_mask is None:
        return torch.mean(err)
    col_mask = torch.ones(D, device=dev)
    n_cols = torch.tensor(float(D), device=dev)
    if num_valid_cols is not None:
        nv = torch.as_tensor(num_valid_cols, device=dev)
        col_mask = (cols < nv).float()
        n_cols = torch.clamp_min(nv.float(), 1.0)
    row_mask = torch.ones(err.shape[0], device=dev)
    n_rows = torch.tensor(float(err.shape[0]), device=dev)
    if sample_mask is not None:
        row_mask = sample_mask.float()
        n_rows = torch.clamp_min(row_mask.sum(), 1.0)
    return torch.sum(err * col_mask * row_mask[:, None]) / (n_rows * n_cols)


def batch_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Per-sample corner IoU [B]."""
    xa = torch.maximum(boxes_a[:, 0], boxes_b[:, 0])
    ya = torch.maximum(boxes_a[:, 1], boxes_b[:, 1])
    xb = torch.minimum(boxes_a[:, 2], boxes_b[:, 2])
    yb = torch.minimum(boxes_a[:, 3], boxes_b[:, 3])
    inter = torch.clamp_min(xb - xa, 0.0) * torch.clamp_min(yb - ya, 0.0)
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    return inter / (area_a + area_b - inter + 1e-6)


def accuracy_score_host(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(y_true == y_pred))


def macro_f1_host(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn's ``f1_score(average="macro", zero_division=0)`` over the
    classes present in either array."""
    classes = np.unique(np.concatenate([y_true, y_pred]))
    f1s = []
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return float(np.mean(f1s))


# ---------------------------------------------------------------------------
# evaluation loop
# ---------------------------------------------------------------------------
def _gather_rows(out, group):
    """Every rank's rows of a model output (a tensor, tuple or dict)."""
    if isinstance(out, dict):
        return {k: _gather_rows(v, group) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_gather_rows(v, group) for v in out)
    return comm.all_gather_dim(out, 0, group)


def make_eval_steps(model, registry: TaskRegistry, mean, std, prep=None,
                    group=None):
    """One eval function per task type: prep (default: normalize to f32)
    -> forward in eval mode -> per-batch statistics on the device. With
    ``group`` each rank forwards its rows and the outputs are gathered
    over it, so the statistics are the whole batch's."""
    dev = next(model.parameters()).device
    nc_table = torch.as_tensor(registry.num_classes_table, dtype=torch.long,
                               device=dev)
    if prep is None:
        stats = (torch.as_tensor(mean, dtype=torch.float32, device=dev),
                 torch.as_tensor(std, dtype=torch.float32, device=dev))

        def prep(images):
            return normalize_images(images, *stats, dtype=torch.float32)

    def forward(images, task_type, task_index):
        out = model(prep(images), task_type, task_index, train=False)
        return out if group is None else _gather_rows(out, group)

    def seg_step(images, labels, task_index, valid):
        out = forward(images, SEGMENTATION, task_index)
        if isinstance(out, tuple):  # deep supervision: main only
            out = out[0]
        ncls = take(nc_table, task_index)
        return {"dice": dice_coefficient(labels, out, ncls,
                                         sample_mask=valid)}

    def cls_step(images, labels, task_index, valid):
        out = forward(images, CLASSIFICATION, task_index)
        ncls = take(nc_table, task_index)
        return {"preds": masked_argmax(out, ncls), "labels": labels}

    def det_step(images, labels, task_index, valid):
        boxes = decode_detection(forward(images, DETECTION, task_index))
        valid_gt = (labels >= 0).all(dim=1) & valid
        ious = batch_iou(labels, boxes)
        n_valid = valid_gt.float().sum()
        mean_iou = torch.where(valid_gt, ious, torch.zeros_like(ious)).sum() \
            / torch.clamp_min(n_valid, 1.0)
        return {"iou": mean_iou, "n_valid": n_valid, "boxes": boxes}

    def reg_step(images, labels, task_index, valid):
        out = forward(images, REGRESSION, task_index).float()
        ncls = take(nc_table, task_index)
        return {"mae": mae_pixels(labels, out, num_valid_cols=2 * ncls,
                                  sample_mask=valid),
                "preds": out}

    return {SEGMENTATION: seg_step, CLASSIFICATION: cls_step,
            DETECTION: det_step, REGRESSION: reg_step}


def _to_device(v, dev: torch.device) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
    if t.device == dev:
        return t
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


@torch.no_grad()
def evaluate(model, val_engine, registry: TaskRegistry, mean, std,
             prep=None, device="cuda", mesh=None) -> List[Dict]:
    """Validation loop -> one row per task: ``{"Task ID", "Task Name",
    metric: mean over the task's batches}``, tasks in sorted order.
    ``model`` must be on ``device``; it runs in eval mode (``train=False``:
    no drop path or dropout). Batches are
    dispatched first and their statistics read back in bulk at the end
    (with a wait every 32 batches, bounding the inputs in flight).

    Under ``mesh`` each rank forwards its rows of every batch (the
    engine's, or its slice of a whole batch) inside the mesh's scope; the
    outputs, labels and masks are gathered over the batch axes, so every
    rank's table is the single process's."""
    group = None
    if mesh is not None:
        check_mesh(mesh)
        group = axis_group(mesh, BATCH_AXES)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(activation_mesh_scope(mesh))
            stack.enter_context(parametrize.cached())
        return _evaluate(model, val_engine, registry, mean, std, prep,
                         device, mesh, group)


def _evaluate(model, val_engine, registry, mean, std, prep, device, mesh,
              group) -> List[Dict]:
    dev = resolve_device(device)
    p0 = next(model.parameters())
    if p0.device.type != dev.type:
        raise ValueError(f"model is on {p0.device}, evaluate on {dev}")
    dev = p0.device
    steps = make_eval_steps(model, registry, mean, std, prep=prep,
                            group=group)
    task_index = {}
    pending = []  # (tid, ttype, valid_np, device stats)
    for batch in val_engine:
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        images = _to_device(batch["image"], dev)
        labels = _to_device(batch["label"], dev)
        if labels.dtype == torch.uint8:  # wire-narrowed seg masks
            labels = labels.long()
        if group is not None:
            labels = comm.all_gather_dim(labels, 0, group)
        tid = batch["task_id"]
        if tid not in task_index:
            task_index[tid] = torch.tensor(int(batch["task_index"]),
                                           dtype=torch.long, device=dev)
        valid_np = np.asarray(batch.get(
            "valid", np.ones((images.shape[0],), bool)))
        if group is not None:
            valid_np = np.concatenate(comm.gather_objects(valid_np, group))
        stats = steps[batch["task_type"]](images, labels, task_index[tid],
                                          _to_device(valid_np, dev))
        pending.append((tid, batch["task_type"], valid_np, stats))
        if len(pending) % 32 == 0 and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    task_metrics: Dict[str, Dict[str, list]] = defaultdict(
        lambda: defaultdict(list))
    for tid, ttype, valid_np, stats in pending:
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        if ttype == CLASSIFICATION:
            y_pred = stats["preds"][valid_np]
            y_true = stats["labels"][valid_np]
            task_metrics[tid]["Accuracy"].append(
                accuracy_score_host(y_true, y_pred))
            task_metrics[tid]["F1-Score"].append(
                macro_f1_host(y_true, y_pred))
        elif ttype == SEGMENTATION:
            task_metrics[tid]["Dice"].append(float(stats["dice"]))
        elif ttype == REGRESSION:
            task_metrics[tid]["MAE (pixels)"].append(float(stats["mae"]))
        elif ttype == DETECTION:
            if float(stats["n_valid"]) > 0:
                task_metrics[tid]["IoU"].append(float(stats["iou"]))

    rows = []
    for tid in sorted(registry.task_ids):
        if tid not in task_metrics:
            continue
        row = {"Task ID": tid, "Task Name": registry[tid].task_name}
        for name, values in task_metrics[tid].items():
            row[name] = float(np.mean(values))
        rows.append(row)
    return rows


def average_validation_score(rows: List[Dict], mae_upper: float = 100.0,
                             mae_lower: float = 0.0) -> float:
    """Scalar model-selection score: cls (Acc+F1)/2, seg Dice, det IoU,
    Regression (100-MAE)/100 clipped to [0, 1]; the mean over tasks."""
    scores = []
    for row in rows:
        name = row["Task Name"]

        def val(key):
            v = row.get(key)
            return None if v is None or math.isnan(v) else float(v)

        if name == CLASSIFICATION:
            vals = [v for v in (val("Accuracy"), val("F1-Score"))
                    if v is not None]
            if vals:
                scores.append(float(np.mean(vals)))
        elif name in (SEGMENTATION, DETECTION):
            v = val("Dice" if name == SEGMENTATION else "IoU")
            if v is not None:
                scores.append(v)
        elif name == REGRESSION:
            v = val("MAE (pixels)")
            if v is not None:
                norm = (mae_upper - v) / (mae_upper - mae_lower)
                scores.append(float(np.clip(norm, 0.0, 1.0)))
    return float(np.mean(scores)) if scores else 0.0


def format_rows(rows: List[Dict]) -> str:
    """The rows as a text table (the JAX package prints its DataFrame)."""
    if not rows:
        return ""
    cols: List[str] = []
    for r in rows:
        cols += [k for k in r if k not in cols]
    cells = [[("" if r.get(c) is None else f"{r[c]:.6f}"
               if isinstance(r.get(c), float) else str(r[c])) for c in cols]
             for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells))
              for i, c in enumerate(cols)]
    lines = [" ".join(c.rjust(w) for c, w in zip(cols, widths))]
    lines += [" ".join(v.rjust(w) for v, w in zip(row, widths))
              for row in cells]
    return "\n".join(lines)
