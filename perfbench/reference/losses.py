"""Losses of the train step (port of ``fmc_uia_tpu/losses.py``): Dice
(smp multiclass semantics), cross entropy, CenterNet focal + masked L1,
the grid detection loss (BCE on objectness + smooth-L1 on positive
boxes), MSE / L1 / SmoothL1 with masked columns, binary focal and GIoU
(exported, unused by the train step, as in the JAX package), and the
Kendall-style adaptive weighting.

Pure functions of (predictions, targets[, class/column counts]) returning
f32 scalars. Under a mesh (``parallel/comm.py`` ``batch_scope``) every
reduction that spans the batch is global: each numerator and denominator
is summed over the data ranks before the division (the backward passing
the gradient through), so every rank holds the single process's loss;
outside a scope the sums are the identity. Banked heads pad logits to the type's largest class count;
classes past a task's count are set to -1e30 before the softmax, and
regression columns past ``2 * points`` are left out of the mean.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F



# one process holds the whole batch: the port's batch reductions are plain
def global_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def global_count(n_local: int, rows_local: int) -> float:
    return float(n_local)

_NEG = -1e30


def _valid_classes(C: int, num_valid_classes, device) -> torch.Tensor:
    ids = torch.arange(C, device=device)
    if num_valid_classes is None:
        return torch.ones(C, dtype=torch.bool, device=device)
    return ids < torch.as_tensor(num_valid_classes, device=device)


def dice_loss_multiclass(logits: torch.Tensor, targets: torch.Tensor,
                         num_valid_classes=None, smooth: float = 0.0,
                         eps: float = 1e-7) -> torch.Tensor:
    """Soft Dice over (batch, pixels) per class, classes absent from the
    target contribute 0, mean over the valid classes. logits [B, H, W, C]
    NHWC, targets [B, H, W] int."""
    C = logits.shape[-1]
    valid = _valid_classes(C, num_valid_classes, logits.device)
    x = torch.where(valid, logits.float(), _NEG)
    probs = torch.softmax(x, dim=-1)
    onehot = F.one_hot(targets.long(), C).float()
    dims = (0, 1, 2)
    inter, card, count = global_sum(torch.stack([
        (probs * onehot).sum(dims), (probs + onehot).sum(dims),
        onehot.sum(dims)]))
    dice = (2.0 * inter + smooth) / torch.clamp(card + smooth, min=eps)
    loss = 1.0 - dice
    keep = (count > 0) & valid
    loss = torch.where(keep, loss, torch.zeros_like(loss))
    return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       num_valid_classes=None) -> torch.Tensor:
    """Mean cross entropy over all elements ([B, C] or [B, H, W, C]
    logits), padded classes set to -1e30 before the log-softmax."""
    C = logits.shape[-1]
    valid = _valid_classes(C, num_valid_classes, logits.device)
    logp = torch.log_softmax(torch.where(valid, logits.float(), _NEG), -1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return global_mean(nll)


def centernet_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                         alpha: float = 2.0, beta: float = 4.0
                         ) -> torch.Tensor:
    """CenterNet's modified focal loss, normalized by the positives (the
    negatives' sum alone when there are none)."""
    t = targets.float()
    pred = torch.clamp(torch.sigmoid(logits.float()), 1e-6, 1.0 - 1e-6)
    pos = (t == 1.0).float()
    neg = (t < 1.0).float()
    pos_loss = -torch.log(pred) * torch.pow(1.0 - pred, alpha) * pos
    neg_loss = (-torch.log(1.0 - pred) * torch.pow(pred, alpha)
                * torch.pow(1.0 - t, beta) * neg)
    num_pos, pos_sum, neg_sum = global_sum(torch.stack([
        pos.sum(), pos_loss.sum(), neg_loss.sum()]))
    total = pos_sum + neg_sum
    return torch.where(num_pos > 0, total / torch.clamp(num_pos, min=1.0),
                       neg_sum)


def centernet_loss(predictions: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor],
                   heatmap_alpha: float = 2.0, heatmap_gamma: float = 4.0,
                   size_weight: float = 1.0, offset_weight: float = 1.0
                   ) -> torch.Tensor:
    """Heatmap focal + masked L1 of size and offset (0 when no center)."""
    hm = centernet_focal_loss(predictions["heatmap"], targets["heatmap"],
                              alpha=heatmap_alpha, beta=heatmap_gamma)
    mask = targets["mask"].float()
    zero = torch.zeros((), device=mask.device)

    def l1_sum(key):
        p, t = predictions[key].float(), targets[key].float()
        return (p * mask - t * mask).abs().sum()

    msum, size_sum, offset_sum = global_sum(torch.stack([
        mask.sum(), l1_sum("size"), l1_sum("offset")]))
    denom = msum + 1e-6

    def masked_l1(total):
        return torch.where(msum > 0, total / denom, zero)

    return (hm + size_weight * masked_l1(size_sum)
            + offset_weight * masked_l1(offset_sum))


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0,
               reduction: str = "mean") -> torch.Tensor:
    """Binary focal loss on logits (kept for API parity; no step uses
    it)."""
    x, t = logits.float(), targets.float()
    bce = torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    loss = alpha * torch.pow(1.0 - torch.exp(-bce), gamma) * bce
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def giou_loss(preds: torch.Tensor, targets: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """Mean 1 - generalized IoU of corner boxes [..., 4]."""
    p = preds.float().reshape(-1, 4)
    t = targets.float().reshape(-1, 4)
    x1 = torch.maximum(p[:, 0], t[:, 0])
    y1 = torch.maximum(p[:, 1], t[:, 1])
    x2 = torch.minimum(p[:, 2], t[:, 2])
    y2 = torch.minimum(p[:, 3], t[:, 3])
    inter = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    area_p = (torch.clamp_min(p[:, 2] - p[:, 0], 0)
              * torch.clamp_min(p[:, 3] - p[:, 1], 0))
    area_t = (torch.clamp_min(t[:, 2] - t[:, 0], 0)
              * torch.clamp_min(t[:, 3] - t[:, 1], 0))
    union = area_p + area_t - inter + eps
    iou = inter / union
    xc1 = torch.minimum(p[:, 0], t[:, 0])
    yc1 = torch.minimum(p[:, 1], t[:, 1])
    xc2 = torch.maximum(p[:, 2], t[:, 2])
    yc2 = torch.maximum(p[:, 3], t[:, 3])
    area_c = (torch.clamp_min(xc2 - xc1, 0) * torch.clamp_min(yc2 - yc1, 0)
              + eps)
    return (1.0 - (iou - (area_c - union) / area_c)).mean()


def detection_grid_loss(predictions: torch.Tensor, targets: torch.Tensor,
                        classification_weight: float = 2.0,
                        box_regression_weight: float = 1.0
                        ) -> torch.Tensor:
    """The grid head's loss on [B, 5] = [box(4), objectness] rows:
    BCE-with-logits (mean) on objectness plus smooth-L1 over the boxes of
    the positive rows (target objectness > 0.5), 0 when there are
    none."""
    pb, po = predictions[:, :4].float(), predictions[:, 4].float()
    tb, to = targets[:, :4].float(), targets[:, 4].float()
    bce = (torch.clamp_min(po, 0.0) - po * to
           + torch.log1p(torch.exp(-po.abs())))
    pos = (to > 0.5).float()[:, None]
    cls = global_mean(bce)
    n_pos, box_sum = global_sum(torch.stack([
        pos.sum(), (smooth_l1(pb - tb) * pos).sum()]))
    n_pos = n_pos * 4.0
    box = torch.where(n_pos > 0, box_sum / torch.clamp_min(n_pos, 1.0),
                      torch.zeros((), device=pos.device))
    return classification_weight * cls + box_regression_weight * box


def _masked_col_mean(per: torch.Tensor, num_valid_cols) -> torch.Tensor:
    """Mean over the first ``num_valid_cols`` columns (all when None):
    sum over those / (rows * max(num_valid_cols, 1))."""
    if num_valid_cols is None:
        return global_mean(per)
    D = per.shape[-1]
    n = torch.as_tensor(num_valid_cols, device=per.device)
    mask = (torch.arange(D, device=per.device) < n).float()
    rows = global_count(per.shape[0], per.shape[0])
    return global_sum((per * mask).sum()) / (
        rows * torch.clamp(n.float(), min=1.0))


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             num_valid_cols=None) -> torch.Tensor:
    d = pred.float() - target.float()
    return _masked_col_mean(d * d, num_valid_cols)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            num_valid_cols=None) -> torch.Tensor:
    return _masked_col_mean((pred.float() - target.float()).abs(),
                            num_valid_cols)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   num_valid_cols=None) -> torch.Tensor:
    return _masked_col_mean(smooth_l1(pred.float() - target.float()),
                            num_valid_cols)


# ---------------------------------------------------------------------------
# adaptive uncertainty weighting (Kendall et al. 2018)
# ---------------------------------------------------------------------------
def stable_log_var(log_var: torch.Tensor) -> torch.Tensor:
    """Smooth bound to [-3, 3]."""
    return 3.0 * torch.tanh(log_var / 3.0)


def adaptive_weighted_loss(log_vars: Dict[str, torch.Tensor],
                           losses: Dict[str, torch.Tensor]):
    """total = sum_t 0.5 e^{-lv_t} L_t + 0.5 lv_t (lv bounded); returns
    (total, weighted, weights)."""
    total = None
    weighted, weights = {}, {}
    for name, loss in losses.items():
        loss = loss.float().mean()
        if name in log_vars:
            lv = stable_log_var(log_vars[name])
            precision = torch.exp(-lv)
            wl = 0.5 * precision * loss + 0.5 * lv
            weights[name] = 0.5 * precision
        else:
            wl = loss
            weights[name] = torch.ones((), device=loss.device)
        weighted[name] = wl
        total = wl if total is None else total + wl
    return total, weighted, weights


def adaptive_weights(log_vars: Dict[str, torch.Tensor]):
    """The weight 0.5 e^{-lv} each task type's loss gets."""
    return {t: 0.5 * torch.exp(-stable_log_var(v))
            for t, v in log_vars.items()}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def build_loss_fn(task_name: str, loss_config: Dict):
    """The loss of a task type, configured like the JAX package."""
    loss_type = str(loss_config.get("type", ""))
    if task_name == "segmentation":
        if loss_type == "CrossEntropyLoss":
            return cross_entropy_loss
        return dice_loss_multiclass
    if task_name == "classification":
        return cross_entropy_loss
    if task_name == "detection":
        if loss_type.lower() not in ("centernet", ""):
            cw = float(loss_config.get("classification_weight", 2.0))
            bw = float(loss_config.get("box_regression_weight", 1.0))

            def grid_loss(predictions, targets):
                return detection_grid_loss(predictions, targets,
                                           classification_weight=cw,
                                           box_regression_weight=bw)

            return grid_loss
        kw = dict(heatmap_alpha=float(loss_config.get("heatmap_alpha", 2.0)),
                  heatmap_gamma=float(loss_config.get("heatmap_gamma", 4.0)),
                  size_weight=float(loss_config.get("size_weight", 1.0)),
                  offset_weight=float(loss_config.get("offset_weight", 1.0)))

        def det_loss(predictions, targets):
            return centernet_loss(predictions, targets, **kw)

        return det_loss
    if task_name == "Regression":
        if loss_type == "L1Loss":
            return l1_loss
        if loss_type == "SmoothL1Loss":
            return smooth_l1_loss
        return mse_loss
    raise ValueError(f"Unknown task name: {task_name}")


def build_all_losses(config, task_registry):
    """(loss_fns by type, fixed loss weights or None, initial adaptive
    log-vars by type or None)."""
    types = task_registry.present_types()
    loss_cfgs = config.get("training.loss_configs", {}) or {}
    loss_fns = {t: build_loss_fn(t, loss_cfgs.get(t, {}) or {})
                for t in types}
    if config.get("training.adaptive_loss.enabled", False):
        per_task = config.get(
            "training.adaptive_loss.init_log_vars_per_task")
        if per_task:
            init = [float(per_task.get(t, 0.0)) for t in types]
        else:
            init = [float(config.get("training.adaptive_loss.init_log_vars",
                                     0.0))] * len(types)
        return loss_fns, None, dict(zip(types, init))
    weights = {k: float(v) for k, v in (
        config.get("training.loss_weights", {}) or {}).items()}
    return loss_fns, weights, None
