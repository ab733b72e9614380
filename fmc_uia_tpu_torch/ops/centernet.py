"""CenterNet decode (port of ``fmc_uia_tpu/ops/centernet.py``
``decode_centernet``)."""

from __future__ import annotations

import torch


def decode_centernet(heatmap: torch.Tensor, size: torch.Tensor,
                     offset: torch.Tensor) -> torch.Tensor:
    """Single best box per image from NHWC CenterNet maps.

    heatmap [B, H, W, 1] logits, size/offset [B, H, W, 2] -> boxes [B, 4]
    normalized (x1, y1, x2, y2), clipped to [0, 1]. The peak is the first
    maximum in row-major order, as jnp.argmax.
    """
    B, H, W, _ = heatmap.shape
    best = torch.argmax(heatmap[..., 0].reshape(B, H * W), dim=1)
    best_h = torch.div(best, W, rounding_mode="floor")
    best_w = best % W
    bidx = torch.arange(B, device=heatmap.device)
    off = offset[bidx, best_h, best_w]
    sz = size[bidx, best_h, best_w]
    cx = (best_w.float() + off[:, 0]) / W
    cy = (best_h.float() + off[:, 1]) / H
    bw = sz[:, 0] / W
    bh = sz[:, 1] / H
    boxes = torch.stack(
        [cx - bw * 0.5, cy - bh * 0.5, cx + bw * 0.5, cy + bh * 0.5], dim=1)
    return torch.clamp(boxes, 0.0, 1.0)
