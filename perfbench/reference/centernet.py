"""CenterNet target synthesis and decode (port of
``fmc_uia_tpu/ops/centernet.py``), closed-form on the device: one box per
image, so the clipped gaussian splat is the gaussian on the full H x W grid
masked to the radius window. Layout NHWC (heatmap [B, H, W, 1], size and
offset [B, H, W, 2])."""

from __future__ import annotations

from typing import Dict

import torch


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """Minimum gaussian radius keeping IoU >= min_overlap: the 3-case
    CornerNet quadratic, elementwise in f32 (r3 keeps the reference's
    ``(b3 + sq3) / 2``)."""
    h = height.float()
    w = width.float()
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2.0
    b2 = 2.0 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 16.0 * c2, min=0.0))) / 2.0
    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) / 2.0
    return torch.minimum(torch.minimum(r1, r2), r3)


def make_centernet_targets(boxes: torch.Tensor, feat_h: int, feat_w: int
                           ) -> Dict[str, torch.Tensor]:
    """CenterNet training targets of one-box-per-image batches.

    ``boxes`` [B, 4] normalized corners (x1, y1, x2, y2); any negative
    coordinate marks the sample invalid (sentinel [-1, -1, -1, -1]).
    Returns heatmap [B, H, W, 1], size [B, H, W, 2] (box size in feature
    cells), offset [B, H, W, 2] (sub-cell center fraction) and mask
    [B, H, W, 1]: center cell by truncation + clamp, radius
    ``floor(max(1, gaussian_radius))``, sigma ``(2r + 1) / 6``."""
    boxes = boxes.float()
    dev = boxes.device
    valid = (boxes >= 0.0).all(dim=1)
    x1, y1, x2, y2 = boxes.unbind(1)
    cx = (x1 + x2) * 0.5
    cy = (y1 + y2) * 0.5
    gw = torch.clamp(torch.floor(cx * feat_w).to(torch.int32), 0, feat_w - 1)
    gh = torch.clamp(torch.floor(cy * feat_h).to(torch.int32), 0, feat_h - 1)
    box_w = (x2 - x1) * feat_w
    box_h = (y2 - y1) * feat_h
    radius = torch.floor(torch.clamp(gaussian_radius(box_h, box_w),
                                     min=1.0)).to(torch.int32)

    ys = torch.arange(feat_h, dtype=torch.int32, device=dev).view(1, -1, 1)
    xs = torch.arange(feat_w, dtype=torch.int32, device=dev).view(1, 1, -1)
    ghb, gwb, rb = (t.view(-1, 1, 1) for t in (gh, gw, radius))
    sigma = (2.0 * radius.float() + 1.0) / 6.0
    sig2 = (2.0 * sigma * sigma).view(-1, 1, 1)
    d2 = ((xs - gwb).float() ** 2 + (ys - ghb).float() ** 2)
    gauss = torch.exp(-d2 / sig2)
    in_window = ((xs - gwb).abs() <= rb) & ((ys - ghb).abs() <= rb)
    vb = valid.view(-1, 1, 1)
    heatmap = torch.where(in_window & vb, gauss, torch.zeros((), device=dev))
    centerf = ((xs == gwb) & (ys == ghb) & vb).float()
    size = torch.stack([centerf * box_w.view(-1, 1, 1),
                        centerf * box_h.view(-1, 1, 1)], dim=-1)
    offset = torch.stack(
        [centerf * (cx * feat_w - gw.float()).view(-1, 1, 1),
         centerf * (cy * feat_h - gh.float()).view(-1, 1, 1)], dim=-1)
    return {"heatmap": heatmap[..., None], "size": size, "offset": offset,
            "mask": centerf[..., None]}


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


def decode_grid_detection(outputs: torch.Tensor) -> torch.Tensor:
    """Best box per image from a grid detection map [B, H, W, 4 + 1]
    (channels: the sigmoid box, then objectness): the 4 box channels at
    the objectness argmax, the first maximum in row-major order on ties,
    as jnp.argmax (``torch.argmax`` returns the first maximal index;
    tests/test_torch_offpath_heads.py holds it on a planted tie)."""
    B, H, W, _ = outputs.shape
    best = torch.argmax(outputs[..., 4].reshape(B, H * W), dim=1)
    bidx = torch.arange(B, device=outputs.device)
    return outputs[bidx, torch.div(best, W, rounding_mode="floor"),
                   best % W, :4]


def decode_detection(out) -> torch.Tensor:
    """Boxes [B, 4] f32 from a detection head's output: a CenterNet dict
    or a grid map, as the JAX package's eval and export decode them."""
    if isinstance(out, dict):
        return decode_centernet(out["heatmap"].float(), out["size"].float(),
                                out["offset"].float())
    return decode_grid_detection(out.float())
