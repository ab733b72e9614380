"""Bilinear grid sampling by gather (port of
``fmc_uia_tpu/ops/sampling.py``).

``F.grid_sample`` semantics with ``align_corners=False`` and zeros
outside the image, in the JAX package's arithmetic: f32 coordinates, four
clipped gathers (in the image's dtype), each masked where its corner lies
outside the image and weighted by f32 bilinear weights, so that a bf16
image gives an f32 result, as JAX's promotion does. The gathers are one
``index_select`` each over the flattened [B·H·W, C] image, whose backward
is an ``index_add_``; autograd carries grads to the image and to the
coordinates (through the weights; ``floor`` has a zero derivative).
"""

from __future__ import annotations

import torch


def grid_sample_bilinear(img: torch.Tensor, coords: torch.Tensor
                         ) -> torch.Tensor:
    """Sample NHWC ``img`` [B, H, W, C] at ``coords`` [B, ..., 2], (x, y)
    in [-1, 1] with pixel = ((coord + 1) * size - 1) / 2. Returns
    [B, ..., C], zero outside the image."""
    B, H, W, C = img.shape
    out_shape = coords.shape[:-1]
    coords = coords.reshape(B, -1, 2).float()  # [B, N, 2]
    x = ((coords[..., 0] + 1.0) * W - 1.0) / 2.0
    y = ((coords[..., 1] + 1.0) * H - 1.0) / 2.0

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    flat = img.reshape(B * H * W, C)
    base = (torch.arange(B, device=img.device) * (H * W))[:, None]

    def gather(ix, iy):
        inside = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        ixc = ix.clamp(0, W - 1).long()
        iyc = iy.clamp(0, H - 1).long()
        idx = (base + iyc * W + ixc).reshape(-1)  # [B * N]
        vals = flat.index_select(0, idx).reshape(B, -1, C)
        return torch.where(inside[..., None], vals, 0.0)

    out = (gather(x0, y0) * (wx0 * wy0)[..., None]
           + gather(x1, y0) * (wx1 * wy0)[..., None]
           + gather(x0, y1) * (wx0 * wy1)[..., None]
           + gather(x1, y1) * (wx1 * wy1)[..., None])
    return out.reshape(*out_shape, C)
