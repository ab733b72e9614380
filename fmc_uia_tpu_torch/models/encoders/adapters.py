"""Multi-scale adapters for plain-ViT backbones (port of
``fmc_uia_tpu/models/encoders/adapters.py``, the 'resize' adapter only).

``FourScaleAdapter``: per-scale 1x1 projection (no bias) + resize to
strides (4, 8, 16, 32): integer average pool down, bilinear up. The
'spm_interaction' adapter (``SpatialPyramidModule``,
``DeformableCrossAttention2D``, ``InteractionBlock``, ``ops/sampling.py``)
and the antialiased non-integer downsample are not ported yet; asking for
them raises and names their ROADMAP item.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from fmc_uia_tpu_torch.models.layers import Conv, resize_to

ITEM_ADAPTERS = ("ROADMAP.md, port queue item 'Other encoders': the "
                 "spm_interaction adapter and the antialiased resize")


def _resize_feature(feat: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Down: average pool (adaptive_avg_pool2d semantics for integer
    ratios, f32 sums); up: bilinear. NHWC."""
    B, H, W, C = feat.shape
    if (H, W) == (th, tw):
        return feat
    if H >= th and W >= tw:
        if H % th == 0 and W % tw == 0:
            kh, kw = H // th, W // tw
            pooled = feat.float().reshape(B, th, kh, tw, kw, C).mean((2, 4))
            return pooled.to(feat.dtype)
        raise NotImplementedError(
            f"a non-integer downsample {H}x{W} -> {th}x{tw} (jax.image."
            f"resize 'linear', antialiased) is not ported to "
            f"fmc_uia_tpu_torch yet ({ITEM_ADAPTERS})")
    return resize_to(feat, th, tw)


class FourScaleAdapter(nn.Module):
    """Project (when the widths differ) + resize four backbone features
    to strides (4, 8, 16, 32)."""

    STRIDES = (4, 8, 16, 32)

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.project = out_channels != in_channels
        if self.project:
            for i in range(len(self.STRIDES)):
                self.add_module(f"proj{i}", Conv(in_channels, out_channels,
                                                 1, use_bias=False,
                                                 dtype=dtype))

    def forward(self, features: List[torch.Tensor], input_hw
                ) -> List[torch.Tensor]:
        out = []
        for i, (feat, stride) in enumerate(zip(features, self.STRIDES)):
            if self.project:
                feat = getattr(self, f"proj{i}")(feat.to(self.dtype))
            th = max(1, input_hw[0] // stride)
            tw = max(1, input_hw[1] // stride)
            out.append(_resize_feature(feat, th, tw))
        return out
