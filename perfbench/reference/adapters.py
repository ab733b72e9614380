"""The 'resize' multi-scale adapter of plain-ViT backbones: a frozen copy
of the port's ``models/encoders/adapters.py`` (``FourScaleAdapter`` and
its resizes; the SPM-interaction adapter is not in the reference).

``FourScaleAdapter`` ('resize'): per-scale 1x1 projection (no bias) +
resize to strides (4, 8, 16, 32): integer average pool down, the
antialiased linear resize of ``jax.image.resize`` for a non-integer
downsample, bilinear up. Activations are NHWC.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, resize_to



def antialias_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] f32 weights of ``jax.image.resize(method='linear')``
    along one axis, as ``jax._src.image.scale.compute_weight_mat`` makes
    them (scale n_out/n_in, no translation, antialias on): a triangle
    kernel widened by 1/scale when shrinking, each output's weights
    normalised to sum 1, zero where the sample lies outside the input."""
    # JAX takes 1 / scale in f64 and rounds it to f32 where it meets f32;
    # the kernel scale divides as a tensor (a divide by a Python scalar
    # may run as a multiply by its reciprocal), made on the device by a
    # fill, with no copy from the host
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    f32 = dict(dtype=torch.float32, device=device)
    kernel_scale = torch.full((), max(inv_scale, 1.0), **f32)
    sample_f = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, **f32)[:, None]).abs()
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = weights.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_linear_antialias(feat: torch.Tensor, th: int, tw: int
                            ) -> torch.Tensor:
    """``jax.image.resize(feat, (B, th, tw, C), 'linear')`` of NHWC
    ``feat`` on a shrink: the weights rounded to feat's dtype (JAX casts
    them to the image's), the two contractions in f32, one rounding to
    the dtype at the end. An axis whose size stays is left alone."""
    B, H, W, C = feat.shape
    y = feat.float()
    if H != th:
        wh = antialias_weights(H, th, feat.device).to(feat.dtype).float()
        y = torch.einsum("bhwc,hi->biwc", y, wh)
    if W != tw:
        ww = antialias_weights(W, tw, feat.device).to(feat.dtype).float()
        y = torch.einsum("bhwc,wj->bhjc", y, ww)
    return y.to(feat.dtype)


def _resize_feature(feat: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Down: average pool (adaptive_avg_pool2d semantics for integer
    ratios, f32 sums), else the antialiased linear resize; up: bilinear.
    NHWC."""
    B, H, W, C = feat.shape
    if (H, W) == (th, tw):
        return feat
    if H >= th and W >= tw:
        if H % th == 0 and W % tw == 0:
            kh, kw = H // th, W // tw
            pooled = feat.float().reshape(B, th, kh, tw, kw, C).mean((2, 4))
            return pooled.to(feat.dtype)
        return resize_linear_antialias(feat, th, tw)
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
