"""Multi-scale adapters for plain-ViT backbones (port of
``fmc_uia_tpu/models/encoders/adapters.py``).

* ``FourScaleAdapter`` ('resize'): per-scale 1x1 projection (no bias) +
  resize to strides (4, 8, 16, 32): integer average pool down, the
  antialiased linear resize of ``jax.image.resize`` for a non-integer
  downsample, bilinear up.
* ``SpatialPyramidModule`` ('spm_interaction'): a CNN pyramid from the
  raw image, a stride-2 stem then stages at strides 4/8/16/32.
* ``DeformableCrossAttention2D``: CNN-grid queries sample the ViT map at
  learned offsets, all heads x points in one bilinear gather
  (``ops/sampling.py``), a softmax over the points in f32.
* ``InteractionBlock``: pre-norm (f32 GroupNorm) cross-attention residual
  + a 3x3 conv FFN residual.

Activations are NHWC, as in the JAX package, so the offsets' channel
order (head, point, xy) is the JAX one. Submodule names follow the flax
tree (``stem0/Conv_0``, ``cross_attn/offset_proj``, ...) for the weight
bridge.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.layers import (
    Conv,
    ConvGNAct,
    GroupNorm,
    gn_groups,
    resize_to,
)
from fmc_uia_tpu_torch.ops.sampling import grid_sample_bilinear

SPM_RANGE = "spm_adapter"  # profiler range of the SPM-interaction adapter


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


class SpatialPyramidModule(nn.Module):
    """CNN pyramid from the raw image: stem (stride 2, twice
    ``ConvGNAct``) then stages ``s4``/``s8``/``s16``/``s32``, each a
    stride-2 ``ConvGNAct`` and a stride-1 one."""

    def __init__(self, out_channels: Sequence[int], stem_channels: int = 64,
                 in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        s = stem_channels
        self.stem0 = ConvGNAct(in_channels, s, stride=2, dtype=dtype)
        self.stem1 = ConvGNAct(s, s, dtype=dtype)
        cin = s
        for name, c in zip(("s4", "s8", "s16", "s32"), out_channels):
            self.add_module(f"{name}_0", ConvGNAct(cin, c, stride=2,
                                                   dtype=dtype))
            self.add_module(f"{name}_1", ConvGNAct(c, c, dtype=dtype))
            cin = c

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem1(self.stem0(x))
        out = []
        for name in ("s4", "s8", "s16", "s32"):
            x = getattr(self, f"{name}_1")(getattr(self, f"{name}_0")(x))
            out.append(x)
        return out


class DeformableCrossAttention2D(nn.Module):
    """CNN-grid query -> ViT-map key/value at learned sampling offsets:
    1x1 q/k/v projections (no bias), a 3x3 offset conv (bias) to
    nH·nP·(x, y) channels, tanh in f32 times ``offset_range`` around a
    [-1, 1] base grid; heads fold into the batch for one gather of k and
    one of v; logits q·k / sqrt(dh) and the softmax over points in f32;
    the weighted sum in f32, cast to the dtype, then ``out_proj``."""

    def __init__(self, channels: int, num_heads: int = 8,
                 num_points: int = 4, offset_range: float = 0.25,
                 dtype=torch.float32):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} not divisible by heads "
                             f"{num_heads}")
        C = channels
        self.num_heads, self.num_points = num_heads, num_points
        self.offset_range = float(offset_range)
        self.dtype = dtype
        self.q_proj = Conv(C, C, 1, use_bias=False, dtype=dtype)
        self.k_proj = Conv(C, C, 1, use_bias=False, dtype=dtype)
        self.v_proj = Conv(C, C, 1, use_bias=False, dtype=dtype)
        self.offset_proj = Conv(C, num_heads * num_points * 2, 3,
                                dtype=dtype)
        self.out_proj = Conv(C, C, 1, use_bias=False, dtype=dtype)
        self._grids = {}  # (H, W, device) -> the base grid on the device

    def base_grid(self, H: int, W: int, device) -> torch.Tensor:
        """[H, W, (x, y)] f32 in [-1, 1] from ``np.linspace`` in f32, as
        the JAX package makes it; copied to the device once per shape, so
        that a forward makes no host-to-device copy."""
        key = (H, W, str(device))
        if key not in self._grids:
            gy = np.linspace(-1.0, 1.0, H, dtype=np.float32)
            gx = np.linspace(-1.0, 1.0, W, dtype=np.float32)
            base = np.stack(np.meshgrid(gx, gy, indexing="xy"), axis=-1)
            with torch.inference_mode(False):  # as the Swin mask cache
                self._grids[key] = torch.from_numpy(base).to(device)
        return self._grids[key]

    def sample_coords(self, query_map: torch.Tensor) -> torch.Tensor:
        """The f32 sampling coordinates [B, H, W, nH, nP, (x, y)]."""
        B, H, W, _ = query_map.shape
        off = torch.tanh(self.offset_proj(query_map).float())
        off = (off * self.offset_range).reshape(
            B, H, W, self.num_heads, self.num_points, 2)
        base = self.base_grid(H, W, off.device)
        return base[None, :, :, None, None, :] + off

    def forward(self, query_map: torch.Tensor, kv_map: torch.Tensor
                ) -> torch.Tensor:
        B, H, W, C = query_map.shape
        Hk, Wk = kv_map.shape[1], kv_map.shape[2]
        nH, nP = self.num_heads, self.num_points
        dh = C // nH
        q = self.q_proj(query_map)
        k = self.k_proj(kv_map)
        v = self.v_proj(kv_map)
        coords = self.sample_coords(query_map)

        def heads(t, h, w):  # [B, h, w, C] -> [B * nH, h, w, dh]
            return t.reshape(B, h, w, nH, dh).permute(0, 3, 1, 2, 4).reshape(
                B * nH, h, w, dh)

        coords_h = coords.permute(0, 3, 1, 2, 4, 5).reshape(B * nH, H, W,
                                                            nP, 2)
        k_samp = grid_sample_bilinear(heads(k, Hk, Wk), coords_h)
        v_samp = grid_sample_bilinear(heads(v, Hk, Wk), coords_h)
        q_h = heads(q, H, W)[:, :, :, None, :]  # [B*nH, H, W, 1, dh]
        logits = (q_h.float() * k_samp.float()).sum(-1) / float(np.sqrt(dh))
        attn = torch.softmax(logits, dim=-1)  # [B*nH, H, W, nP]
        out = (attn[..., None] * v_samp.float()).sum(3)
        out = out.reshape(B, nH, H, W, dh).permute(0, 2, 3, 1, 4)
        return self.out_proj(out.reshape(B, H, W, C).to(self.dtype))


class InteractionBlock(nn.Module):
    """``x = cnn + cross_attn(norm1(cnn), vit)``; ``x + ffn1(silu(ffn0(
    norm2(x))))``; the norms are GroupNorm in f32, the FFN 3x3 convs
    without bias in the compute dtype."""

    def __init__(self, channels: int, num_heads: int = 8,
                 num_points: int = 4, offset_range: float = 0.25,
                 dtype=torch.float32):
        super().__init__()
        C = channels
        self.dtype = dtype
        self.norm1 = GroupNorm(C, gn_groups(C), dtype=torch.float32)
        self.norm2 = GroupNorm(C, gn_groups(C), dtype=torch.float32)
        self.cross_attn = DeformableCrossAttention2D(
            C, num_heads, num_points, offset_range, dtype=dtype)
        self.ffn0 = Conv(C, C, 3, use_bias=False, dtype=dtype)
        self.ffn1 = Conv(C, C, 3, use_bias=False, dtype=dtype)

    def forward(self, cnn_feat: torch.Tensor, vit_feat: torch.Tensor
                ) -> torch.Tensor:
        x = cnn_feat + self.cross_attn(
            self.norm1(cnn_feat).to(self.dtype), vit_feat)
        y = self.norm2(x).to(self.dtype)
        y = self.ffn1(F.silu(self.ffn0(y)))
        return x + y
