"""ResNet encoder (port of ``fmc_uia_tpu/models/encoders/resnet.py``).

Bottleneck-v1 with a 7x7 stem, NHWC, returning 4 pyramid features at
strides 4/8/16/32. GroupNorm replaces BatchNorm, as in the JAX package.

Dtype flow follows the JAX modules: every conv computes in ``dtype``,
every GroupNorm returns f32, so the residual stream and the four features
are f32 even under bf16 compute. The submodules keep flax's auto names
(``Conv_0``..``Conv_2``, ``GroupNorm_0``..``GroupNorm_3``; the projection
conv is ``proj``), so ``utils/convert.load_jax_params`` bridges the tree.
ReLUs go through ``F.relu`` (a grad check can record their inputs).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.layers import Conv, GroupNorm, gn_groups


def _gn(channels: int) -> GroupNorm:
    return GroupNorm(channels, gn_groups(channels), dtype=torch.float32)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x width), each conv followed by a
    GroupNorm; a projected shortcut where the width or stride changes."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        out_ch = features * 4
        self.Conv_0 = Conv(cin, features, 1, use_bias=False, dtype=dtype)
        self.GroupNorm_0 = _gn(features)
        self.Conv_1 = Conv(features, features, 3, stride=stride,
                           use_bias=False, dtype=dtype)
        self.GroupNorm_1 = _gn(features)
        self.Conv_2 = Conv(features, out_ch, 1, use_bias=False, dtype=dtype)
        self.GroupNorm_2 = _gn(out_ch)
        if cin != out_ch or stride != 1:
            self.proj = Conv(cin, out_ch, 1, stride=stride, use_bias=False,
                             dtype=dtype)
            self.GroupNorm_3 = _gn(out_ch)
        else:
            self.proj = None

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = F.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        residual = x if self.proj is None else self.GroupNorm_3(self.proj(x))
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """4-stage pyramid encoder; ``stage_sizes`` (3, 4, 6, 3) is ResNet-50."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, dtype=torch.float32):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.width = width
        self.dtype = dtype
        self.stem_conv = Conv(3, width, 7, stride=2, use_bias=False,
                              dtype=dtype)
        self.GroupNorm_0 = _gn(width)
        cin = width
        for i, n in enumerate(self.stage_sizes):
            stage_width = width * 2 ** i
            for j in range(n):
                self.add_module(f"stage{i}_block{j}", BottleneckBlock(
                    cin, stage_width, stride=2 if (j == 0 and i > 0) else 1,
                    dtype=dtype))
                cin = stage_width * 4

    @property
    def out_channels(self) -> Tuple[int, int, int, int]:
        return tuple(self.width * 4 * 2 ** i for i in range(4))

    def forward(self, x, train: bool = False,
                generator=None) -> List[torch.Tensor]:
        del train, generator  # GroupNorm: no train/eval difference
        x = F.relu(self.GroupNorm_0(self.stem_conv(x.to(self.dtype))))
        # flax max_pool with explicit (1, 1) padding: the pad is -inf
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        features = []
        for i, n in enumerate(self.stage_sizes):
            for j in range(n):
                x = getattr(self, f"stage{i}_block{j}")(x)
            features.append(x)
        return features


def resnet50(dtype=torch.float32) -> ResNetEncoder:
    return ResNetEncoder(stage_sizes=(3, 4, 6, 3), width=64, dtype=dtype)


def resnet18_like(dtype=torch.float32) -> ResNetEncoder:
    """Small bottleneck variant for tests (one block a stage, width 16)."""
    return ResNetEncoder(stage_sizes=(1, 1, 1, 1), width=16, dtype=dtype)
