"""EfficientNet encoder (port of
``fmc_uia_tpu/models/encoders/efficientnet.py``): MBConv blocks with
squeeze-excite, GroupNorm in place of BatchNorm, SiLU, compound
width/depth scaling of the b0-b7 family. NHWC, f32 params, convs compute
in ``dtype``.

Pyramid contract: features at strides 4/8/16/32 are the outputs of block
groups 2, 3, 5 and 7 (0-based 1, 2, 4, 6). Every GroupNorm returns f32,
so the features are f32 under bf16 compute too; the squeeze-excite gate's
sigmoid runs in f32 and is cast to its input's dtype, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.layers import Conv, GroupNorm, gn_groups

# (expand_ratio, kernel, stride, base_channels, base_repeats) per group — B0
_B0_GROUPS = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)
_B0_STEM = 32
_TAPS = (1, 2, 4, 6)

# (width_coefficient, depth_coefficient) per variant
_COEFFS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
    "b3": (1.2, 1.4), "b4": (1.4, 1.8), "b5": (1.6, 2.2),
    "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}


def round_filters(channels: float, width: float, divisor: int = 8) -> int:
    """EfficientNet width scaling with the divisor-8 snap rule."""
    channels *= width
    new_c = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * channels:
        new_c += divisor
    return int(new_c)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def _gn(channels: int) -> GroupNorm:
    return GroupNorm(channels, gn_groups(channels), dtype=torch.float32)


class SqueezeExcite(nn.Module):
    """Global average -> 1x1 reduce (bias) -> SiLU -> 1x1 expand (bias)
    -> f32 sigmoid gate, cast to the input's dtype."""

    def __init__(self, channels: int, reduced: int, dtype=torch.float32):
        super().__init__()
        self.reduce = Conv(channels, reduced, 1, dtype=dtype)
        self.expand = Conv(reduced, channels, 1, dtype=dtype)

    def forward(self, x):
        s = x.mean((1, 2), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s.float()).to(x.dtype)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int,
                 kernel: int, stride: int, se_reduced: int,
                 dtype=torch.float32):
        super().__init__()
        mid = in_ch * expand_ratio
        self.residual = stride == 1 and in_ch == out_ch
        if expand_ratio != 1:
            self.expand_conv = Conv(in_ch, mid, 1, use_bias=False,
                                    dtype=dtype)
            self.expand_gn = _gn(mid)
        else:
            self.expand_conv = None
        self.dw_conv = Conv(mid, mid, kernel, stride=stride, use_bias=False,
                            groups=mid, dtype=dtype)
        self.dw_gn = _gn(mid)
        self.se = SqueezeExcite(mid, se_reduced, dtype=dtype)
        self.project_conv = Conv(mid, out_ch, 1, use_bias=False, dtype=dtype)
        self.project_gn = _gn(out_ch)

    def forward(self, x):
        y = x
        if self.expand_conv is not None:
            y = F.silu(self.expand_gn(self.expand_conv(y)))
        y = F.silu(self.dw_gn(self.dw_conv(y)))
        y = self.project_gn(self.project_conv(self.se(y)))
        return y + x if self.residual else y


class EfficientNetEncoder(nn.Module):
    """Compound-scaled MBConv pyramid encoder (strides 4/8/16/32)."""

    def __init__(self, width: float = 1.0, depth: float = 1.0,
                 dtype=torch.float32):
        super().__init__()
        self.width, self.depth = width, depth
        self.dtype = dtype
        stem = round_filters(_B0_STEM, width)
        self.stem_conv = Conv(3, stem, 3, stride=2, use_bias=False,
                              dtype=dtype)
        self.stem_gn = _gn(stem)
        self.blocks = []
        in_ch = stem
        for gi, (expand, kernel, stride, base_c, base_r) in enumerate(
                _B0_GROUPS):
            out_ch = round_filters(base_c, width)
            for b in range(round_repeats(base_r, depth)):
                name = f"group{gi}_block{b}"
                self.add_module(name, MBConv(
                    in_ch, out_ch, expand, kernel,
                    stride if b == 0 else 1, max(1, int(in_ch * 0.25)),
                    dtype=dtype))
                self.blocks.append((gi, name))
                in_ch = out_ch

    def _group_channels(self) -> Tuple[int, ...]:
        return tuple(round_filters(c, self.width)
                     for (_, _, _, c, _) in _B0_GROUPS)

    @property
    def out_channels(self) -> Tuple[int, int, int, int]:
        ch = self._group_channels()
        return tuple(ch[g] for g in _TAPS)

    def forward(self, x, train: bool = False,
                generator=None) -> List[torch.Tensor]:
        del train, generator  # GroupNorm: no train/eval difference
        x = F.silu(self.stem_gn(self.stem_conv(x.to(self.dtype))))
        features = []
        for i, (gi, name) in enumerate(self.blocks):
            x = getattr(self, name)(x)
            last = i + 1 == len(self.blocks) or self.blocks[i + 1][0] != gi
            if last and gi in _TAPS:
                features.append(x)
        return features


def build_efficientnet(name: str,
                       dtype=torch.float32) -> EfficientNetEncoder:
    """'efficientnet-b4' / 'efficientnet_b4' / 'timm:efficientnet_b4'."""
    key = name.split(":")[-1].replace("-", "_")
    variant = key.rsplit("_", 1)[-1]
    if variant not in _COEFFS:
        raise ValueError(
            f"Unknown efficientnet variant {name!r}; have b0..b7")
    w, d = _COEFFS[variant]
    return EfficientNetEncoder(width=w, depth=d, dtype=dtype)
