"""ConvNeXt encoder (port of ``fmc_uia_tpu/models/encoders/convnext.py``).

Patchify stem (4x4 / 4) + LayerNorm, 4 stages of ConvNeXt blocks (7x7
depthwise conv, LayerNorm, pointwise 4x MLP with tanh GELU, layer scale
``gamma``, stochastic depth), LayerNorm + 2x2 / 2 conv between stages.
NHWC, f32 params, convs and dense layers compute in ``dtype``, every
LayerNorm in f32 (eps 1e-6).

Dtype flow follows the JAX modules: the stem LayerNorm returns f32, so
stage 0's residual stream is f32 (f32 + ``dtype`` promotes); after each
``down{s}`` conv stages 1-3 carry ``dtype``. Stochastic depth draws a
per-sample keep mask from the explicit generator, as the Swin blocks do.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.layers import (
    Conv,
    Dense,
    _param,
    apply_drop_path,
    drop_path_keep,
    keep_mask,
    layer_norm,
)


class _LN(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = _param(features)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, 1e-6, torch.float32)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.drop_path = float(drop_path)
        self.dwconv = Conv(dim, dim, 7, groups=dim, dtype=dtype)
        self.norm = _LN(dim)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))

    def forward(self, x, train: bool = False, generator=None):
        dt = self.dtype
        y = self.norm(self.dwconv(x))
        # flax Dense: the product rounded to dtype, then the bias added
        y = F.linear(y.to(dt), self.pwconv1.kernel.to(dt))
        y = F.gelu(y + self.pwconv1.bias.to(dt), approximate="tanh")
        y = F.linear(y, self.pwconv2.kernel.to(dt))
        y = (y + self.pwconv2.bias.to(dt)) * self.gamma.to(dt)
        if train and self.drop_path > 0.0:
            keep = keep_mask((x.shape[0],),
                             float(drop_path_keep(self.drop_path)),
                             generator, x.device)
            y = apply_drop_path(y, keep, self.drop_path)
        return x + y


class ConvNeXtEncoder(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024),
                 drop_path_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.dtype = dtype
        self.stem = Conv(3, dims[0], 4, stride=4, dtype=dtype)
        self.stem_norm = _LN(dims[0])
        dpr = np.linspace(0, drop_path_rate, sum(self.depths))
        bid = 0
        for s, depth in enumerate(self.depths):
            if s > 0:
                self.add_module(f"down{s}_norm", _LN(dims[s - 1]))
                self.add_module(f"down{s}", Conv(dims[s - 1], dims[s], 2,
                                                 stride=2, dtype=dtype))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", ConvNeXtBlock(
                    dims[s], drop_path=float(dpr[bid]), dtype=dtype))
                bid += 1

    @property
    def out_channels(self) -> Tuple[int, int, int, int]:
        return self.dims

    def forward(self, x, train: bool = False,
                generator=None) -> List[torch.Tensor]:
        x = self.stem_norm(self.stem(x.to(self.dtype)))
        features = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"down{s}")(
                    getattr(self, f"down{s}_norm")(x))
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x, train, generator)
            features.append(x)
        return features


_CONVNEXT_VARIANTS = {
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "convnext_large": dict(depths=(3, 3, 27, 3),
                           dims=(192, 384, 768, 1536)),
    "convnext_nano_test": dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128)),
}


def build_convnext(name: str, config=None,
                   dtype=torch.float32) -> ConvNeXtEncoder:
    """``convnext_*`` or ``timm:convnext_*[.tag]``; the stochastic-depth
    rate from ``model.encoder.drop_path_rate`` (default 0.1)."""
    key = name[5:] if name.startswith("timm:") else name
    key = key.split(".")[0]
    if key not in _CONVNEXT_VARIANTS:
        raise ValueError(
            f"Unknown convnext variant {key!r}; have "
            f"{sorted(_CONVNEXT_VARIANTS)}")
    drop_path = 0.1
    if config is not None:
        drop_path = float(config.get("model.encoder.drop_path_rate", 0.1))
    return ConvNeXtEncoder(dtype=dtype, drop_path_rate=drop_path,
                           **_CONVNEXT_VARIANTS[key])
