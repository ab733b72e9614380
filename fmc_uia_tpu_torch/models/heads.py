"""Task-head banks (port of ``fmc_uia_tpu/models/heads.py``), NHWC.

One module per task TYPE; its parameters carry a leading ``num_banks``
axis and the forward selects one slice by the device-side local index.
Ported families: ``SegHeadBank`` (default seg), ``ClsHeadBank`` (GAP),
``CenterNetHeadBank`` (dict output, heatmap bias -2.19) and
``RegHeadBank`` (GAP + MLP + (tanh+1)/2). The others raise and name their
ROADMAP item. Every bank takes ``train`` and ``generator``; the cls and reg
banks apply their dropout in train mode, the others have none.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.layers import (
    BankedConv,
    BankedDense,
    BankedGroupNorm,
    BankedMLP,
    dropout,
    gn_groups,
    resize_to,
)
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    REGRESSION,
    SEGMENTATION,
    TaskRegistry,
)

_NOT_PORTED = ("{what} is not ported to fmc_uia_tpu_torch yet (ROADMAP.md, "
               "port queue item 'Off-main-path heads and conditioning')")


def _gap(x):
    return x.mean(dim=(1, 2))


class SegHeadBank(nn.Module):
    """Banked 3x3 conv + GN + SiLU stack, 1x1 classifier, bilinear
    upsample."""

    def __init__(self, num_banks: int, cin: int, num_classes: int,
                 mid_channels: Optional[int] = None, num_layers: int = 2,
                 upsampling: int = 4, dtype=torch.float32):
        super().__init__()
        mid = mid_channels or cin
        self.num_layers = num_layers
        self.upsampling = upsampling
        for i in range(num_layers):
            self.add_module(f"pre_{i}", BankedConv(
                num_banks, cin if i == 0 else mid, mid, 3, use_bias=False,
                dtype=dtype))
            self.add_module(f"pre_gn_{i}", BankedGroupNorm(
                num_banks, mid, gn_groups(mid)))
        self.classifier = BankedConv(num_banks, mid if num_layers else cin,
                                     num_classes, 1, dtype=dtype)

    def forward(self, x, idx, train: bool = False, generator=None):
        for i in range(self.num_layers):
            x = getattr(self, f"pre_{i}")(x, idx)
            x = F.silu(getattr(self, f"pre_gn_{i}")(x, idx))
        x = self.classifier(x, idx)
        if self.upsampling > 1:
            x = resize_to(x, x.shape[1] * self.upsampling,
                          x.shape[2] * self.upsampling)
        return x


class ClsHeadBank(nn.Module):
    """GAP (+ optional banked MLP) + dropout + banked linear."""

    def __init__(self, num_banks: int, cin: int, num_classes: int,
                 mlp_hidden_dim: Optional[int] = None, dropout: float = 0.2,
                 dtype=torch.float32):
        super().__init__()
        self.pre_fc = (BankedDense(num_banks, cin, mlp_hidden_dim,
                                   dtype=dtype) if mlp_hidden_dim else None)
        self.fc = BankedDense(num_banks, mlp_hidden_dim or cin, num_classes,
                              dtype=dtype)
        self.dropout = float(dropout)

    def forward(self, x, idx, train: bool = False, generator=None):
        h = _gap(x)
        if self.pre_fc is not None:
            h = F.silu(self.pre_fc(h, idx))
            h = dropout(h, self.dropout, train, generator)
        h = dropout(h, self.dropout, train, generator)
        return self.fc(h, idx)


class CenterNetHeadBank(nn.Module):
    """Shared stem + heatmap/size/offset branches (dict of NHWC maps)."""

    def __init__(self, num_banks: int, cin: int, mid_channels: int = 128,
                 dtype=torch.float32):
        super().__init__()
        mid = mid_channels
        for name in ("stem", "hm", "size", "offset"):
            self.add_module(f"{name}_conv", BankedConv(
                num_banks, cin if name == "stem" else mid, mid, 3,
                use_bias=False, dtype=dtype))
            self.add_module(f"{name}_gn", BankedGroupNorm(
                num_banks, mid, gn_groups(mid)))
        # heatmap bias -2.19: initial sigmoid ~0.1
        self.hm_out = BankedConv(num_banks, mid, 1, 1, bias_init_value=-2.19,
                                 dtype=dtype)
        self.size_out = BankedConv(num_banks, mid, 2, 1, dtype=dtype)
        self.offset_out = BankedConv(num_banks, mid, 2, 1, dtype=dtype)

    def _branch(self, h, name, idx):
        h = getattr(self, f"{name}_conv")(h, idx)
        return F.relu(getattr(self, f"{name}_gn")(h, idx))

    def forward(self, x, idx, train: bool = False, generator=None):
        stem = self._branch(x, "stem", idx)
        heatmap = self.hm_out(self._branch(stem, "hm", idx), idx)
        size = F.relu(self.size_out(self._branch(stem, "size", idx), idx))
        offset = torch.sigmoid(
            self.offset_out(self._branch(stem, "offset", idx), idx))
        return {"heatmap": heatmap, "size": size, "offset": offset}


class RegHeadBank(nn.Module):
    """GAP + banked MLP (+ (tanh + 1) / 2 -> [0, 1])."""

    def __init__(self, num_banks: int, cin: int, num_points: int,
                 hidden_dims: Sequence[int] = (256, 128),
                 dropout: float = 0.1, use_tanh: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.use_tanh = use_tanh
        self.mlp = BankedMLP(num_banks, cin, tuple(hidden_dims),
                             num_points * 2, dropout=dropout, dtype=dtype)

    def forward(self, x, idx, train: bool = False, generator=None):
        h = self.mlp(_gap(x), idx, train=train, generator=generator)
        if self.use_tanh:
            h = (torch.tanh(h) + 1.0) * 0.5
        return h


def build_head_banks(config, registry: TaskRegistry, in_channels,
                     dtype=torch.float32) -> Dict[str, nn.Module]:
    """One head bank per present task type. ``in_channels`` maps a task
    type to the channels of the features its head reads."""
    heads_cfg = config.get("model.heads", {}) or {}
    if heads_cfg.get("use_baseline", False):
        raise NotImplementedError(_NOT_PORTED.format(
            what="baseline head banks (model.heads.use_baseline)"))
    banks: Dict[str, nn.Module] = {}

    if registry.num_of_type(SEGMENTATION) > 0:
        cfg = heads_cfg.get("segmentation", {}) or {}
        if (cfg.get("use_deep_supervision", False)
                or cfg.get("type", "standard") == "unet_like"):
            raise NotImplementedError(_NOT_PORTED.format(
                what="DeepSupervisionSegHeadBank / UNetLikeSegHeadBank"))
        mid = cfg.get("mid_channels")
        banks[SEGMENTATION] = SegHeadBank(
            registry.num_of_type(SEGMENTATION), in_channels[SEGMENTATION],
            registry.max_classes(SEGMENTATION),
            mid_channels=int(mid) if mid else None,
            num_layers=int(cfg.get("num_layers", 2)),
            upsampling=int(cfg.get("upsampling", 4)), dtype=dtype)

    if registry.num_of_type(CLASSIFICATION) > 0:
        cfg = heads_cfg.get("classification", {}) or {}
        if cfg.get("type") == "baseline":
            raise NotImplementedError(_NOT_PORTED.format(
                what="BaselineClsHeadBank"))
        mlp = cfg.get("mlp_hidden_dim")
        banks[CLASSIFICATION] = ClsHeadBank(
            registry.num_of_type(CLASSIFICATION),
            in_channels[CLASSIFICATION],
            registry.max_classes(CLASSIFICATION),
            mlp_hidden_dim=int(mlp) if mlp else None,
            dropout=float(cfg.get("dropout", 0.2)), dtype=dtype)

    if registry.num_of_type(DETECTION) > 0:
        cfg = heads_cfg.get("detection", {}) or {}
        if cfg.get("type", "centernet") != "centernet":
            raise NotImplementedError(_NOT_PORTED.format(
                what="grid / baseline detection head banks"))
        banks[DETECTION] = CenterNetHeadBank(
            registry.num_of_type(DETECTION), in_channels[DETECTION],
            mid_channels=int(cfg.get("mid_channels", 128)), dtype=dtype)

    if registry.num_of_type(REGRESSION) > 0:
        cfg = heads_cfg.get("regression", {}) or {}
        if cfg.get("type") == "baseline":
            raise NotImplementedError(_NOT_PORTED.format(
                what="BaselineRegHeadBank"))
        hidden = cfg.get("hidden_dims") or [256, 128]
        banks[REGRESSION] = RegHeadBank(
            registry.num_of_type(REGRESSION), in_channels[REGRESSION],
            registry.max_classes(REGRESSION),
            hidden_dims=tuple(int(d) for d in hidden),
            dropout=float(cfg.get("dropout", 0.1)),
            use_tanh=bool(cfg.get("use_tanh", True)), dtype=dtype)
    return banks
