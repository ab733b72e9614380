"""Task-head banks (port of ``fmc_uia_tpu/models/heads.py``), NHWC.

One module per task TYPE; its parameters carry a leading ``num_banks``
axis and the forward selects one slice by the device-side local index.
Families: ``SegHeadBank`` (default seg), ``UNetLikeSegHeadBank``,
``DeepSupervisionSegHeadBank`` (returns ``(main, [aux...])``),
``ClsHeadBank`` (GAP), ``BaselineClsHeadBank``, ``CenterNetHeadBank``
(dict output, heatmap bias -2.19), ``GridDetectionHeadBank`` and
``BaselineGridDetectionHeadBank`` (a [B, h, w, 4 + 1] map: sigmoid box,
objectness logit), ``RegHeadBank`` (GAP + MLP + (tanh+1)/2) and
``BaselineRegHeadBank``. Every bank takes ``train`` and ``generator``;
the cls and reg banks apply their dropout in train mode, the others have
none.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (
    BankedConv,
    BankedDense,
    BankedGroupNorm,
    BankedMLP,
    dropout,
    gn_groups,
    resize_to,
    upsample_2x,
)
from .tasks import (
    CLASSIFICATION,
    DETECTION,
    REGRESSION,
    SEGMENTATION,
    TaskRegistry,
)

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


class UNetLikeSegHeadBank(nn.Module):
    """Conv + GN + SiLU + bilinear 2x per factor of 2 of ``upsampling``,
    ``num_blocks - 1`` extra conv + GN + SiLU, a 1x1 classifier."""

    def __init__(self, num_banks: int, cin: int, num_classes: int,
                 mid_channels: Optional[int] = None, upsampling: int = 4,
                 num_blocks: int = 2, dtype=torch.float32):
        super().__init__()
        mid = mid_channels or cin
        n_up, scale = 0, upsampling
        while scale > 1:
            n_up, scale = n_up + 1, scale // 2
        self.n_up, self.n_extra = n_up, max(0, num_blocks - 1)
        for i in range(n_up):
            self.add_module(f"up_{i}", BankedConv(
                num_banks, cin if i == 0 else mid, mid, 3, use_bias=False,
                dtype=dtype))
            self.add_module(f"up_gn_{i}", BankedGroupNorm(
                num_banks, mid, gn_groups(mid)))
        for j in range(self.n_extra):
            self.add_module(f"extra_{j}", BankedConv(
                num_banks, mid if n_up or j else cin, mid, 3,
                use_bias=False, dtype=dtype))
            self.add_module(f"extra_gn_{j}", BankedGroupNorm(
                num_banks, mid, gn_groups(mid)))
        self.out = BankedConv(num_banks, mid if n_up or self.n_extra
                              else cin, num_classes, 1, dtype=dtype)

    def forward(self, x, idx, train: bool = False, generator=None):
        for i in range(self.n_up):
            x = getattr(self, f"up_{i}")(x, idx)
            x = F.silu(getattr(self, f"up_gn_{i}")(x, idx))
            x = upsample_2x(x, method="bilinear")
        for j in range(self.n_extra):
            x = getattr(self, f"extra_{j}")(x, idx)
            x = F.silu(getattr(self, f"extra_gn_{j}")(x, idx))
        return self.out(x, idx)


class DeepSupervisionSegHeadBank(nn.Module):
    """A 1x1 main classifier resized bilinearly by ``upsampling``, and
    ``num_aux_outputs`` 1x1 auxiliary classifiers at the input's
    resolution; returns ``(main, [aux...])``."""

    def __init__(self, num_banks: int, cin: int, num_classes: int,
                 num_aux_outputs: int = 3, upsampling: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.upsampling = upsampling
        self.main = BankedConv(num_banks, cin, num_classes, 1, dtype=dtype)
        self.num_aux = num_aux_outputs
        for i in range(num_aux_outputs):
            self.add_module(f"aux_{i}", BankedConv(num_banks, cin,
                                                   num_classes, 1,
                                                   dtype=dtype))

    def forward(self, x, idx, train: bool = False, generator=None):
        main = self.main(x, idx)
        main = resize_to(main, main.shape[1] * self.upsampling,
                         main.shape[2] * self.upsampling)
        return main, [getattr(self, f"aux_{i}")(x, idx)
                      for i in range(self.num_aux)]


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


class BaselineClsHeadBank(nn.Module):
    """GAP + dropout + banked linear."""

    def __init__(self, num_banks: int, cin: int, num_classes: int,
                 dropout: float = 0.2, dtype=torch.float32):
        super().__init__()
        self.fc = BankedDense(num_banks, cin, num_classes, dtype=dtype)
        self.dropout = float(dropout)

    def forward(self, x, idx, train: bool = False, generator=None):
        return self.fc(dropout(_gap(x), self.dropout, train, generator),
                       idx)


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


def _grid_out(out):
    """Sigmoid on the 4 box channels, objectness (and any further
    channel) left as logits."""
    return torch.cat([torch.sigmoid(out[..., :4]), out[..., 4:]], dim=-1)


class GridDetectionHeadBank(nn.Module):
    """3x3 projection + GN + ReLU, a residual refine (two conv + GN) with
    SE channel attention, ReLU, a 1x1 conv to ``num_anchors * (4 +
    num_classes)`` channels: a [B, h, w, 4 + C] map."""

    def __init__(self, num_banks: int, cin: int, num_classes: int = 1,
                 mid_channels: int = 128, num_anchors: int = 1,
                 dtype=torch.float32):
        super().__init__()
        mid = mid_channels
        for name, c_in in (("in_conv", cin), ("refine1", mid),
                           ("refine2", mid)):
            self.add_module(name, BankedConv(num_banks, c_in, mid, 3,
                                             use_bias=False, dtype=dtype))
        for name in ("in_gn", "refine1_gn", "refine2_gn"):
            self.add_module(name, BankedGroupNorm(num_banks, mid,
                                                  gn_groups(mid)))
        self.attn1 = BankedDense(num_banks, mid, mid // 4, dtype=dtype)
        self.attn2 = BankedDense(num_banks, mid // 4, mid, dtype=dtype)
        self.out = BankedConv(num_banks, mid, num_anchors * (4 + num_classes),
                              1, dtype=dtype)

    def forward(self, x, idx, train: bool = False, generator=None):
        h = F.relu(self.in_gn(self.in_conv(x, idx), idx))
        r = F.relu(self.refine1_gn(self.refine1(h, idx), idx))
        r = self.refine2_gn(self.refine2(r, idx), idx)
        a = F.relu(self.attn1(_gap(r), idx))
        a = torch.sigmoid(self.attn2(a, idx))
        h = r * a[:, None, None, :] + h
        return _grid_out(self.out(F.relu(h), idx))


class BaselineGridDetectionHeadBank(nn.Module):
    """Two 3x3 conv + GN + ReLU, a 1x1 conv to the grid map."""

    def __init__(self, num_banks: int, cin: int, num_classes: int = 1,
                 mid_channels: int = 128, num_anchors: int = 1,
                 dtype=torch.float32):
        super().__init__()
        mid = mid_channels
        for i in range(2):
            self.add_module(f"conv{i}", BankedConv(
                num_banks, cin if i == 0 else mid, mid, 3, use_bias=False,
                dtype=dtype))
            self.add_module(f"gn{i}", BankedGroupNorm(num_banks, mid,
                                                      gn_groups(mid)))
        self.out = BankedConv(num_banks, mid, num_anchors * (4 + num_classes),
                              1, dtype=dtype)

    def forward(self, x, idx, train: bool = False, generator=None):
        for i in range(2):
            x = F.relu(getattr(self, f"gn{i}")(
                getattr(self, f"conv{i}")(x, idx), idx))
        return _grid_out(self.out(x, idx))


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


class BaselineRegHeadBank(nn.Module):
    """GAP + banked linear to 2P coordinates (no squashing)."""

    def __init__(self, num_banks: int, cin: int, num_points: int,
                 dtype=torch.float32):
        super().__init__()
        self.fc = BankedDense(num_banks, cin, num_points * 2, dtype=dtype)

    def forward(self, x, idx, train: bool = False, generator=None):
        return self.fc(_gap(x), idx)


def build_head_banks(config, registry: TaskRegistry, in_channels,
                     dtype=torch.float32) -> Dict[str, nn.Module]:
    """One head bank per present task type, chosen as the JAX package
    chooses it (``model.heads.use_baseline`` picks the baseline cls, grid
    det and reg banks). ``in_channels`` maps a task type to the channels
    of the features its head reads."""
    heads_cfg = config.get("model.heads", {}) or {}
    use_baseline = bool(heads_cfg.get("use_baseline", False))
    banks: Dict[str, nn.Module] = {}

    if registry.num_of_type(SEGMENTATION) > 0:
        cfg = heads_cfg.get("segmentation", {}) or {}
        T, cin = registry.num_of_type(SEGMENTATION), in_channels[SEGMENTATION]
        C = registry.max_classes(SEGMENTATION)
        mid = cfg.get("mid_channels")
        mid = int(mid) if mid else None
        up = int(cfg.get("upsampling", 4))
        if cfg.get("use_deep_supervision", False):
            banks[SEGMENTATION] = DeepSupervisionSegHeadBank(
                T, cin, C, num_aux_outputs=int(cfg.get("num_aux_outputs", 3)),
                upsampling=up, dtype=dtype)
        elif cfg.get("type", "standard") == "unet_like":
            banks[SEGMENTATION] = UNetLikeSegHeadBank(
                T, cin, C, mid_channels=mid, upsampling=up,
                num_blocks=int(cfg.get("num_blocks", 2)), dtype=dtype)
        else:
            banks[SEGMENTATION] = SegHeadBank(
                T, cin, C, mid_channels=mid,
                num_layers=int(cfg.get("num_layers", 2)), upsampling=up,
                dtype=dtype)

    if registry.num_of_type(CLASSIFICATION) > 0:
        cfg = heads_cfg.get("classification", {}) or {}
        T = registry.num_of_type(CLASSIFICATION)
        cin = in_channels[CLASSIFICATION]
        C = registry.max_classes(CLASSIFICATION)
        drop = float(cfg.get("dropout", 0.2))
        if use_baseline or cfg.get("type") == "baseline":
            banks[CLASSIFICATION] = BaselineClsHeadBank(
                T, cin, C, dropout=drop, dtype=dtype)
        else:
            mlp = cfg.get("mlp_hidden_dim")
            banks[CLASSIFICATION] = ClsHeadBank(
                T, cin, C, mlp_hidden_dim=int(mlp) if mlp else None,
                dropout=drop, dtype=dtype)

    if registry.num_of_type(DETECTION) > 0:
        cfg = heads_cfg.get("detection", {}) or {}
        T, cin = registry.num_of_type(DETECTION), in_channels[DETECTION]
        mid = int(cfg.get("mid_channels", 128))
        det_type = cfg.get("type", "centernet")
        if det_type == "centernet" and not use_baseline:
            banks[DETECTION] = CenterNetHeadBank(T, cin, mid_channels=mid,
                                                 dtype=dtype)
        else:
            cls = (BaselineGridDetectionHeadBank
                   if use_baseline or det_type == "baseline"
                   else GridDetectionHeadBank)
            banks[DETECTION] = cls(
                T, cin, num_classes=registry.max_classes(DETECTION),
                mid_channels=mid,
                num_anchors=int(cfg.get("num_anchors", 1)), dtype=dtype)

    if registry.num_of_type(REGRESSION) > 0:
        cfg = heads_cfg.get("regression", {}) or {}
        T, cin = registry.num_of_type(REGRESSION), in_channels[REGRESSION]
        P = registry.max_classes(REGRESSION)
        if use_baseline or cfg.get("type") == "baseline":
            banks[REGRESSION] = BaselineRegHeadBank(T, cin, P, dtype=dtype)
        else:
            hidden = cfg.get("hidden_dims") or [256, 128]
            banks[REGRESSION] = RegHeadBank(
                T, cin, P, hidden_dims=tuple(int(d) for d in hidden),
                dropout=float(cfg.get("dropout", 0.1)),
                use_tanh=bool(cfg.get("use_tanh", True)), dtype=dtype)
    return banks
