"""FPN decoder (port of ``fmc_uia_tpu/models/decoders.py``), NHWC.

Lateral 1x1 convs, top-down nearest 2x upsample + add, per-level seg
blocks (3x3 conv -> GroupNorm(eps 1e-6, output in the compute dtype) ->
ReLU -> bilinear 2x) brought to stride 4, merged by concat or sum. The
GroupNorms are named ``GroupNorm_0..6`` in call order (seg5 x3, seg4 x2,
seg3, seg2), as flax names them. In train mode the merged map gets
channel (spatial) dropout: one keep draw per (sample, channel), broadcast
over H and W.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (
    Conv,
    GroupNorm,
    dropout,
    gn_groups,
    upsample_2x,
)

_SEG_LEVELS = (("seg5", 3), ("seg4", 2), ("seg3", 1), ("seg2", 0))


class FPNDecoder(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 pyramid_channels: int = 256,
                 segmentation_channels: int = 128, merge_policy: str = "cat",
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.merge_policy = merge_policy
        self.dropout = float(dropout)
        self.segmentation_channels = segmentation_channels
        self.dtype = dtype
        for lvl, cin in zip((2, 3, 4, 5), in_channels):
            self.add_module(f"lateral{lvl}", Conv(cin, pyramid_channels, 1,
                                                  dtype=dtype))
        gn = 0
        for name, n_up in _SEG_LEVELS:
            for i in range(max(1, n_up)):
                cin = pyramid_channels if i == 0 else segmentation_channels
                self.add_module(f"{name}_conv{i}", Conv(
                    cin, segmentation_channels, 3, use_bias=False,
                    dtype=dtype))
                self.add_module(f"GroupNorm_{gn}", GroupNorm(
                    segmentation_channels, gn_groups(segmentation_channels),
                    dtype=dtype))
                gn += 1

    @property
    def out_channels(self) -> int:
        if self.merge_policy == "cat":
            return self.segmentation_channels * 4
        return self.segmentation_channels

    def forward(self, features, train: bool = False, generator=None):
        c2, c3, c4, c5 = features
        p5 = self.lateral5(c5)
        p4 = upsample_2x(p5) + self.lateral4(c4)
        p3 = upsample_2x(p4) + self.lateral3(c3)
        p2 = upsample_2x(p3) + self.lateral2(c2)

        gn = 0
        outs = []
        for (name, n_up), x in zip(_SEG_LEVELS, (p5, p4, p3, p2)):
            for i in range(max(1, n_up)):
                x = getattr(self, f"{name}_conv{i}")(x)
                x = F.relu(getattr(self, f"GroupNorm_{gn}")(x))
                gn += 1
                if i < n_up:
                    x = upsample_2x(x, method="bilinear")
            outs.append(x)
        if self.merge_policy == "cat":
            x = torch.cat(outs, dim=-1)
        else:
            x = outs[0] + outs[1] + outs[2] + outs[3]
        return dropout(x, self.dropout, train, generator,
                       broadcast_dims=(1, 2))


def build_decoders(config, in_channels: Sequence[int], dtype=torch.float32
                   ) -> Tuple[Dict[str, str], Dict[str, FPNDecoder]]:
    """(alias task_type -> decoder name, decoder modules): ``fpn_seg``
    always, ``fpn_det``/``fpn_cls``/``fpn_reg`` when their
    ``separate_*_fpn`` flag is set, else aliases of ``fpn_seg``."""
    dec_cfg = config.get("model.decoder", {}) or {}
    kwargs = dict(
        in_channels=tuple(in_channels),
        pyramid_channels=int(dec_cfg.get("pyramid_channels", 256)),
        segmentation_channels=int(dec_cfg.get("segmentation_channels", 128)),
        merge_policy=str(dec_cfg.get("merge_policy", "cat")),
        dropout=float(dec_cfg.get("dropout", 0.0)),
        dtype=dtype,
    )
    modules: Dict[str, FPNDecoder] = {"fpn_seg": FPNDecoder(**kwargs)}
    alias = {"segmentation": "fpn_seg"}
    for task_type, flag, name in (
            ("detection", "separate_detection_fpn", "fpn_det"),
            ("classification", "separate_classification_fpn", "fpn_cls"),
            ("Regression", "separate_regression_fpn", "fpn_reg")):
        if dec_cfg.get(flag, False):
            modules[name] = FPNDecoder(**kwargs)
            alias[task_type] = name
        else:
            alias[task_type] = "fpn_seg"
    return alias, modules
