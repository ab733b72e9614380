"""Encoder dispatch (port of ``fmc_uia_tpu/models/encoders/__init__.py``).

Ported: Swin (``swin_*``, ``timm:*swin*``) and ViT/DINOv3 (``vit_*``,
``dinov3*``, ``timm:`` names containing vit/deit/dino/eva) with the
'resize' and 'spm_interaction' adapters. ResNet, ConvNeXt and
EfficientNet raise and name the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch

_NOT_PORTED = ("encoder {name!r} is not ported to fmc_uia_tpu_torch yet "
               "(ROADMAP.md, port queue item 'Other encoders': ResNet, "
               "ConvNeXt, EfficientNet)")
_VIT_KEYS = ("vit", "deit", "dino", "eva")


def _timm_swin_variant(body: str) -> str:
    for key, variant in (("tiny", "swin_t"), ("small", "swin_s"),
                         ("large", "swin_l"), ("base", "swin_b")):
        if key in body:
            return variant
    return "swin_b"


def build_encoder(config, dtype=torch.float32):
    """Build the encoder named by ``model.encoder.name``."""
    from fmc_uia_tpu_torch.models.encoders.swin import build_swin
    from fmc_uia_tpu_torch.models.encoders.vit import build_vit_encoder

    name = str(config.get("model.encoder.name", "resnet50"))
    if name.startswith("timm:"):
        body = name[len("timm:"):].lower()
        if "swin" in body:
            return build_swin(_timm_swin_variant(body), config, dtype=dtype)
        if any(k in body for k in _VIT_KEYS):
            return build_vit_encoder(name, config, dtype=dtype)
        raise NotImplementedError(_NOT_PORTED.format(name=name))
    if name.startswith("swin_"):
        return build_swin(name, config, dtype=dtype)
    if name.startswith(("vit_", "dinov3")):
        return build_vit_encoder(name, config, dtype=dtype)
    raise NotImplementedError(_NOT_PORTED.format(name=name))


__all__ = ["build_encoder"]
