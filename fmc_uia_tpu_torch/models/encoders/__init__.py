"""Encoder dispatch (port of ``fmc_uia_tpu/models/encoders/__init__.py``).

Only the Swin family is ported so far (``swin_*`` and ``timm:*swin*``);
every other family raises and names the ROADMAP item that ports it.
"""

from __future__ import annotations

import torch

_NOT_PORTED = ("encoder {name!r} is not ported to fmc_uia_tpu_torch yet "
               "(ROADMAP.md, port queue item 'Other encoders': ViT/DINOv3, "
               "ConvNeXt, EfficientNet, ResNet)")


def _timm_swin_variant(body: str) -> str:
    for key, variant in (("tiny", "swin_t"), ("small", "swin_s"),
                         ("large", "swin_l"), ("base", "swin_b")):
        if key in body:
            return variant
    return "swin_b"


def build_encoder(config, dtype=torch.float32):
    """Build the encoder named by ``model.encoder.name``."""
    from fmc_uia_tpu_torch.models.encoders.swin import build_swin

    name = str(config.get("model.encoder.name", "resnet50"))
    if name.startswith("timm:") and "swin" in name.lower():
        return build_swin(_timm_swin_variant(name[len("timm:"):].lower()),
                          config, dtype=dtype)
    if name.startswith("swin_"):
        return build_swin(name, config, dtype=dtype)
    raise NotImplementedError(_NOT_PORTED.format(name=name))


__all__ = ["build_encoder"]
