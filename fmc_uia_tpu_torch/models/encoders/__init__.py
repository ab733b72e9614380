"""Encoder dispatch (port of ``fmc_uia_tpu/models/encoders/__init__.py``).

The name-prefix dispatch of the JAX package, in its order: ``timm:``
names map onto the matching from-scratch family (swin, then efficientnet,
then convnext; a body with none of these and no ViT key raises), then
``swin_*``, names containing ``convnext``, ``vit_*`` / ``dinov3*`` /
the remaining ``timm:`` names (ViT / DINOv3 with the 'resize' or
'spm_interaction' adapter), names containing ``efficientnet``, and the
ResNets. Any other name raises ``ValueError`` listing the families.

All encoders share one contract: ``forward(x_nhwc, train, generator) ->
[c2, c3, c4, c5]`` at strides 4/8/16/32, plus ``out_channels``.
"""

from __future__ import annotations

import torch

_SUPPORTED_FAMILIES = (
    "swin_{t,s,b,l,nano}", "vit_{t,s,b,l,nano}", "dinov3*",
    "convnext_{t,s,b,l}", "resnet50/101/resnet_tiny",
    "efficientnet-b0..b7",
    "timm:<vit|deit|dino|swin|convnext|efficientnet name>",
)
_VIT_KEYS = ("vit", "deit", "dino", "eva")


def _timm_swin_variant(body: str) -> str:
    for key, variant in (("tiny", "swin_t"), ("small", "swin_s"),
                         ("large", "swin_l"), ("base", "swin_b")):
        if key in body:
            return variant
    return "swin_b"


def build_encoder(config, dtype=torch.float32):
    """Build the encoder named by ``model.encoder.name`` (default
    ``resnet50``)."""
    from fmc_uia_tpu_torch.models.encoders.convnext import build_convnext
    from fmc_uia_tpu_torch.models.encoders.efficientnet import (
        build_efficientnet,
    )
    from fmc_uia_tpu_torch.models.encoders.resnet import (
        ResNetEncoder,
        resnet50,
    )
    from fmc_uia_tpu_torch.models.encoders.swin import build_swin
    from fmc_uia_tpu_torch.models.encoders.vit import build_vit_encoder

    name = str(config.get("model.encoder.name", "resnet50"))
    if name.startswith("timm:"):
        body = name[len("timm:"):].lower()
        if "swin" in body:
            return build_swin(_timm_swin_variant(body), config, dtype=dtype)
        if "efficientnet" in body:
            return build_efficientnet(body, dtype=dtype)
        if "convnext" in body:
            return build_convnext(body, config, dtype=dtype)
        if not any(k in body for k in _VIT_KEYS):
            raise ValueError(
                f"Unsupported timm architecture {name!r}: no from-scratch "
                f"equivalent in this framework (supported: "
                f"{', '.join(_SUPPORTED_FAMILIES)}). Refusing to silently "
                "substitute a different model.")
    if name.startswith("swin_"):
        return build_swin(name, config, dtype=dtype)
    if "convnext" in name:
        return build_convnext(name, config, dtype=dtype)
    if name.startswith(("vit_", "dinov3", "timm:")):
        return build_vit_encoder(name, config, dtype=dtype)
    if "efficientnet" in name:
        return build_efficientnet(name, dtype=dtype)
    if name in ("resnet50", "resnet-50"):
        return resnet50(dtype=dtype)
    if name in ("resnet101", "resnet-101"):
        return ResNetEncoder(stage_sizes=(3, 4, 23, 3), width=64, dtype=dtype)
    if name == "resnet_tiny":  # test-size encoder
        return ResNetEncoder(stage_sizes=(1, 1, 1, 1), width=16, dtype=dtype)
    raise ValueError(
        f"Unknown encoder name: {name!r} (supported: "
        f"{', '.join(_SUPPORTED_FAMILIES)})")


__all__ = ["build_encoder"]
