"""Image normalization (port of ``fmc_uia_tpu/ops/image.py``
``normalize_images``)."""

from __future__ import annotations

from typing import Sequence

import torch


def normalize_images(images: torch.Tensor, mean: Sequence[float],
                     std: Sequence[float], dtype=torch.float32
                     ) -> torch.Tensor:
    """(x/255 - mean) / std, as A.Normalize (max_pixel_value=255):
    computed as (x - 255*mean) / (255*std) in f32, then cast. ``mean`` and
    ``std`` may be sequences or f32 tensors already on the images'
    device."""
    dev = images.device
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev) * 255.0
    denom = torch.as_tensor(std, dtype=torch.float32, device=dev) * 255.0
    return ((images.float() - mean) / denom).to(dtype)
