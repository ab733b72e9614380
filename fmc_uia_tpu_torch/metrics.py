"""Decode helpers shared with evaluation (port of
``fmc_uia_tpu/metrics.py`` ``masked_argmax``; the rest of the metric
surface waits for the training slice)."""

from __future__ import annotations

import torch


def masked_argmax(logits: torch.Tensor, num_valid_classes) -> torch.Tensor:
    """Argmax over the first num_valid_classes logits (padding masked);
    ties go to the first maximum, as jnp.argmax."""
    C = logits.shape[-1]
    valid = torch.arange(C, device=logits.device) < num_valid_classes
    neg = torch.full((), float("-inf"), dtype=logits.dtype,
                     device=logits.device)
    return torch.argmax(torch.where(valid, logits, neg), dim=-1)
