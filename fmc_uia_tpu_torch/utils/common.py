"""Seeding and small utilities (port of ``fmc_uia_tpu/utils/common.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators. The port's
    device randomness (augmentation, dropout, drop path) comes from the
    Trainer's own generator, seeded with the same value."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def count_parameters(model: torch.nn.Module) -> int:
    """Total number of parameters of a module."""
    return int(sum(p.numel() for p in model.parameters()))
