"""Seeded weights, made on the device in one call and handed to both the
program and the reference.

The leaves, their shapes and their placeholders come from the reference
model (``reference/multitask.py``, built with its placeholders: zeros;
ones for norm scales and FiLM gammas; LayerScale and RoPE periods at their
defaults). One ``torch.randn`` over all leaves, from a generator on the
device seeded with ``--seed``, is clipped to [-2, 2] and cut into leaves:

* a LayerScale leaf (``ls1``, ``ls2``): ``0.1 (1 + 0.1 n)``, the size of
  a trained backbone's (its placeholder, the training init 1e-5, would
  leave every attention and MLP branch of a frozen backbone out of the
  step's numbers, and so out of the comparison);
* another leaf whose placeholder is not all zeros: ``placeholder * (1 +
  0.1 n)`` (``rope_periods``, a frozen table of the model, keeps its
  placeholder);
* a zero leaf named like a table of embeddings or tokens: ``0.02 n``;
* another zero leaf with two dimensions or more: ``n / sqrt(fan_in)``,
  ``fan_in`` the product of the dimensions after the output's (dense
  ``[out, in]``, conv ``[O, I, kh, kw]``; banks ``[T, out, ...]``);
* a zero vector (a bias): ``0.02 n``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SMALL = 0.02
GAIN_NOISE = 0.1
TABLE_WORDS = ("rel_pos_bias", "token", "pos_embed", "embedding",
               "task_embed")
KEEP = ("rope_periods",)
LAYERSCALE = ("ls1", "ls2")
LAYERSCALE_SIZE = 0.1


def fan_in(shape) -> int:
    """Inputs per output of a weight leaf (see the module docstring)."""
    n = math.prod(shape)
    lead = 2 if len(shape) in (3, 5) else 1  # a bank [T, out, ...]
    return max(1, n // math.prod(shape[:lead]))


def make_weights(template: Dict[str, torch.Tensor], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """name -> f32 leaf on ``device``, from the reference's placeholders
    ``template`` (name -> tensor) and ``seed``."""
    names = list(template)
    sizes = [template[n].numel() for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32).clamp_(-2.0, 2.0)
    out = {}
    for name, noise in zip(names, torch.split(flat, sizes)):
        base = template[name].to(device=device, dtype=torch.float32)
        noise = noise.view(base.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in KEEP:
            w = base.clone()
        elif leaf in LAYERSCALE:
            w = LAYERSCALE_SIZE * (1.0 + GAIN_NOISE * noise)
        elif bool((base != 0).any()):
            w = base * (1.0 + GAIN_NOISE * noise)
        elif any(word in name for word in TABLE_WORDS) or base.dim() < 2:
            w = SMALL * noise
        else:
            w = noise / math.sqrt(fan_in(tuple(base.shape)))
        out[name] = w
    return out


def reference_template(config, registry, device
                       ) -> Dict[str, torch.Tensor]:
    """The reference model's parameters at their placeholders, built on
    ``device`` (names as the program's ``named_parameters``)."""
    from perfbench.reference.multitask import build_model

    model = build_model(config, registry, dtype=torch.float32, device=device)
    return {n: p.detach() for n, p in model.named_parameters()}
