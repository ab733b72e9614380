"""The activation mesh scope (port of ``fmc_uia_tpu/parallel/activation.py``).

JAX pins activation layouts here so that GSPMD never has to guess them.
In eager PyTorch a rank's activations already have the layout JAX pins:
batch-sharded over ``data`` and, after a row-parallel all-reduce,
replicated over ``model``. So ``shard_activation`` is the identity.

What carries over is the scope: the mesh a Trainer trains under is
installed only around its own steps (``activation_mesh_scope``), never
left installed process-wide, so it cannot leak into later, unrelated
computations (the JAX package's r3 leak). Model code that needs the mesh
reads it from the scope: the MoE block's ``ragged`` / ``auto`` dispatch
(``models/conditioning.py``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_ACT_MESH = None


def set_activation_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh. Prefer the scope: a bare
    install that outlives its computation is the leak the scope
    prevents; this setter is for teardown."""
    global _ACT_MESH
    _ACT_MESH = mesh


@contextlib.contextmanager
def activation_mesh_scope(mesh):
    """``mesh`` installed inside, the previous one restored on exit."""
    global _ACT_MESH
    prev = _ACT_MESH
    _ACT_MESH = mesh
    try:
        yield mesh
    finally:
        _ACT_MESH = prev


def activation_mesh() -> Optional[object]:
    return _ACT_MESH


def shard_activation(x: torch.Tensor, *spec) -> torch.Tensor:
    """The identity: eager activations already have the pinned layout."""
    return x


def shard_batch_activation(x: torch.Tensor) -> torch.Tensor:
    """Batch-sharded, feature-replicated: the identity (see above)."""
    return x
