"""ZeRO-1: the optimizer state sharded over the data axis (port of
``fmc_uia_tpu/parallel/zero.py``).

The rule is JAX's: a leaf of at least 65,536 elements keeps its tensor
parallel dim and gains the data axis on the first still-free dim (in the
JAX layout, carried into the port's) that divides the data size. Under
``parallel.zero_optimizer`` with a data axis above 1, the Trainer keeps the
moments of its slice of each such leaf only: the leaf's gradient is
reduce-scattered over the data axis, the slice updated, and the parameter
all-gathered (``Trainer``; the port's optimizer is its own, with optax's
order, not ``torch.optim``, so this is written against it rather than
through ``ZeroRedundancyOptimizer``).
"""

from __future__ import annotations

from typing import Dict, Tuple

from fmc_uia_tpu_torch.parallel.mesh import axis_size
from fmc_uia_tpu_torch.parallel.sharding import (
    jax_perm,
    jax_shape,
    plain_name,
    spec_dim,
    tp_spec_for_path,
)

# leaves smaller than this stay replicated: sharding tiny norm / bias
# moments buys nothing and costs collective latency
_MIN_ZERO_SIZE = 65536


def zero_spec_for_leaf(name: str, shape, mesh, data_axis: str = "data",
                       model_axis: str = "model") -> Tuple:
    """Port-layout spec of one optimizer-state leaf, from the matching
    parameter's name and (whole) shape."""
    name = plain_name(name)
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    size = 1
    for s in shape:
        size *= s
    if ndim == 0 or size < _MIN_ZERO_SIZE:
        return ()
    data_size = axis_size(mesh, data_axis)
    if data_size <= 1:
        return ()
    jshape = jax_shape(name, shape)
    model_size = axis_size(mesh, model_axis)
    base = [None] * ndim
    if model_size > 1:
        base = list(tp_spec_for_path(name.replace(".", "/"), ndim,
                                     model_axis)) or [None] * ndim
        for i, ax in enumerate(base):
            if ax is not None and jshape[i] % model_size != 0:
                base = [None] * ndim
                break
    for i in range(ndim):
        if base[i] is None and jshape[i] % data_size == 0 \
                and jshape[i] >= data_size:
            base[i] = data_axis
            break
    if all(b is None for b in base):
        return ()
    return tuple(base[j] for j in jax_perm(name, ndim))


def zero_dims(named_shapes: Dict[str, tuple], mesh,
              data_axis: str = "data", model_axis: str = "model"
              ) -> Dict[str, int]:
    """{name: port dim over the data axis} of the leaves ZeRO shards."""
    out = {}
    for name, shape in named_shapes.items():
        d = spec_dim(zero_spec_for_leaf(name, shape, mesh, data_axis,
                                        model_axis), data_axis)
        if d is not None:
            out[plain_name(name)] = d
    return out


def shard_opt_state(state: Dict, slices) -> Dict:
    """A whole optimizer state (``GroupedOptimizer.state_dict()``) cut to
    this rank's slices: ``slices`` is, per group, per leaf, None (kept
    whole) or (dim, start, length, whole length)."""
    out = dict(state)
    for key in ("mu", "nu", "trace"):
        if key in state:
            out[key] = [[t if s is None else t.narrow(*s[:3]).clone()
                         for t, s in zip(ts, ss)]
                        for ts, ss in zip(state[key], slices)]
    return out


def zero_sharded_fraction(optimizer) -> float:
    """Share of the optimizer state's (whole) bytes that is sharded."""
    total = sharded = 0
    for key in ("mu", "nu", "trace"):
        for ts, ss in zip(optimizer.buffers.get(key, []),
                          optimizer.slices):
            for t, s in zip(ts, ss):
                n = t.numel() * t.element_size()
                if s is not None:
                    n = n // s[2] * s[3]
                    sharded += n
                total += n
    return sharded / total if total else 0.0
