"""Tensor parallelism over the ``model`` axis (port of
``fmc_uia_tpu/parallel/sharding.py``).

The rules are the JAX package's, applied to the JAX path of each port
parameter (the port names its parameters by those paths, dots for
slashes): the attention ``qkv`` / MLP up-projection kernels column
parallel, the ``proj`` / down-projection kernels row parallel, everything
else replicated; a dimension under ``tp_min_dim`` or one that does not
divide the axis stays replicated. JAX writes a dense kernel ``[in, out]``
and the port ``[out, in]`` (conv HWIO and OIHW), so a spec is computed in
the JAX layout and carried through the weight bridge's permutation:
"column parallel", JAX's last dimension, is dim 0 of a port Dense kernel.

In eager PyTorch a layout is not enough; the port runs the collectives:

  * A sharded parameter is stored as this rank's shard and reached
    through a parametrization that all-gathers it (``module.kernel`` is
    the whole weight; its backward keeps this rank's slice of the
    replicated gradient). The fused K1/K2 blocks take it whole, as GSPMD
    gathers around a Pallas call it cannot partition.
  * Unfused MLPs whose up and down kernels are both sharded (Swin's at
    C > 256, ConvNeXt's ``pwconv1/2``) run Megatron column -> row on the
    shards with one all-reduce (``tp_mlp``); the dense MoE splits its
    experts over the axis the same way (``models/conditioning.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import parametrize

from fmc_uia_tpu_torch.parallel import comm
from fmc_uia_tpu_torch.parallel.mesh import axis_group, axis_size

# (path regex) -- first match wins; paths are '/'-joined JAX paths
_COLUMN_PARALLEL = re.compile(
    r"(qkv|mlp_fc1|pwconv1|expert_in|attn1)/kernel$")
_ROW_PARALLEL = re.compile(
    r"(attn/proj|block\d+/proj|mlp_fc2|pwconv2|expert_out|attn2)/kernel$")
# port kernel layout = JAX layout transposed by this (utils/convert.py)
_KERNEL_PERM = {2: (1, 0), 3: (0, 2, 1), 4: (3, 2, 0, 1), 5: (0, 4, 3, 1, 2)}
_PARAM_SUFFIX = re.compile(r"\.parametrizations\.(\w+)\.original$")


def tp_spec_for_path(path: str, ndim: int, model_axis: str = "model"
                     ) -> Tuple:
    """The JAX-layout spec of one JAX parameter path (a tuple of axis
    names or None, ``()`` for replicated)."""
    if _COLUMN_PARALLEL.search(path):
        return tuple([None] * (ndim - 1) + [model_axis])
    if _ROW_PARALLEL.search(path):
        return tuple([None] * (ndim - 2) + [model_axis, None])
    return ()


def plain_name(name: str) -> str:
    """A parameter's name without its parametrization wrapper."""
    return _PARAM_SUFFIX.sub(r".\1", name)


def jax_perm(name: str, ndim: int) -> Tuple[int, ...]:
    """Port dim i holds JAX dim ``perm[i]`` (kernels re-laid, the rest
    as is)."""
    if plain_name(name).rsplit(".", 1)[-1] == "kernel" and ndim in \
            _KERNEL_PERM:
        return _KERNEL_PERM[ndim]
    return tuple(range(ndim))


def to_port_spec(name: str, jax_spec: Tuple, ndim: int) -> Tuple:
    if not jax_spec:
        return ()
    full = list(jax_spec) + [None] * (ndim - len(jax_spec))
    return tuple(full[j] for j in jax_perm(name, ndim))


def jax_shape(name: str, shape) -> Tuple[int, ...]:
    perm = jax_perm(name, len(shape))
    out = [0] * len(shape)
    for i, j in enumerate(perm):
        out[j] = int(shape[i])
    return tuple(out)


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {plain_name(n): tuple(getattr(v, "shape", v))
            for n, v in params.items()}


def make_param_specs(params, model_axis: str = "model",
                     min_shard_dim: int = 256) -> Dict[str, Tuple]:
    """Port-layout spec per parameter name (``params``: a module or
    ``{name: tensor or shape}``): only dims >= ``min_shard_dim`` get
    sharded (divisibility is checked at placement)."""
    specs = {}
    for name, shape in _named_shapes(params).items():
        path = name.replace(".", "/")
        js = tp_spec_for_path(path, len(shape), model_axis)
        jshape = jax_shape(name, shape)
        for d, ax in enumerate(js):
            if ax is not None and jshape[d] < min_shard_dim:
                js = ()
                break
        specs[name] = to_port_spec(name, js, len(shape))
    return specs


def spec_dim(spec: Tuple, axis: str) -> Optional[int]:
    for d, ax in enumerate(spec):
        if ax == axis:
            return d
    return None


class _GatherShard(nn.Module):
    """The parametrization of a sharded parameter: the whole weight."""

    def __init__(self, dim: int, group):
        super().__init__()
        self.dim, self.group = dim, group

    def forward(self, shard):
        return comm.gather_dim(shard, self.dim, self.group)


def apply_param_sharding(model: nn.Module, mesh, specs=None,
                         model_axis: str = "model") -> Dict[str, int]:
    """Keep this rank's shard of every parameter whose spec names
    ``model_axis`` (its dim dividing the axis; else replicated), behind
    an all-gathering parametrization. Returns {name: sharded port dim}."""
    if specs is None:
        specs = make_param_specs(model, model_axis)
    M = axis_size(mesh, model_axis)
    group = axis_group(mesh, model_axis)
    if M <= 1:
        return {}
    r = comm.group_rank(group)
    sharded = {}
    for name, p in list(model.named_parameters()):
        d = spec_dim(specs.get(name, ()), model_axis)
        if d is None or p.shape[d] % M:
            continue
        mod_name, attr = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        k = p.shape[d] // M
        shard = p.detach().narrow(d, r * k, k).clone()
        parametrize.register_parametrization(mod, attr,
                                             _GatherShard(d, group),
                                             unsafe=True)
        mod.parametrizations[attr].original = nn.Parameter(shard)
        sharded[name] = d
    return sharded


def tp_shard(module: nn.Module, attr: str = "kernel"):
    """(this rank's shard, its dim, the group) of a sharded parameter, or
    None."""
    plist = getattr(module, "parametrizations", None)
    if plist is None or attr not in plist:
        return None
    p = plist[attr]
    g = p[0]
    return p.original, g.dim, g.group


def tp_mlp(y: torch.Tensor, fc1: nn.Module, fc2: nn.Module, dt
           ) -> Optional[torch.Tensor]:
    """``gelu(y fc1 + b1) fc2 + b2`` in ``dt`` (tanh GELU; each product
    rounded to ``dt``, then its bias added) as Megatron column -> row on
    the shards, one all-reduce; None when the pair is not sharded so."""
    s1, s2 = tp_shard(fc1), tp_shard(fc2)
    if s1 is None or s2 is None or s1[1] != 0 or s2[1] != 1 \
            or s1[2] is not s2[2]:
        return None
    group = s1[2]
    y = comm.copy_sum_grad(y.to(dt), group)
    h = F.linear(y, s1[0].to(dt))
    b1 = comm.slice_dim(fc1.bias, 0, group)
    h = F.gelu(h + b1.to(dt), approximate="tanh")
    out = comm.sum_pass(F.linear(h, s2[0].to(dt)), group)
    return out + fc2.bias.to(dt)
