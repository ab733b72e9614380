"""Multi-process setup (port of ``fmc_uia_tpu/parallel/distributed.py``).

``init_distributed(config)`` joins the process group of a multi-process
run: the ``parallel.distributed`` keys first (``enabled``,
``coordinator_address`` host:port, ``num_processes``, ``process_id``),
then torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). NCCL for the card, gloo for
the CPU. A single process (no ``WORLD_SIZE`` above 1) is a no-op that
returns False, as in JAX.

Usage, one process per device (``torchrun --nproc_per_node N -m
fmc_uia_tpu_torch --config ...``):

    init_distributed(config)             # no-op in a single process
    mesh = mesh_from_config(config)      # parallel.mesh, or None
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from fmc_uia_tpu_torch.parallel.mesh import make_mesh


def is_main_process() -> bool:
    """True in a single process and on global rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _device_type(device) -> str:
    return torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")


def init_distributed(config=None, device=None) -> bool:
    """Join the process group of a multi-process run; True when one is
    active (already, or now)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    dist_cfg: Dict = {}
    if config is not None:
        dist_cfg = config.get("parallel.distributed", {}) or {}
    if not dist_cfg.get("enabled", True):
        return False
    env = os.environ
    coordinator = dist_cfg.get("coordinator_address")
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    num = dist_cfg.get("num_processes", env.get("WORLD_SIZE"))
    rank = dist_cfg.get("process_id", env.get("RANK"))
    if num is None or int(num) <= 1:
        return False
    if coordinator is None or rank is None:
        raise ValueError(f"{num} processes but no coordinator address or "
                         "rank (parallel.distributed or MASTER_ADDR/"
                         "MASTER_PORT/RANK)")
    dev = _device_type(device)
    if dev == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=int(num),
        rank=int(rank))
    return True


def _fill_sizes(spec: Dict[str, int], n: int) -> tuple:
    sizes = [int(s) for s in spec.values()]
    known = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if -1 in sizes:
        if n % known:
            raise ValueError(f"mesh axes {spec} incompatible with {n} "
                             "devices")
        sizes[sizes.index(-1)] = n // known
    return tuple(sizes)


def make_hybrid_mesh(ici_axes: Optional[Dict[str, int]] = None,
                     num_slices: Optional[int] = None, device_type=None):
    """A ``(dcn_data, *ici_axes)`` mesh: one ``dcn_data`` row per node
    (``WORLD_SIZE // LOCAL_WORLD_SIZE`` by default), ranks node-major (as
    torchrun numbers them), the inner axes within a node; one size may be
    -1."""
    world = dist.get_world_size()
    if num_slices is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_slices = max(1, world // max(1, local))
    if world % num_slices:
        raise ValueError(f"{world} devices not divisible into {num_slices} "
                         "slices")
    per_slice = world // num_slices
    ici_axes = dict(ici_axes or {"data": -1})
    sizes = _fill_sizes(ici_axes, per_slice)
    if int(np.prod(sizes)) != per_slice:
        raise ValueError(f"ici axes {dict(zip(ici_axes, sizes))} != "
                         f"{per_slice} devices per slice")
    return make_mesh(axes=("dcn_data",) + tuple(ici_axes),
                     shape=(num_slices,) + sizes, device_type=device_type)


def mesh_shape_from_config(config, n_devices: int):
    """(axis names, sizes) of ``parallel.mesh`` over ``n_devices``, the -1
    axis filled; None without a mesh. The sizes may hold fewer devices
    than there are, as JAX's ``devices[:prod(sizes)]``."""
    if config is None:
        return None
    par = config.get("parallel", {}) or {}
    spec = par.get("mesh")
    if not spec:
        return None
    spec = dict(spec)
    return tuple(spec), _fill_sizes(spec, n_devices)


def mesh_from_config(config, device=None):
    """The training mesh of the ``parallel`` section, or None.

      parallel:
        mesh: {data: -1}             # data parallel over every rank
        mesh: {data: -1, model: 2}   # dp x tp
        distributed: {enabled: true} # multi-process (torchrun)

    A single process gets a world of one (a store in memory), so the
    mesh code paths run there too. Over several nodes the mesh gains the
    leading ``dcn_data`` axis, as JAX's over several processes."""
    if config is None or not (config.get("parallel", {}) or {}).get("mesh"):
        return None
    dev = _device_type(device)
    if not dist.is_initialized():
        init_distributed(config, device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1,
                                rank=0)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    spec = dict(config.get("parallel.mesh"))
    if world // max(1, local) > 1:
        return make_hybrid_mesh(spec, device_type=dev)
    names, sizes = mesh_shape_from_config(config, world)
    n = int(np.prod(sizes))
    if n != world:
        raise ValueError(f"parallel.mesh {spec} holds {n} of the {world} "
                         "ranks: every rank must be in the mesh")
    return make_mesh(axes=names, shape=sizes, device_type=dev)
