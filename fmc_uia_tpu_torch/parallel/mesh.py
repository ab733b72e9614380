"""Device meshes and batch placement (port of
``fmc_uia_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, with the JAX package's axis names (``data``,
``model``, ``pipe``, and ``dcn_data`` for one row per node). One rank is
one device. Where JAX declares a layout and lets GSPMD place the data,
here a rank takes its rows of the global batch (``shard_batch``: the
batch axes ``(dcn_data, data)`` flattened, in that order, as
``batch_sharding`` orders them) and parameters are broadcast from rank 0
(``replicate``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fmc_uia_tpu_torch.parallel import comm

BATCH_AXES = ("dcn_data", "data")
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], object] = {}


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself, or a TypeError when it is not a DeviceMesh."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh must be a torch DeviceMesh (make_mesh, "
                        f"mesh_from_config), got {type(mesh).__name__}")
    return mesh


def make_mesh(devices: Optional[Sequence[int]] = None,
              axes: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over ``devices`` (global ranks; default: every rank of the
    default process group). ``device_type`` defaults to ``cuda`` under
    NCCL, ``cpu`` otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(init_distributed or parallel.launch)")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh shape {tuple(shape)} does not hold "
                         f"{len(ranks)} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=tuple(axes))


def axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return int(mesh.shape[names.index(name)]) if name in names else 1


def axis_group(mesh, names, fresh: bool = False) -> Optional[object]:
    """The process group of this rank along ``names`` (one axis or a
    tuple, flattened in that order); None when no axis is in the mesh.
    ``fresh``: a new group over the same ranks (its collectives never
    interleave with another group's); every rank must ask for it."""
    if mesh is None:
        return None
    names = (names,) if isinstance(names, str) else tuple(names)
    present = tuple(n for n in names if n in (mesh.mesh_dim_names or ()))
    if not present:
        return None
    if len(present) == 1 and not fresh:
        return mesh.get_group(present[0])
    key = (id(mesh), present)
    if fresh or key not in _GROUPS:
        dims = [mesh.mesh_dim_names.index(n) for n in present]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(
            -1, int(np.prod([mesh.shape[d] for d in dims])))
        mine = None
        for row in rows.tolist():  # every rank makes every group, in order
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        if fresh:
            return mine
        _GROUPS[key] = mine
    return _GROUPS[key]


def resolve_group(mesh_or_group, axis: str):
    """The process group of ``axis`` in a DeviceMesh, or the group given."""
    if mesh_or_group is None or not hasattr(mesh_or_group,
                                            "mesh_dim_names"):
        return mesh_or_group
    return axis_group(mesh_or_group, axis)


def batch_index(mesh) -> Tuple[int, int]:
    """(this rank's index, count) along the batch axes."""
    g = axis_group(mesh, BATCH_AXES)
    return comm.group_rank(g), comm.group_size(g)


def batch_rows(n: int, mesh) -> Tuple[int, int, int]:
    """(start, stop, n): this rank's rows of an ``n``-row global batch."""
    i, k = batch_index(mesh)
    if n % k:
        raise ValueError(f"global batch of {n} rows does not divide over "
                         f"the {k} ranks of the batch axes {BATCH_AXES}")
    m = n // k
    return i * m, (i + 1) * m, n


def batch_sharding(mesh, data_axis: str = "data"):
    """The batch axes a batch is split over, in flattening order (the
    counterpart of JAX's ``P(("dcn_data", "data"))``)."""
    names = mesh.mesh_dim_names or ()
    return tuple(n for n in ("dcn_data", data_axis) if n in names)


def replicated_sharding(mesh):
    """No axis: every rank holds the whole value."""
    return ()


def shard_batch(batch: Dict, mesh, data_axis: str = "data") -> Dict:
    """This rank's rows of a global batch dict (arrays and tensors with a
    leading batch dim; scalars and strings as they are), with ``rows`` =
    (start, stop, global rows). A batch that already carries ``rows``
    passes through."""
    if "rows" in batch:
        return batch
    n = len(batch["image"])
    start, stop, total = batch_rows(n, mesh)
    out = {}
    for k, v in batch.items():
        if (isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1
                and v.shape[0] == n):
            out[k] = v[start:stop]
        else:
            out[k] = v
    out["rows"] = (start, stop, total)
    return out


def replicate(tensors, mesh=None) -> None:
    """Broadcast ``tensors`` (a module's parameters and buffers, or a list
    of tensors) from global rank 0 to every rank, in place."""
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    group = dist.group.WORLD
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            comm.broadcast_(flat, 0, group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))
