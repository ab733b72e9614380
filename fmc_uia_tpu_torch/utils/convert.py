"""Weight bridge: fill the port's parameters from the JAX package's
``params`` tree (nested dicts of numpy arrays).

The port names its parameters by the JAX paths (``encoder.stage0_block1.
attn.qkv.kernel`` <-> ``encoder/stage0_block1/attn/qkv/kernel``), so the
bridge only has to

  * unstack scanned stages: ``stage{s}_scan/block{j}`` leaves carry a
    leading ``[n_pairs]`` axis, and pair ``p`` goes to block ``2p + j``
    (an unrolled stage arrives as ``stage{s}_block{b}`` already);
  * re-lay ``kernel`` leaves, by rank: dense ``[in, out]`` -> ``[out, in]``,
    banked dense ``[T, in, out]`` -> ``[T, out, in]``, conv HWIO -> OIHW,
    banked conv ``[T, kh, kw, I, O]`` -> ``[T, O, I, kh, kw]``.

It raises on any leaf left unmatched on either side, and on a shape
mismatch.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_SCAN = re.compile(r"^(.*)stage(\d+)_scan/block([01])/(.*)$")
_KERNEL_PERM = {2: (1, 0), 3: (0, 2, 1), 4: (3, 2, 0, 1), 5: (0, 4, 3, 1, 2)}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def jax_leaves_to_port(tree: Mapping) -> Dict[str, np.ndarray]:
    """The JAX tree as ``{port parameter name: array in port layout}``."""
    leaves = {}
    for path, arr in _flatten(tree).items():
        m = _SCAN.match(path)
        if m:
            pre, s, j, rest = m.groups()
            parts = [(f"{pre}stage{s}_block{2 * p + int(j)}/{rest}", arr[p])
                     for p in range(arr.shape[0])]
        else:
            parts = [(path, arr)]
        for name, a in parts:
            if name.rsplit("/", 1)[-1] == "kernel":
                a = np.transpose(a, _KERNEL_PERM[a.ndim])
            key = name.replace("/", ".")
            if key in leaves:
                raise ValueError(f"two JAX leaves map to {key!r}")
            leaves[key] = np.ascontiguousarray(a, np.float32)
    return leaves


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy every leaf of the JAX ``params`` tree into ``model``."""
    leaves = jax_leaves_to_port(tree)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"JAX tree does not match the port: port params "
                         f"without a JAX leaf {missing[:8]} "
                         f"({len(missing)}), JAX leaves without a port "
                         f"param {extra[:8]} ({len(extra)})")
    with torch.no_grad():
        for name, p in params.items():
            a = leaves[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {a.shape} != port "
                                 f"shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a))
