"""Ragged expert parallelism: capacity-based token dispatch with
``all_to_all`` (port of ``fmc_uia_tpu/parallel/expert.py``).

Each rank of the expert axis hosts ``E / D`` experts. The group's tokens
(the same rows on every rank of the axis, as the ``model`` axis
replicates the batch) are split ``B / D`` a rank; each token goes to the
ranks owning its top-k experts with one ``all_to_all_single`` and comes
back with another, and each expert processes only the tokens routed to
it. The result is gathered, so every rank of the axis holds all ``B``
rows again.

Capacity (GShard): each expert takes at most ``capacity`` tokens per
source rank, slots filled first choices first, then second choices;
overflow tokens are dropped from the expert path (zero output). With
``capacity >= local_tokens * top_k`` nothing overflows and the result
equals the dense compute (``dense_moe_reference``).

A "token" is what one routing decision covers: for the conv MoE a whole
[H, W, C] feature map. Trailing dims are flattened around the expert
function.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from fmc_uia_tpu_torch.parallel import comm
from fmc_uia_tpu_torch.parallel.mesh import resolve_group


def default_capacity(local_tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float = 2.0) -> int:
    """Per-(expert, source rank) capacity; ``capacity >= local_tokens *
    top_k`` guarantees zero drops."""
    return max(1, math.ceil(local_tokens * top_k * capacity_factor
                            / num_experts))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of each row's k largest, ties to the lower index
    as ``jax.lax.top_k`` breaks them."""
    idx = torch.sort(probs, dim=1, descending=True, stable=True).indices
    idx = idx[:, :k]
    return probs.gather(1, idx), idx


def _dispatch_tensors(probs: torch.Tensor, top_k: int, capacity: int):
    """dispatch [b, E, cap] 0/1 and combine [b, E, cap] gate-weighted for
    ``probs`` [b, E]; both zero for overflow tokens."""
    b, E = probs.shape
    gates, idx = _top_k(probs, top_k)
    gates = gates / (gates.sum(dim=1, keepdim=True) + 1e-9)
    # choices in slot-priority order: every token's 1st, then 2nd, ...
    flat_idx = idx.t().reshape(-1)
    flat_gate = gates.t().reshape(-1)
    onehot = F.one_hot(flat_idx, E).float()  # [k*b, E]
    pos = ((torch.cumsum(onehot, dim=0) - 1.0) * onehot).sum(dim=1)
    keep = pos < capacity
    slot = torch.where(keep, pos, torch.full_like(pos, -1.0)).long()
    slot_oh = F.one_hot(slot.clamp_min(0), capacity).float() \
        * keep.float()[:, None]
    disp_flat = onehot[:, :, None] * slot_oh[:, None, :]
    comb_flat = disp_flat * flat_gate[:, None, None]
    disp = disp_flat.reshape(top_k, b, E, capacity).sum(0)
    comb = comb_flat.reshape(top_k, b, E, capacity).sum(0)
    return disp, comb


def ragged_moe_apply(expert_fn: Callable, expert_params: Dict, x, probs,
                     mesh, axis: str = "model", top_k: int = 1,
                     capacity_factor: float = 2.0):
    """Expert-parallel MoE layer with ``all_to_all`` token dispatch.

    Args:
      expert_fn: ``(params_e, tokens) -> tokens`` for one expert on a
        ``[n, ...]`` batch of tokens (same shape out).
      expert_params: {name: tensor with leading dim E}, whole on every
        rank of the axis; rank d runs experts ``d*E/D:(d+1)*E/D``.
      x: ``[B, ...]`` tokens, the same on every rank of the axis.
      probs: ``[B, E]`` routing probabilities (before the top-k).
      mesh: a DeviceMesh holding ``axis`` (or that axis's process group).

    Returns ``[B, ...]`` combined expert outputs on every rank (overflow
    tokens -> zeros; add the residual outside). Differentiable.
    """
    group = resolve_group(mesh, axis)
    if group is None:
        raise ValueError(f"ragged_moe_apply needs a mesh with axis "
                         f"{axis!r} (got mesh={mesh})")
    D = comm.group_size(group)
    E = probs.shape[-1]
    if E % D:
        raise ValueError(f"num_experts {E} must divide over mesh axis "
                         f"{axis!r} of size {D}")
    B = x.shape[0]
    if B % D:
        raise ValueError(f"batch {B} must shard over {axis!r} size {D}")
    Eloc, bloc = E // D, B // D
    cap = default_capacity(bloc, E, top_k, capacity_factor)
    token_shape = tuple(x.shape[1:])
    Fdim = int(math.prod(token_shape)) if token_shape else 1

    xb = comm.slice_dim(x, 0, group)
    pb = comm.slice_dim(probs, 0, group)
    disp, comb = _dispatch_tensors(pb.float(), top_k, cap)
    xf = xb.reshape(bloc, Fdim)
    expert_in = torch.einsum("bec,bf->ecf", disp.to(xf.dtype), xf)
    # slots to the ranks owning each expert: [D(source), Eloc, cap, F]
    t = comm.all_to_all(expert_in.reshape(D, Eloc, cap, Fdim), group)
    t = t.transpose(0, 1).reshape(Eloc, D * cap, *token_shape)
    local = {k: comm.slice_dim(v, 0, group) for k, v in
             expert_params.items()}
    out = torch.stack([expert_fn({k: v[e] for k, v in local.items()}, t[e])
                       for e in range(Eloc)])
    out = out.reshape(Eloc, D, cap, Fdim).transpose(0, 1)
    out = comm.all_to_all(out.contiguous(), group).reshape(E, cap, Fdim)
    yf = torch.einsum("bec,ecf->bf", comb.to(out.dtype), out)
    return comm.gather_dim(yf.reshape(bloc, *token_shape), 0, group)


def dense_moe_reference(expert_fn: Callable, expert_params: Dict, x, probs,
                        top_k: int = 1):
    """Every expert on every token, combined by the renormalised top-k
    gates (the dense ``MoEConvBlock`` semantics)."""
    E = probs.shape[-1]
    gates, idx = _top_k(probs, top_k)
    gates = gates / (gates.sum(dim=1, keepdim=True) + 1e-9)
    w = torch.zeros_like(probs)
    for j in range(top_k):
        w = w + F.one_hot(idx[:, j], E).to(probs.dtype) * gates[:, j:j + 1]
    outs = torch.stack([expert_fn({k: v[e] for k, v in
                                   expert_params.items()}, x)
                        for e in range(E)])
    w_t = w.t().reshape((E, x.shape[0]) + (1,) * (x.dim() - 1))
    return (outs * w_t.to(outs.dtype)).sum(0)
