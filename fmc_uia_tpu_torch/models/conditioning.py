"""Task conditioning (port of ``fmc_uia_tpu/models/conditioning.py``).

Ported: ``TaskFiLM`` (banked per-task gamma/beta gathered by the global
task index, applied as ``gamma * x + beta`` over channels) and the dense
dispatch of ``MoEConvBlock`` (per-sample routing over conv experts). The
other conditioning modules, and the MoE's ragged expert-parallel dispatch,
raise and name their ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.layers import Conv, Dense, dropout, take

_NOT_PORTED = ("{what} is not ported to fmc_uia_tpu_torch yet (ROADMAP.md, "
               "port queue item 'Off-main-path heads and conditioning')")
_RAGGED = ("model.moe.dispatch 'ragged' (expert-parallel all_to_all "
           "dispatch) needs an expert-parallel device mesh: not ported to "
           "fmc_uia_tpu_torch yet (ROADMAP.md, port queue 1 item 9, "
           "'Parallel modes')")
# the profiler range of an MoE block's forward (chip_smoke.py reads it)
MOE_RANGE = "moe_block"


class TaskFiLM(nn.Module):
    def __init__(self, num_tasks: int, num_features: int,
                 use_affine: bool = True):
        super().__init__()
        self.gammas = nn.Parameter(torch.ones(num_tasks, num_features))
        self.betas = (nn.Parameter(torch.zeros(num_tasks, num_features))
                      if use_affine else None)

    def forward(self, x, task_index):
        out = x * take(self.gammas, task_index).to(x.dtype)
        if self.betas is not None:
            out = out + take(self.betas, task_index).to(x.dtype)
        return out


def build_film(config, num_tasks: int, num_features: int
               ) -> Optional[nn.Module]:
    if not config.get("model.use_film", False):
        return None
    film_cfg = config.get("model.film", {}) or {}
    if film_cfg.get("use_task_embedding", False):
        raise NotImplementedError(_NOT_PORTED.format(
            what="TaskEmbeddingFiLM (model.film.use_task_embedding)"))
    if film_cfg.get("multi_stage", False):
        raise NotImplementedError(_NOT_PORTED.format(
            what="MultiFiLM (model.film.multi_stage)"))
    return TaskFiLM(num_tasks, num_features,
                    use_affine=bool(film_cfg.get("use_affine", True)))


def check_unported(config) -> None:
    """Raise on conditioning the JAX model would build but the port lacks."""
    if (config.get("model.task_prompt", {}) or {}).get("enabled", False):
        raise NotImplementedError(_NOT_PORTED.format(
            what="TaskPrompt2D (model.task_prompt.enabled)"))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def top_k_dispatch(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The 0/1 mask [B, E] of each row's ``k`` largest probabilities, a
    tie going to the lower expert index as ``jax.lax.top_k`` breaks it
    (``torch.topk`` promises no order on CUDA): a stable descending sort
    keeps equal values in index order."""
    idx = torch.sort(probs, dim=1, descending=True, stable=True).indices
    return torch.zeros_like(probs).scatter_(1, idx[:, :k], 1.0)


class MoEConvBlock(nn.Module):
    """Mixture of conv experts with per-sample routing, dense dispatch.

    Router: the spatial mean of ``x`` (rounded to ``x``'s dtype, as
    ``jnp.mean`` returns it, then f32), with the task embedding appended,
    -> Dense -> ReLU -> Dense -> softmax over E (f32); top-k renormalised
    (``+ 1e-9``) when k < E. Experts, all E on every sample, with the
    expert axis folded into channels: a 1x1 conv C -> E·h, ReLU, a full
    3x3 conv h -> h per expert (grouped by E), ReLU, channel dropout, a
    1x1 conv h -> C per expert (grouped by E); the E outputs summed with
    the gates in f32 and rounded once, plus the residual. Parameter names
    and layouts follow the JAX tree (``task_embed`` [T, D],
    ``router_fc{1,2}``, ``expert_{in,mid,out}`` with no bias).

    ``forward`` returns ``(out, aux, {"importance", "load"})``: the
    balance loss ``E · Σ importance · load`` and the per-expert mean
    renormalised gate and mean 0/1 dispatch over the batch, as device
    tensors.
    """

    def __init__(self, channels: int, num_experts: int = 4,
                 expert_hidden: Optional[int] = None,
                 router_hidden: Optional[int] = None, top_k: int = 1,
                 use_task_embedding: bool = False,
                 task_embedding_dim: int = 32, num_tasks: int = 0,
                 use_residual: bool = True, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        C, E = channels, num_experts
        h = expert_hidden or max(8, C // 2)
        self.num_experts, self.top_k = E, int(top_k)
        self.use_residual = use_residual
        self.dropout = float(dropout)
        self.dtype = dtype
        self.task_embed = (nn.Parameter(torch.zeros(num_tasks,
                                                    task_embedding_dim))
                           if use_task_embedding else None)
        rin = C + (task_embedding_dim if use_task_embedding else 0)
        rh = router_hidden or max(16, rin // 2)
        self.router_fc1 = Dense(rin, rh)
        self.router_fc2 = Dense(rh, E)
        self.expert_in = Conv(C, E * h, 1, use_bias=False, dtype=dtype)
        self.expert_mid = Conv(E * h, E * h, 3, use_bias=False, groups=E,
                               dtype=dtype)
        self.expert_out = Conv(E * h, E * C, 1, use_bias=False, groups=E,
                               dtype=dtype)

    def _init(self, g):
        if self.task_embed is not None:
            with torch.no_grad():
                self.task_embed.normal_(0.0, 1.0, generator=g)

    def gate_probs(self, x: torch.Tensor, task_index=None) -> torch.Tensor:
        """The router's softmax over E, [B, E] f32, before the top-k."""
        B = x.shape[0]
        pooled = x.float().mean(dim=(1, 2)).to(x.dtype).float()
        router_in = pooled
        if self.task_embed is not None:
            if task_index is None:
                raise ValueError("task_index required when use_task_embedding")
            emb = take(self.task_embed, torch.as_tensor(
                task_index, dtype=torch.long, device=x.device))
            router_in = torch.cat(
                [pooled, emb.expand(B, emb.shape[-1])], dim=1)
        logits = self.router_fc2(F.relu(self.router_fc1(router_in)))
        return torch.softmax(logits, dim=1)

    def route(self, x: torch.Tensor, task_index=None):
        """Renormalised gates and the 0/1 dispatch, both [B, E] f32."""
        probs = self.gate_probs(x, task_index)
        if self.top_k < self.num_experts:
            dispatch = top_k_dispatch(probs, self.top_k)
            masked = probs * dispatch
            probs = masked / (masked.sum(dim=1, keepdim=True) + 1e-9)
        else:
            dispatch = torch.ones_like(probs)
        return probs, dispatch

    def forward(self, x: torch.Tensor, task_index=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.profiler.record_function(MOE_RANGE):
            B, H, W, C = x.shape
            E = self.num_experts
            probs, dispatch = self.route(x, task_index)
            importance = probs.mean(dim=0)
            load = dispatch.mean(dim=0)
            aux = E * (importance * load).sum()

            h = F.relu(self.expert_in(x))
            h = F.relu(self.expert_mid(h))
            h = dropout(h, self.dropout, train, generator,
                        broadcast_dims=(1, 2))
            h = self.expert_out(h).reshape(B, H, W, E, C)
            # gates rounded to h's dtype; the E products summed in f32
            gates = probs.to(h.dtype).float()
            out = torch.einsum("bhwec,be->bhwc", h.float(), gates).to(h.dtype)
            if self.use_residual:
                out = out + x
        return out, aux, {"importance": importance, "load": load}


def build_moe_blocks(config, num_tasks: int, channels: Sequence[int],
                     dtype=torch.float32) -> Dict[int, MoEConvBlock]:
    """``model.moe``: one block per stage index within the encoder's stage
    count (``stage_indices``, default every stage), {} when off. Dispatch
    ``dense`` and ``auto`` (dense: the port has no expert-parallel
    mesh) build; ``ragged`` raises."""
    moe_cfg = config.get("model.moe", {}) or {}
    if not moe_cfg.get("enabled", False):
        return {}
    E = int(moe_cfg.get("num_experts", 4))
    top_k = int(moe_cfg.get("top_k", 1))
    mode = str(moe_cfg.get("dispatch", "dense"))
    if mode == "auto":  # the JAX rule picks ragged only on an EP mesh
        mode = "dense"
    if mode == "ragged":
        raise NotImplementedError(_RAGGED)
    if mode != "dense":
        raise ValueError(f"unknown model.moe.dispatch {mode!r}")
    expert_hidden = moe_cfg.get("expert_hidden")
    router_hidden = moe_cfg.get("router_hidden")
    stages = moe_cfg.get("stage_indices") or range(4)
    return {i: MoEConvBlock(
        channels[i], num_experts=E,
        expert_hidden=int(expert_hidden) if expert_hidden else None,
        router_hidden=int(router_hidden) if router_hidden else None,
        top_k=top_k,
        use_task_embedding=bool(moe_cfg.get("use_task_embedding", True)),
        task_embedding_dim=int(moe_cfg.get("task_embedding_dim", 32)),
        num_tasks=num_tasks,
        use_residual=bool(moe_cfg.get("use_residual", True)),
        dropout=float(moe_cfg.get("dropout", 0.0)), dtype=dtype)
        for i in stages if 0 <= i < len(channels)}
