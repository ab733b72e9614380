"""Task conditioning (port of ``fmc_uia_tpu/models/conditioning.py``).

  * ``TaskFiLM``: banked per-task gamma/beta gathered by the global task
    index, applied as ``gamma * x + beta`` over channels;
    ``TaskEmbeddingFiLM``: a task embedding (N(0, 1)) through two-layer
    gamma and beta MLPs; ``MultiFiLM``: one of either per encoder stage.
  * ``TaskPrompt2D``: a static multi-hot task-metadata table (task type,
    class-count tag, task-id tokens; sorted vocabularies) -> linear ->
    a low-res prompt -> tanh -> bilinear resize to the input -> times
    ``prompt_scale`` -> added to or multiplied into the input.
  * ``MoEConvBlock``: per-sample routing over conv experts, dense (every
    expert on every sample) or ragged (``parallel/expert.py``: the
    experts split over the mesh's expert axis, tokens dispatched with
    ``all_to_all``); ``auto`` picks as ``pick_dispatch_mode`` does. The
    mesh is the one a Trainer or an evaluation installs around its steps
    (``parallel/activation.py``), so the dispatch is a pure execution
    choice: the parameters are the same grouped layouts either way.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.encoders.adapters import (
    resize_linear_antialias,
)
from fmc_uia_tpu_torch.models.layers import (
    Conv,
    Dense,
    apply_dropout,
    conv_nhwc,
    dropout,
    keep_mask,
    resize_to,
    take,
)
from fmc_uia_tpu_torch.parallel import comm
from fmc_uia_tpu_torch.parallel.activation import activation_mesh
from fmc_uia_tpu_torch.parallel.expert import ragged_moe_apply
from fmc_uia_tpu_torch.parallel.mesh import axis_size
from fmc_uia_tpu_torch.parallel.sharding import tp_shard

_DISPATCH_MODES = ("dense", "ragged", "auto")
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


class TaskEmbeddingFiLM(nn.Module):
    """Task embedding [T, D] -> ``gamma_fc1/2`` and ``beta_fc1/2`` (Dense,
    ReLU, Dense, in f32) -> ``gamma * x + beta`` in x's dtype."""

    def __init__(self, num_tasks: int, num_features: int,
                 embedding_dim: int = 64, use_affine: bool = True):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_tasks, embedding_dim))
        self.gamma_fc1 = Dense(embedding_dim, num_features)
        self.gamma_fc2 = Dense(num_features, num_features)
        self.use_affine = use_affine
        if use_affine:
            self.beta_fc1 = Dense(embedding_dim, num_features)
            self.beta_fc2 = Dense(num_features, num_features)

    def _init(self, g):
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0, generator=g)

    def _mlp(self, emb, name):
        h = F.relu(getattr(self, f"{name}_fc1")(emb))
        return getattr(self, f"{name}_fc2")(h)

    def forward(self, x, task_index):
        emb = take(self.embedding, task_index)
        out = x * self._mlp(emb, "gamma").to(x.dtype)
        if self.use_affine:
            out = out + self._mlp(emb, "beta").to(x.dtype)
        return out


class MultiFiLM(nn.Module):
    """One FiLM (``TaskFiLM`` or ``TaskEmbeddingFiLM``), ``stage{i}``, per
    encoder stage, over that stage's channels."""

    def __init__(self, num_tasks: int, feature_channels: Sequence[int],
                 use_affine: bool = True, use_embedding: bool = False,
                 embedding_dim: int = 64):
        super().__init__()
        self.n = len(feature_channels)
        for i, ch in enumerate(feature_channels):
            self.add_module(f"stage{i}", TaskEmbeddingFiLM(
                num_tasks, ch, embedding_dim, use_affine) if use_embedding
                else TaskFiLM(num_tasks, ch, use_affine))

    def forward(self, features, task_index):
        if len(features) != self.n:
            raise ValueError(f"MultiFiLM configured for {self.n} stages, "
                             f"got {len(features)} features")
        return [getattr(self, f"stage{i}")(f, task_index)
                for i, f in enumerate(features)]


def build_film(config, num_tasks: int, num_features: int
               ) -> Optional[nn.Module]:
    """``model.use_film``: the FPN's FiLM (``TaskEmbeddingFiLM`` under
    ``model.film.use_task_embedding``, else ``TaskFiLM``), None when
    off."""
    if not config.get("model.use_film", False):
        return None
    film_cfg = config.get("model.film", {}) or {}
    use_affine = bool(film_cfg.get("use_affine", True))
    if film_cfg.get("use_task_embedding", False):
        return TaskEmbeddingFiLM(
            num_tasks, num_features,
            embedding_dim=int(film_cfg.get("embedding_dim", 64)),
            use_affine=use_affine)
    return TaskFiLM(num_tasks, num_features, use_affine=use_affine)


def build_multi_film(config, num_tasks: int, channels: Sequence[int]
                     ) -> Optional[MultiFiLM]:
    """``model.film.multi_stage`` (with ``model.use_film``): a FiLM per
    encoder stage, after the MoE blocks; None when off."""
    film_cfg = config.get("model.film", {}) or {}
    if not (config.get("model.use_film", False)
            and film_cfg.get("multi_stage", False)):
        return None
    return MultiFiLM(num_tasks, tuple(channels),
                     use_affine=bool(film_cfg.get("use_affine", True)),
                     use_embedding=bool(film_cfg.get("use_task_embedding",
                                                     False)),
                     embedding_dim=int(film_cfg.get("embedding_dim", 64)))


# --------------------------------------------------------------------------
# TaskPrompt2D
# --------------------------------------------------------------------------
_TASK_PREFIX_RE = re.compile(r"^t\d+[a-z]?$", re.IGNORECASE)


def _tokenize_task_id(task_id: str) -> List[str]:
    """task_id split on '_', lower case, the Tn[a-z] challenge prefix
    dropped."""
    parts = [p.strip().lower() for p in str(task_id).split("_") if p.strip()]
    return [p for p in parts if not _TASK_PREFIX_RE.match(p)]


def build_task_prompt_metadata(task_configs: Sequence[Dict]
                               ) -> Tuple[np.ndarray, Dict[str, int],
                                          Dict[str, List[str]]]:
    """The multi-hot [num_tasks, D] f32 metadata table (task-type one-hot,
    ``num_classes_<n>`` tag one-hot, task-id token multi-hot; each
    vocabulary sorted), the task-id -> row map and the vocabularies."""
    task_ids = [str(c["task_id"]) for c in task_configs]
    names = [str(c.get("task_name", "unknown")).lower() for c in task_configs]
    class_tags = [f"num_classes_{int(c.get('num_classes', -1))}"
                  for c in task_configs]
    token_sets = [_tokenize_task_id(t) for t in task_ids]
    type_vocab = sorted(set(names))
    class_vocab = sorted(set(class_tags))
    token_vocab = sorted({tok for toks in token_sets for tok in toks})
    type_to_i = {v: i for i, v in enumerate(type_vocab)}
    class_to_i = {v: i for i, v in enumerate(class_vocab)}
    token_to_i = {v: i for i, v in enumerate(token_vocab)}
    n_type, n_class = len(type_vocab), len(class_vocab)
    table = np.zeros((len(task_ids), n_type + n_class + len(token_vocab)),
                     np.float32)
    for row, (name, tag, toks) in enumerate(zip(names, class_tags,
                                                token_sets)):
        table[row, type_to_i[name]] = 1.0
        table[row, n_type + class_to_i[tag]] = 1.0
        for tok in toks:
            table[row, n_type + n_class + token_to_i[tok]] = 1.0
    vocab = {"task_types": type_vocab, "num_classes_tags": class_vocab,
             "task_tokens": token_vocab}
    return table, {t: i for i, t in enumerate(task_ids)}, vocab


class TaskPrompt2D(nn.Module):
    """The task's metadata row -> ``prompt_proj`` (Dense, f32) -> a
    [prompt_size, prompt_size, channels] prompt -> tanh -> bilinear
    resize to the input (``jax.image.resize``: plain bilinear on an
    upsample, antialiased on a shrink) -> times ``prompt_scale`` (an f32
    scalar parameter), rounded to x's dtype -> ``x + p`` ('add') or
    ``x * (1 + p)`` ('mul'). One channel broadcasts over the image's
    three."""

    def __init__(self, metadata_table: np.ndarray, out_channels: int = 1,
                 prompt_size: int = 32, inject_mode: str = "add",
                 init_scale: float = 0.1, use_tanh: bool = True):
        super().__init__()
        self.register_buffer("metadata_table", torch.as_tensor(
            np.asarray(metadata_table, np.float32)), persistent=False)
        self.out_channels, self.prompt_size = out_channels, prompt_size
        self.inject_mode, self.use_tanh = inject_mode, use_tanh
        self.prompt_proj = Dense(metadata_table.shape[1],
                                 out_channels * prompt_size * prompt_size)
        self.prompt_scale = nn.Parameter(torch.tensor(float(init_scale)))

    def forward(self, x, task_index):
        P = self.prompt_size
        prompt = self.prompt_proj(take(self.metadata_table, task_index))
        prompt = prompt.reshape(1, P, P, self.out_channels)
        if self.use_tanh:
            prompt = torch.tanh(prompt)
        H, W = x.shape[1:3]
        if H >= P and W >= P:
            prompt = resize_to(prompt, H, W)
        else:
            prompt = resize_linear_antialias(prompt, H, W)
        prompt = (self.prompt_scale * prompt).to(x.dtype)
        if self.inject_mode == "add":
            return x + prompt
        return x * (1.0 + prompt)


def build_task_prompt(config, task_configs) -> Optional[TaskPrompt2D]:
    """``model.task_prompt``: the prompt module, None when off."""
    cfg = config.get("model.task_prompt", {}) or {}
    if not cfg.get("enabled", False):
        return None
    table, _, _ = build_task_prompt_metadata(task_configs)
    mode = str(cfg.get("inject_mode", "add")).lower()
    if mode not in ("add", "mul"):
        raise ValueError(f"Unsupported inject_mode: {mode}")
    return TaskPrompt2D(table, out_channels=int(cfg.get("channels", 1)),
                        prompt_size=int(cfg.get("prompt_size", 32)),
                        inject_mode=mode,
                        init_scale=float(cfg.get("init_scale", 0.1)),
                        use_tanh=bool(cfg.get("use_tanh", True)))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def pick_dispatch_mode(num_experts: int, top_k: int, ep_mesh,
                       ep_axis: str) -> str:
    """``model.moe.dispatch: auto`` resolved, as the JAX rule: ragged only
    when the experts are really distributed (an EP mesh with more than
    one rank on ``ep_axis``, E dividing it) and E is large (>= max(32,
    8 top_k)); dense otherwise (the E-fold dense compute is cheaper than
    the dispatch at a few conv experts)."""
    if ep_mesh is None or ep_axis not in (ep_mesh.mesh_dim_names or ()):
        return "dense"
    size = axis_size(ep_mesh, ep_axis)
    if size <= 1 or num_experts % size:
        return "dense"
    if num_experts >= max(32, 8 * max(1, top_k)):
        return "ragged"
    return "dense"


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
    renormalised gate and mean 0/1 dispatch over the (global, under a
    mesh) batch, as device tensors.

    ``dispatch``: ``dense``, ``ragged`` (the experts over ``ep_axis`` of
    the installed mesh, ``capacity_factor`` slots; dropout on the
    combined output, as in JAX) or ``auto``. Under tensor parallelism
    with ``expert_in`` sharded by experts, the dense path runs each
    rank's experts only and sums the ranks' outputs with one all-reduce.
    """

    def __init__(self, channels: int, num_experts: int = 4,
                 expert_hidden: Optional[int] = None,
                 router_hidden: Optional[int] = None, top_k: int = 1,
                 use_task_embedding: bool = False,
                 task_embedding_dim: int = 32, num_tasks: int = 0,
                 use_residual: bool = True, dropout: float = 0.0,
                 dtype=torch.float32, dispatch: str = "dense",
                 ep_axis: str = "model", capacity_factor: float = 2.0):
        super().__init__()
        if dispatch not in _DISPATCH_MODES:
            raise ValueError(f"unknown model.moe.dispatch {dispatch!r}")
        C, E = channels, num_experts
        h = expert_hidden or max(8, C // 2)
        self.hidden = h
        self.dispatch, self.ep_axis = dispatch, ep_axis
        self.capacity_factor = float(capacity_factor)
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

    def route(self, x: torch.Tensor, task_index=None, probs=None):
        """Renormalised gates and the 0/1 dispatch, both [B, E] f32."""
        if probs is None:
            probs = self.gate_probs(x, task_index)
        if self.top_k < self.num_experts:
            dispatch = top_k_dispatch(probs, self.top_k)
            masked = probs * dispatch
            probs = masked / (masked.sum(dim=1, keepdim=True) + 1e-9)
        else:
            dispatch = torch.ones_like(probs)
        return probs, dispatch

    def _mode(self) -> str:
        if self.dispatch == "auto":
            return pick_dispatch_mode(self.num_experts, self.top_k,
                                      activation_mesh(), self.ep_axis)
        return self.dispatch

    def _expert_weights(self):
        """The grouped kernels as per-expert stacks [E, ...] (OIHW), in the
        compute dtype: expert e owns output channels e*g:(e+1)*g."""
        E, h, C = self.num_experts, self.hidden, self.expert_out.kernel.shape[
            0] // self.num_experts
        dt = self.dtype
        return {
            "w_in": self.expert_in.kernel.to(dt).reshape(E, h, C, 1, 1),
            "w_mid": self.expert_mid.kernel.to(dt).reshape(E, h, h, 3, 3),
            "w_out": self.expert_out.kernel.to(dt).reshape(E, C, h, 1, 1)}

    def _ragged(self, x, raw_probs, train, generator):
        mesh = activation_mesh()
        if mesh is None or self.ep_axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(
                "MoEConvBlock(dispatch_mode='ragged') needs ep_mesh with "
                f"axis {self.ep_axis!r} (got mesh={mesh})")

        def expert_fn(p, tokens):
            y = F.relu(conv_nhwc(tokens, p["w_in"]))
            y = F.relu(conv_nhwc(y, p["w_mid"]))
            return conv_nhwc(y, p["w_out"])

        out = ragged_moe_apply(
            expert_fn, self._expert_weights(), x.to(self.dtype),
            raw_probs.float(), mesh, axis=self.ep_axis, top_k=self.top_k,
            capacity_factor=self.capacity_factor)
        return dropout(out, self.dropout, train, generator,
                       broadcast_dims=(1, 2))

    def _dense_split(self, x, probs, train, generator):
        """The dense path on this rank's experts (``expert_in`` sharded by
        experts over the model axis), the ranks' sums all-reduced."""
        shard = tp_shard(self.expert_in)
        if shard is None or shard[1] != 0:
            return None
        group = shard[2]
        M = comm.group_size(group)
        E, h = self.num_experts, self.hidden
        if E % M:
            return None
        B, H, W, C = x.shape
        El, dt = E // M, self.dtype
        xs = comm.copy_sum_grad(x.to(dt), group)
        y = F.relu(conv_nhwc(xs, shard[0].to(dt)))
        w_mid = comm.slice_dim(self.expert_mid.kernel, 0, group)
        y = F.relu(conv_nhwc(y, w_mid.to(dt), groups=El))
        if train and self.dropout > 0.0:
            full = keep_mask((B, 1, 1, E * h), 1.0 - self.dropout,
                             generator, x.device)
            m = full.narrow(3, comm.group_rank(group) * El * h, El * h)
            y = apply_dropout(y, m, self.dropout)
        w_out = comm.slice_dim(self.expert_out.kernel, 0, group)
        y = conv_nhwc(y, w_out.to(dt), groups=El).reshape(B, H, W, El, C)
        gates = comm.slice_dim(probs, 1, group).to(y.dtype).float()
        part = torch.einsum("bhwec,be->bhwc", y.float(), gates)
        return comm.sum_pass(part, group).to(y.dtype)

    def forward(self, x: torch.Tensor, task_index=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.profiler.record_function(MOE_RANGE):
            B, H, W, C = x.shape
            E = self.num_experts
            raw = self.gate_probs(x, task_index)
            probs, dispatch = self.route(x, probs=raw)
            importance = comm.global_mean0(probs)
            load = comm.global_mean0(dispatch)
            aux = E * (importance * load).sum()

            if self._mode() == "ragged":
                out = self._ragged(x, raw, train, generator)
            else:
                out = self._dense_split(x, probs, train, generator)
            if out is None:
                h = F.relu(self.expert_in(x))
                h = F.relu(self.expert_mid(h))
                h = dropout(h, self.dropout, train, generator,
                            broadcast_dims=(1, 2))
                h = self.expert_out(h).reshape(B, H, W, E, C)
                # gates rounded to h's dtype; the E products summed in f32
                gates = probs.to(h.dtype).float()
                out = torch.einsum("bhwec,be->bhwc", h.float(),
                                   gates).to(h.dtype)
            if self.use_residual:
                out = out + x
        return out, aux, {"importance": importance, "load": load}


def build_moe_blocks(config, num_tasks: int, channels: Sequence[int],
                     dtype=torch.float32) -> Dict[int, MoEConvBlock]:
    """``model.moe``: one block per stage index within the encoder's stage
    count (``stage_indices``, default every stage), {} when off; dispatch
    ``dense``, ``ragged`` or ``auto`` (``ep_axis``, default ``model``;
    ``capacity_factor``, default 2)."""
    moe_cfg = config.get("model.moe", {}) or {}
    if not moe_cfg.get("enabled", False):
        return {}
    E = int(moe_cfg.get("num_experts", 4))
    top_k = int(moe_cfg.get("top_k", 1))
    mode = str(moe_cfg.get("dispatch", "dense"))
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
        dropout=float(moe_cfg.get("dropout", 0.0)), dtype=dtype,
        dispatch=mode, ep_axis=str(moe_cfg.get("ep_axis", "model")),
        capacity_factor=float(moe_cfg.get("capacity_factor", 2.0)))
        for i in stages if 0 <= i < len(channels)}
