"""Task conditioning: a frozen copy of the port's
``models/conditioning.py`` without the MoE block.

  * ``TaskFiLM``: banked per-task gamma/beta gathered by the global task
    index, applied as ``gamma * x + beta`` over channels;
    ``TaskEmbeddingFiLM``: a task embedding (N(0, 1)) through two-layer
    gamma and beta MLPs; ``MultiFiLM``: one of either per encoder stage.
  * ``TaskPrompt2D``: a static multi-hot task-metadata table (task type,
    class-count tag, task-id tokens; sorted vocabularies) -> linear ->
    a low-res prompt -> tanh -> bilinear resize to the input -> times
    ``prompt_scale`` -> added to or multiplied into the input.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .adapters import (
    resize_linear_antialias,
)
from .layers import Dense, resize_to, take



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



def build_moe_blocks(config, num_tasks: int, channels: Sequence[int],
                     dtype=torch.float32) -> Dict[int, nn.Module]:
    """The reference holds no MoE block: refused when ``model.moe`` is on
    (no configuration of the benchmark turns it on)."""
    if (config.get("model.moe", {}) or {}).get("enabled", False):
        raise ValueError("the reference has no MoE block")
    return {}
