"""Task conditioning (port of ``fmc_uia_tpu/models/conditioning.py``).

Only ``TaskFiLM`` is ported: banked per-task gamma/beta gathered by the
global task index, applied as ``gamma * x + beta`` over channels. The
other conditioning modules raise and name their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fmc_uia_tpu_torch.models.layers import take

_NOT_PORTED = ("{what} is not ported to fmc_uia_tpu_torch yet (ROADMAP.md, "
               "port queue item 'Off-main-path heads and conditioning')")


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
    if (config.get("model.moe", {}) or {}).get("enabled", False):
        raise NotImplementedError(_NOT_PORTED.format(
            what="MoEConvBlock (model.moe.enabled)"))
    if (config.get("model.task_prompt", {}) or {}).get("enabled", False):
        raise NotImplementedError(_NOT_PORTED.format(
            what="TaskPrompt2D (model.task_prompt.enabled)"))
