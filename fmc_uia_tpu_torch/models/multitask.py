"""Multi-task model (port of ``fmc_uia_tpu/models/multitask.py``).

Shared Swin encoder -> per-task-type FPN -> TaskFiLM -> banked head. The
task type is a Python string choosing the branch; the task index is a
tensor, mapped to the head bank's local index through the registry's
table on the device. Outputs keep the JAX layouts: seg [B, H, W, Cmax],
cls [B, Cmax], det a dict of NHWC maps, reg [B, 2P].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fmc_uia_tpu_torch.device import resolve_device
from fmc_uia_tpu_torch.models.conditioning import build_film, check_unported
from fmc_uia_tpu_torch.models.decoders import build_decoders
from fmc_uia_tpu_torch.models.encoders import build_encoder
from fmc_uia_tpu_torch.models.heads import build_head_banks
from fmc_uia_tpu_torch.models.layers import init_weights, take
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    REGRESSION,
    SEGMENTATION,
    TASK_TYPES,
    TaskRegistry,
)


class MultiTaskModel(nn.Module):
    def __init__(self, config, registry: TaskRegistry, dtype=torch.float32):
        super().__init__()
        check_unported(config)
        self.registry = registry
        self.dtype = dtype
        self.encoder = build_encoder(config, dtype=dtype)
        enc_ch = self.encoder.out_channels
        alias, decoders = build_decoders(config, enc_ch, dtype=dtype)
        self.decoder_alias = alias
        for name, mod in decoders.items():
            self.add_module(name, mod)
        self.use_fpn_for_cls = bool(
            config.get("model.decoder.use_fpn_for_classification", True))
        self.use_fpn_for_reg = bool(
            config.get("model.decoder.use_fpn_for_regression", True))
        fpn_ch = decoders["fpn_seg"].out_channels
        self.film = build_film(config, len(registry), fpn_ch)
        in_ch = {SEGMENTATION: fpn_ch, DETECTION: fpn_ch,
                 CLASSIFICATION: fpn_ch if self.use_fpn_for_cls
                 else enc_ch[-1],
                 REGRESSION: fpn_ch if self.use_fpn_for_reg else enc_ch[-1]}
        for t, bank in build_head_banks(config, registry, in_ch,
                                        dtype=dtype).items():
            self.add_module(f"head_banks_{t}", bank)
        self.register_buffer("local_index_table", torch.as_tensor(
            registry.local_index_table, dtype=torch.long), persistent=False)

    def _needs_fpn(self, task_type: str) -> bool:
        return (task_type in (SEGMENTATION, DETECTION)
                or (task_type == CLASSIFICATION and self.use_fpn_for_cls)
                or (task_type == REGRESSION and self.use_fpn_for_reg))

    def forward(self, images, task_type: str, task_index):
        """images [B, H, W, 3] normalized (NHWC); task_type one of
        TASK_TYPES; task_index the global task index (int or 0-d tensor)."""
        if task_type not in TASK_TYPES:
            raise ValueError(f"Unknown task_type: {task_type}")
        task_index = torch.as_tensor(task_index, dtype=torch.long,
                                     device=self.local_index_table.device)
        local_idx = take(self.local_index_table, task_index)
        features = self.encoder(images.to(self.dtype))
        head = getattr(self, f"head_banks_{task_type}")
        if self._needs_fpn(task_type):
            x = getattr(self, self.decoder_alias[task_type])(features)
            if self.film is not None:
                x = self.film(x, task_index)
            return head(x, local_idx)
        return head(features[-1], local_idx)


def build_model(config, registry: Optional[TaskRegistry] = None,
                dtype=None, device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> MultiTaskModel:
    """Build the model with random weights drawn from ``generator``
    (default: seeded with ``experiment.seed``) and move it to ``device``.
    The distributions follow the JAX initialisers; the bits do not."""
    dev = resolve_device(device)
    if registry is None:
        registry = TaskRegistry.from_config(config)
    if dtype is None:
        dtype = torch.bfloat16 if config.mixed_precision else torch.float32
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.seed))
    model = MultiTaskModel(config, registry, dtype=dtype)
    init_weights(model, generator)
    return model.to(dev).eval()
