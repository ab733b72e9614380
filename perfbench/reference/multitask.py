"""Multi-task model: a frozen copy of the port's ``models/multitask.py``
(swin_* and dinov3 encoders only).

Optional task prompt on the normalised image -> shared encoder -> optional MoE
blocks on encoder stages -> optional per-stage FiLM (``MultiFiLM``) ->
per-task-type FPN -> FiLM -> banked head. The task type is a Python string
choosing the branch; the task index is a tensor, mapped to the head bank's
local index through the registry's table on the device. Outputs keep the JAX
layouts: seg [B, H, W, Cmax], cls [B, Cmax], det a dict of NHWC maps, reg [B,
2P]; a grid det head gives [B, h, w, 4 + 1] and a deep-supervision seg head
``(main, [aux...])``. The MoE blocks' balance losses and statistics, which the
JAX model ``sow``s into ``intermediates``, come back from ``forward(...,
return_intermediates=True)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .conditioning import (
    build_film,
    build_moe_blocks,
    build_multi_film,
    build_task_prompt,
)
from .decoders import build_decoders
from .heads import build_head_banks
from .layers import take
from .tasks import (
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
        self.registry = registry
        self.dtype = dtype
        self.encoder = build_encoder(config, dtype=dtype)
        enc_ch = self.encoder.out_channels
        self.moe_stages = []
        for i, block in build_moe_blocks(config, len(registry), enc_ch,
                                         dtype=dtype).items():
            self.add_module(f"moe_stage{i}", block)
            self.moe_stages.append(i)
        self.multi_film = build_multi_film(config, len(registry), enc_ch)
        self.task_prompt = build_task_prompt(config,
                                             registry.to_task_configs())
        names = (config.get("model.task_prompt", {}) or {}).get(
            "apply_to_task_names")
        self.prompt_apply_names = (None if names is None else
                                   tuple(str(n).lower() for n in names))
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

    def _apply_moe(self, features, task_index, inter, **rand):
        """Each MoE block on its stage's feature; its aux loss and stats
        appended to ``inter`` in stage order."""
        out = list(features)
        for i in self.moe_stages:
            y, aux, stats = getattr(self, f"moe_stage{i}")(
                out[i], task_index, **rand)
            out[i] = y
            inter["moe_aux"].append(aux)
            inter["moe_importance"].append(stats["importance"])
            inter["moe_load"].append(stats["load"])
        return out

    def forward(self, images, task_type: str, task_index,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_intermediates: bool = False):
        """images [B, H, W, 3] normalized (NHWC); task_type one of
        TASK_TYPES; task_index the global task index (int or 0-d tensor).
        ``train`` turns on drop path and dropout, their masks drawn from
        ``generator`` (a generator on the model's device). With
        ``return_intermediates`` returns ``(output, intermediates)``:
        lists ``moe_aux``, ``moe_importance`` and ``moe_load``, one device
        tensor per MoE block (empty without MoE)."""
        out, inter = self._forward(images, task_type, task_index, train,
                                   generator)
        return (out, inter) if return_intermediates else out

    def _forward(self, images, task_type, task_index, train, generator):
        if task_type not in TASK_TYPES:
            raise ValueError(f"Unknown task_type: {task_type}")
        task_index = torch.as_tensor(task_index, dtype=torch.long,
                                     device=self.local_index_table.device)
        local_idx = take(self.local_index_table, task_index)
        rand = dict(train=train, generator=generator)
        inter = {"moe_aux": [], "moe_importance": [], "moe_load": []}
        x = images.to(self.dtype)
        if self.task_prompt is not None and (
                self.prompt_apply_names is None
                or task_type.lower() in self.prompt_apply_names):
            x = self.task_prompt(x, task_index)
        features = self.encoder(x, **rand)
        features = self._apply_moe(features, task_index, inter, **rand)
        if self.multi_film is not None:
            features = self.multi_film(features, task_index)
        head = getattr(self, f"head_banks_{task_type}")
        if self._needs_fpn(task_type):
            x = getattr(self, self.decoder_alias[task_type])(features, **rand)
            if self.film is not None:
                x = self.film(x, task_index)
            return head(x, local_idx, **rand), inter
        return head(features[-1], local_idx, **rand), inter


def build_encoder(config, dtype=torch.float32):
    """The reference's encoders: ``swin_*`` and the DINOv3 / ViT family."""
    from .swin import build_swin
    from .vit import build_vit_encoder

    name = str(config.get("model.encoder.name", "resnet50"))
    if name.startswith("swin_"):
        return build_swin(name, config, dtype=dtype)
    if name.startswith(("vit_", "dinov3")):
        return build_vit_encoder(name, config, dtype=dtype)
    raise ValueError(f"the reference has no encoder {name!r}")


def build_model(config, registry: Optional[TaskRegistry] = None,
                dtype=torch.float32, device="cpu") -> MultiTaskModel:
    """The model with its weights at their placeholders (zeros; ones for
    norm scales and FiLM gammas; the ViT's LayerScale and RoPE periods at
    their defaults), on ``device``: a caller loads a state dict next."""
    if registry is None:
        registry = TaskRegistry.from_config(config)
    with torch.device(device):
        model = MultiTaskModel(config, registry, dtype=dtype)
    return model.eval()
