"""Plain ViT / DINOv3 backbone and its multi-scale encoder (port of
``fmc_uia_tpu/models/encoders/vit.py``).

Token layout [B, N, C], f32 params, compute in ``dtype``, f32 LayerNorm
statistics (flax: eps 1e-6, fast variance), tanh GELU. Global attention
runs through ``ops/vit_attention.global_attention`` (K4f forward, K4b
backward) when ``flash_attention`` is 'on', or 'auto' with N >= 1024
tokens (prefix tokens counted), as in the JAX package; below that, or
with 'off', it is the plain einsum path in PyTorch, as the JAX package
leaves it to XLA.

Two positional regimes, as in the JAX ``ViTBackbone``: the plain ViT
(learned ``pos_embed`` over prefix + patch tokens, ``prefix_tokens``), and
DINOv3 (axial RoPE on q/k of the patch tokens from the ``rope_periods``
parameter, ``cls_token`` + ``storage_tokens``, LayerScale ``ls1``/``ls2``).
``rope_periods`` stays a parameter: its sin/cos tables are computed from
it in every forward, so its gradient exists and counts in the clip's
global norm as in JAX; ``train.label_params`` freezes it.

Two adapters turn the raw maps into the 4-stage pyramid: 'resize'
(``FourScaleAdapter``) and 'spm_interaction' (a CNN pyramid from the
image, ``SpatialPyramidModule``, whose every level queries a projected
ViT map through an ``InteractionBlock``; under the ``spm_adapter``
profiler range).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.encoders.adapters import (
    SPM_RANGE,
    FourScaleAdapter,
    InteractionBlock,
    SpatialPyramidModule,
)
from fmc_uia_tpu_torch.models.encoders.swin import _LN
from fmc_uia_tpu_torch.models.layers import (
    Conv,
    Dense,
    layer_norm,
    trunc_normal_,
)
from fmc_uia_tpu_torch.ops.vit_attention import global_attention

FLASH_MIN_TOKENS = 1024  # 'auto' switches to the kernels at this N
MLP_RATIO = 4
LAYERSCALE_INIT = 1e-5


def rope_default_periods(head_dim: int, base: float = 100.0,
                         min_period: Optional[float] = None,
                         max_period: Optional[float] = None) -> np.ndarray:
    """Axial-RoPE rotation periods, DINOv3 semantics: ``head_dim // 4``
    per spatial axis, geometric between (min, max) when both are given,
    else ``base ** (2k / (head_dim / 2))``."""
    d4 = head_dim // 4
    if min_period is not None and max_period is not None:
        exps = np.linspace(0.0, 1.0, d4)
        return (min_period * (max_period / min_period) ** exps).astype(
            np.float32)
    k = np.arange(d4, dtype=np.float32)
    return (base ** (2.0 * k / (head_dim // 2))).astype(np.float32)


def rope_sincos(gh: int, gw: int, periods: torch.Tensor,
                num_prefix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (sin, cos) tables, each [P + gh*gw, head_dim], f32:
    patch centres normalized per axis to [-1, 1], angle 2π·coord/period,
    the half layout [y-angles | x-angles] duplicated (rotate-half
    pairing); prefix rows get the identity rotation."""
    d4 = periods.shape[0]
    dev = periods.device
    ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) / gh
    xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) / gw
    ys, xs = ys * 2.0 - 1.0, xs * 2.0 - 1.0
    coords = torch.stack([ys.repeat_interleave(gw), xs.repeat(gh)], -1)
    angles = (2.0 * math.pi) * coords[:, :, None] / periods[None, None, :]
    angles = angles.reshape(gh * gw, 2 * d4)
    angles = torch.cat([angles, angles], -1)
    sin, cos = torch.sin(angles), torch.cos(angles)
    if num_prefix > 0:
        sin = torch.cat([sin.new_zeros(num_prefix, sin.shape[-1]), sin])
        cos = torch.cat([cos.new_ones(num_prefix, cos.shape[-1]), cos])
    return sin, cos


def apply_rope(t: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """Rotate ``t`` [B, N, H, dh] by per-token sin/cos [N, dh], the tables
    cast to t's dtype first."""
    half = t.shape[-1] // 2
    rot = torch.cat([-t[..., half:], t[..., :half]], -1)
    return (t * cos[None, :, None, :].to(t.dtype)
            + rot * sin[None, :, None, :].to(t.dtype))


class ViTBlock(nn.Module):
    """Pre-norm transformer block: LN -> qkv -> (RoPE) -> global attention
    -> proj (-> ls1) -> residual; LN -> fc1 -> GELU -> fc2 (-> ls2) ->
    residual."""

    def __init__(self, dim: int, num_heads: int,
                 flash_attention: str = "auto", layerscale: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.flash_attention = flash_attention
        self.layerscale = layerscale
        self.dtype = dtype
        hidden = MLP_RATIO * dim
        self.norm1 = _LN(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.norm2 = _LN(dim)
        self.mlp_fc1 = Dense(dim, hidden)
        self.mlp_fc2 = Dense(hidden, dim)
        if layerscale:
            self.ls1 = nn.Parameter(torch.full((dim,), LAYERSCALE_INIT))
            self.ls2 = nn.Parameter(torch.full((dim,), LAYERSCALE_INIT))

    def use_flash(self, n_tokens: int) -> bool:
        mode = self.flash_attention
        return mode == "on" or (mode == "auto"
                                and n_tokens >= FLASH_MIN_TOKENS)

    def forward(self, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        dh = C // H
        dt = self.dtype
        y = layer_norm(x, self.norm1.scale, self.norm1.bias, 1e-6, dt)
        qkv = F.linear(y, self.qkv.kernel.to(dt)) + self.qkv.bias.to(dt)
        q = qkv[..., :C].reshape(B, N, H, dh)
        k = qkv[..., C:2 * C].reshape(B, N, H, dh)
        v = qkv[..., 2 * C:].reshape(B, N, H, dh)
        if rope is not None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        scale = dh ** -0.5
        if self.use_flash(N):
            o = global_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), scale)
            o = o.transpose(1, 2).reshape(B, N, C)
        else:
            # the JAX einsum path: q * scale rounded to dt, f32 scores and
            # softmax, probabilities rounded to dt, f32 accumulation
            qs = (q * scale).transpose(1, 2).float()
            s = qs @ k.transpose(1, 2).float().transpose(-1, -2)
            p = torch.softmax(s, dim=-1).to(dt).float()
            o = (p @ v.transpose(1, 2).float()).to(dt)
            o = o.transpose(1, 2).reshape(B, N, C)
        o = F.linear(o, self.proj.kernel.to(dt)) + self.proj.bias.to(dt)
        if self.layerscale:
            o = o * self.ls1.to(o.dtype)
        x = x + o

        y = layer_norm(x, self.norm2.scale, self.norm2.bias, 1e-6, dt)
        y = F.linear(y, self.mlp_fc1.kernel.to(dt)) + self.mlp_fc1.bias.to(dt)
        y = F.gelu(y, approximate="tanh")
        y = F.linear(y, self.mlp_fc2.kernel.to(dt)) + self.mlp_fc2.bias.to(dt)
        if self.layerscale:
            y = y * self.ls2.to(y.dtype)
        return x + y


class ViTBackbone(nn.Module):
    """Patch-embed ViT returning token maps [B, gh, gw, C] at the
    ``out_indices`` blocks, prefix tokens stripped."""

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 out_indices: Sequence[int] = (2, 5, 8, 11),
                 num_prefix_tokens: int = 0,
                 flash_attention: str = "auto", rope: bool = False,
                 num_storage_tokens: int = 4, rope_base: float = 100.0,
                 rope_min_period: Optional[float] = None,
                 rope_max_period: Optional[float] = None,
                 layerscale: bool = False, dtype=torch.float32):
        super().__init__()
        self.embed_dim, self.depth = embed_dim, depth
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.rope = rope
        self.dtype = dtype
        self.patch_embed = Conv(3, embed_dim, patch_size, stride=patch_size,
                                dtype=dtype)
        D = embed_dim
        if rope:
            self.num_storage = int(num_storage_tokens)
            self.num_prefix = 1 + self.num_storage
            self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
            if self.num_storage > 0:
                self.storage_tokens = nn.Parameter(
                    torch.zeros(1, self.num_storage, D))
            self.rope_periods = nn.Parameter(torch.as_tensor(
                rope_default_periods(D // num_heads, rope_base,
                                     rope_min_period, rope_max_period)))
        else:
            self.num_prefix = int(num_prefix_tokens)
            if self.num_prefix > 0:
                self.prefix_tokens = nn.Parameter(
                    torch.zeros(1, self.num_prefix, D))
        # the plain regime's pos_embed is sized by make_pos_embed
        self.register_parameter("pos_embed", None)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(
                D, num_heads, flash_attention=flash_attention,
                layerscale=layerscale, dtype=dtype))

    def make_pos_embed(self, gh: int, gw: int) -> None:
        """The plain regime's ``pos_embed`` is sized by the input grid (the
        JAX param is created at init for the init input)."""
        if self.rope:
            return
        n = self.num_prefix + gh * gw
        self.pos_embed = nn.Parameter(torch.zeros(1, n, self.embed_dim))

    def _init(self, g):
        for name in ("cls_token", "storage_tokens", "prefix_tokens",
                     "pos_embed"):
            p = getattr(self, name, None)
            if isinstance(p, nn.Parameter):
                trunc_normal_(p, 0.02, g)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> List[torch.Tensor]:
        B, H, W, _ = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        D = self.embed_dim
        dt = self.dtype
        x = self.patch_embed(x.to(dt)).reshape(B, gh * gw, D)
        P = self.num_prefix
        rope_sc = None
        if self.rope:
            tokens = [self.cls_token.to(dt).expand(B, 1, D)]
            if self.num_storage > 0:
                tokens.append(self.storage_tokens.to(dt).expand(
                    B, self.num_storage, D))
            x = torch.cat(tokens + [x], 1)
            rope_sc = rope_sincos(gh, gw, self.rope_periods.float(), P)
        else:
            if P > 0:
                x = torch.cat([self.prefix_tokens.to(dt).expand(B, P, D), x],
                              1)
            pos = self.pos_embed
            if pos is None or pos.shape[1] != x.shape[1]:
                raise ValueError(
                    f"pos_embed {None if pos is None else tuple(pos.shape)}"
                    f" does not fit {x.shape[1]} tokens (make_pos_embed)")
            x = x + self.pos_embed.to(dt)
        outs = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, rope_sc)
            if i in self.out_indices:
                outs.append(x[:, P:, :].reshape(B, gh, gw, D))
        if not outs:
            outs = [x[:, P:, :].reshape(B, gh, gw, D)]
        return outs


class ViTMultiScaleEncoder(nn.Module):
    """ViT backbone + an adapter ('resize' or 'spm_interaction'): the
    4-stage pyramid contract, (adapter_channels,) * 4 channels."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 patch_size: int = 16,
                 out_indices: Sequence[int] = (2, 5, 8, 11),
                 adapter_type: str = "resize", adapter_channels: int = 256,
                 spm_stem_channels: int = 64, interaction_heads: int = 8,
                 interaction_points: int = 4,
                 interaction_offset_range: float = 0.25,
                 vit_layer_mapping: Optional[Sequence[int]] = None,
                 num_prefix_tokens: int = 0, flash_attention: str = "auto",
                 rope: bool = False, num_storage_tokens: int = 4,
                 rope_base: float = 100.0,
                 rope_min_period: Optional[float] = None,
                 rope_max_period: Optional[float] = None,
                 layerscale: bool = False, image_size: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        if adapter_type not in ("resize", "spm_interaction"):
            raise ValueError(f"Unsupported adapter_type: {adapter_type}")
        self.adapter_type = adapter_type
        self.adapter_channels = adapter_channels
        self.dtype = dtype
        self.backbone = ViTBackbone(
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            patch_size=patch_size, out_indices=out_indices,
            num_prefix_tokens=num_prefix_tokens,
            flash_attention=flash_attention, rope=rope,
            num_storage_tokens=num_storage_tokens, rope_base=rope_base,
            rope_min_period=rope_min_period,
            rope_max_period=rope_max_period, layerscale=layerscale,
            dtype=dtype)
        if image_size is not None:
            g = image_size // patch_size
            self.backbone.make_pos_embed(g, g)
        ch = adapter_channels
        if adapter_type == "resize":
            self.adapter = FourScaleAdapter(embed_dim, ch, dtype=dtype)
            return
        self.vit_layer_mapping = (list(vit_layer_mapping)
                                  if vit_layer_mapping is not None
                                  else [0, 1, 2, 3])
        self.spm = SpatialPyramidModule((ch,) * 4, spm_stem_channels,
                                        dtype=dtype)
        for i in range(4):
            self.add_module(f"vit_proj{i}", Conv(embed_dim, ch, 1,
                                                 use_bias=False, dtype=dtype))
            self.add_module(f"interaction{i}", InteractionBlock(
                ch, interaction_heads, interaction_points,
                interaction_offset_range, dtype=dtype))

    @property
    def out_channels(self) -> Tuple[int, int, int, int]:
        return (self.adapter_channels,) * 4

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> List[torch.Tensor]:
        raw = self.backbone(x, train=train)[:4]
        while len(raw) < 4:
            raw.append(raw[-1])
        if self.adapter_type == "resize":
            return self.adapter(raw, (x.shape[1], x.shape[2]))
        with torch.profiler.record_function(SPM_RANGE):
            pyramid = self.spm(x.to(self.dtype))
            fused = []
            for i, cnn_feat in enumerate(pyramid):
                vit_feat = getattr(self, f"vit_proj{i}")(
                    raw[min(self.vit_layer_mapping[i], len(raw) - 1)])
                fused.append(getattr(self, f"interaction{i}")(cnn_feat,
                                                              vit_feat))
        return fused


_VIT_VARIANTS = {
    "vit_t": dict(embed_dim=192, depth=12, num_heads=3),
    "vit_s": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16,
                  out_indices=(5, 11, 17, 23)),
    "vit_nano": dict(embed_dim=64, depth=4, num_heads=2,
                     out_indices=(0, 1, 2, 3)),  # test-size
}


def build_vit_encoder(name: str, config, dtype=torch.float32
                      ) -> ViTMultiScaleEncoder:
    """Dispatch for vit_*/dinov3/timm: encoder names, as the JAX
    ``build_vit_encoder``. The plain regime's ``pos_embed`` is sized for
    ``data.image_size``."""
    enc_cfg = (config.get("model.encoder", {}) or {}) if config else {}
    adapter_cfg = enc_cfg.get("adapter", {}) or {}

    is_dino = name.startswith("dinov3") or "dinov3" in name
    if name.startswith("timm:"):
        body = name[len("timm:"):]
        is_dino = "dinov3" in body
        if "large" in body:
            variant = "vit_l"
        elif "small" in body:
            variant = "vit_s"
        elif "tiny" in body:
            variant = "vit_t"
        else:
            variant = "vit_b"
    elif is_dino:
        timm_name = str(enc_cfg.get("timm_name", ""))
        variant = "vit_l" if "large" in timm_name else "vit_b"
    else:
        variant = name
    if variant not in _VIT_VARIANTS:
        raise ValueError(f"Unknown ViT variant {variant!r}")

    kwargs = dict(_VIT_VARIANTS[variant])
    out_indices = enc_cfg.get("out_indices")
    if out_indices is not None:
        kwargs["out_indices"] = tuple(out_indices)

    patch_size = 16
    timm_name = str(enc_cfg.get("timm_name", "") or "")
    if "patch8" in timm_name or "patch8" in name:
        patch_size = 8
    elif "patch14" in timm_name or "patch14" in name:
        patch_size = 14

    adapter_type = (str(adapter_cfg.get("type", "resize")) if is_dino
                    else "resize")
    adapter_channels = int(
        adapter_cfg.get("channels", enc_cfg.get("adapter_channels", 256)))

    pretrained = enc_cfg.get("pretrained")
    default_prefix = 0
    if isinstance(pretrained, str) and pretrained not in ("", "none"):
        default_prefix = 5 if is_dino else 1
    num_prefix = int(enc_cfg.get("num_prefix_tokens", default_prefix))

    dinov3_arch = str(enc_cfg.get("dinov3_arch", "dinov3")).lower()
    use_rope = is_dino and dinov3_arch != "plain"
    rope_kwargs = {}
    if use_rope:
        rmin = enc_cfg.get("rope_min_period")
        rmax = enc_cfg.get("rope_max_period")
        rope_kwargs = dict(
            rope=True, layerscale=True,
            num_storage_tokens=int(enc_cfg.get("num_storage_tokens", 4)),
            rope_base=float(enc_cfg.get("rope_base", 100.0)),
            rope_min_period=float(rmin) if rmin is not None else None,
            rope_max_period=float(rmax) if rmax is not None else None)

    flash = str(enc_cfg.get("flash_attention", "auto")).lower()
    if flash in ("true", "1"):
        flash = "on"
    elif flash in ("false", "0"):
        flash = "off"
    if flash not in ("auto", "on", "off"):
        raise ValueError("model.encoder.flash_attention must be auto/on/off,"
                         f" got {flash!r}")

    image_size = config.get("data.image_size") if config else None
    return ViTMultiScaleEncoder(
        patch_size=patch_size, flash_attention=flash,
        adapter_type=adapter_type, adapter_channels=adapter_channels,
        spm_stem_channels=int(adapter_cfg.get("spm_stem_channels", 64)),
        interaction_heads=int(adapter_cfg.get("interaction_heads", 8)),
        interaction_points=int(adapter_cfg.get("interaction_points", 4)),
        interaction_offset_range=float(
            adapter_cfg.get("interaction_offset_range", 0.25)),
        vit_layer_mapping=enc_cfg.get("vit_layer_mapping"),
        num_prefix_tokens=num_prefix,
        image_size=None if image_size is None else int(image_size),
        dtype=dtype, **rope_kwargs, **kwargs)
