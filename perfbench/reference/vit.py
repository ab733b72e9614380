"""Plain ViT / DINOv3 backbone and its 'resize' multi-scale encoder: a
frozen copy of the port's ``models/encoders/vit.py``.

Token layout [B, N, C], f32 params, compute in ``dtype``, f32 LayerNorm
statistics (flax: eps 1e-6, fast variance), tanh GELU. Global attention
is softmax attention computed a few images at a time
(``chunked_attention``: the port's K4 math, which in f32 is plain
softmax attention), and each block is recomputed in the backward
(``torch.utils.checkpoint``), so that a batch of 4,101-token images fits
the card in f32.

Two positional regimes, as in the port: the plain ViT (learned
``pos_embed`` over prefix + patch tokens, ``prefix_tokens``), and DINOv3
(axial RoPE on q/k of the patch tokens from the ``rope_periods``
parameter, ``cls_token`` + ``storage_tokens``, LayerScale ``ls1``/``ls2``).
"""


from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from .adapters import FourScaleAdapter
from .swin import _LN
from .layers import (
    Conv,
    Dense,
    layer_norm,
    trunc_normal_,
)


ATTN_CHUNK = 2  # images a step of ``chunked_attention``
# counting operations (``perfbench/counts.py``, on the meta device): plain
# softmax attention under autograd and no recomputation in the backward
COUNT_MODE = False


class _ChunkedAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v on [B, H, N, dh], ATTN_CHUNK images at a
    time, forward and backward (the backward recomputes the scores from
    the saved log-sum-exp): the [B, H, N, N] scores never exist whole."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        outs, lses = [], []
        for i in range(0, q.shape[0], ATTN_CHUNK):
            sl = slice(i, i + ATTN_CHUNK)
            s = (q[sl] @ k[sl].transpose(-1, -2)) * scale
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            denom = p.sum(-1, keepdim=True)
            outs.append((p @ v[sl]) / denom)
            lses.append(m + torch.log(denom))
            del s, p
        o = torch.cat(outs)
        ctx.save_for_backward(q, k, v, o, torch.cat(lses))
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale = ctx.scale
        dqs, dks, dvs = [], [], []
        for i in range(0, q.shape[0], ATTN_CHUNK):
            sl = slice(i, i + ATTN_CHUNK)
            p = torch.exp((q[sl] @ k[sl].transpose(-1, -2)) * scale
                          - lse[sl])
            dvs.append(p.transpose(-1, -2) @ do[sl])
            dp = do[sl] @ v[sl].transpose(-1, -2)
            di = (o[sl] * do[sl]).sum(-1, keepdim=True)
            ds = (dp - di) * p * scale
            del p, dp
            dqs.append(ds @ k[sl])
            dks.append(ds.transpose(-1, -2) @ q[sl])
            del ds
        return torch.cat(dqs), torch.cat(dks), torch.cat(dvs), None


def chunked_attention(q, k, v, scale: float) -> torch.Tensor:
    """Softmax attention of q, k, v [B, H, N, dh] in their dtype."""
    if COUNT_MODE:
        return torch.softmax((q @ k.transpose(-1, -2)) * scale, -1) @ v
    return _ChunkedAttention.apply(q, k, v, scale)

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
        o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale)
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
            block = getattr(self, f"block{i}")
            if torch.is_grad_enabled() and not COUNT_MODE:
                x = checkpoint(block, x, rope_sc, use_reentrant=False)
            else:
                x = block(x, rope_sc)
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
        if adapter_type != "resize":
            raise ValueError(f"the reference has no {adapter_type!r} "
                             "adapter")
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
        self.adapter = FourScaleAdapter(embed_dim, adapter_channels,
                                        dtype=dtype)

    @property
    def out_channels(self) -> Tuple[int, int, int, int]:
        return (self.adapter_channels,) * 4

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> List[torch.Tensor]:
        raw = self.backbone(x, train=train)[:4]
        while len(raw) < 4:
            raw.append(raw[-1])
        return self.adapter(raw, (x.shape[1], x.shape[2]))


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
