"""Swin Transformer encoder (port of ``fmc_uia_tpu/models/encoders/swin.py``).

NHWC throughout, f32 params, compute in ``dtype``. Each block's attention
half runs through the fused attention branch (``ops/swin_block.py``); its
MLP half runs through the fused MLP branch where C <= 256 and otherwise as
LayerNorm -> Linear -> tanh-GELU -> Linear, as in the JAX package. The
port has no scan: every block is its own module ``stage{s}_block{b}``,
which is also the JAX tree's name for an unrolled block
(``utils/convert.py`` unstacks the scanned stages onto it).

The roll, the padding and the rel-pos table expansion stay outside the
kernel, as on the TPU.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fmc_uia_tpu_torch.models.layers import (
    Conv,
    _param,
    layer_norm,
    lecun_normal_,
    trunc_normal_,
)
from fmc_uia_tpu_torch.ops.swin_block import attention_branch, mlp_branch

# the fused MLP branch serves the blocks with C <= 256 (stages 0 and 1 of
# swin_b), the gate of the JAX package
FUSED_MLP_MAX_C = 256


def _relative_position_index(ws: int) -> np.ndarray:
    """Static [ws*ws, ws*ws] index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Additive mask [nW, N, N] for shifted windows (region ids, -100)."""
    img_mask = np.zeros((hp, wp), np.int32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wss in slices:
            img_mask[hs, wss] = cnt
            cnt += 1
    windows = img_mask.reshape(hp // ws, ws, wp // ws, ws)
    windows = windows.transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = windows[:, None, :] != windows[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def block_attn_mask(H: int, W: int, ws: int, shift: int):
    """The block's combined shift + pad mask [nW, N, N], or None. The pad
    validity map is rolled like the features (swin.py:296-306)."""
    hp = -(-H // ws) * ws
    wp = -(-W // ws) * ws
    mask = _shift_attn_mask(hp, wp, ws, shift) if shift > 0 else None
    if hp != H or wp != W:
        valid = np.zeros((hp, wp), np.bool_)
        valid[:H, :W] = True
        if shift > 0:
            valid = np.roll(valid, (-shift, -shift), axis=(0, 1))
        vw = valid.reshape(hp // ws, ws, wp // ws, ws)
        vw = vw.transpose(0, 2, 1, 3).reshape(-1, ws * ws)
        pad = np.where(vw[:, None, :], 0.0, -100.0).astype(np.float32)
        pad = np.broadcast_to(pad, (vw.shape[0], ws * ws, ws * ws))
        mask = pad.copy() if mask is None else mask + pad
    return mask


class _LN(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = _param(features)


class _Dense(nn.Module):
    """Dense params in PyTorch layout: kernel [out, in], bias [out]."""

    def __init__(self, cin: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = _param(features, cin)
        self.bias = _param(features) if use_bias else None

    def _init(self, g):
        lecun_normal_(self.kernel, self.kernel.shape[1], g)


class _Attn(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int):
        super().__init__()
        self.qkv = _Dense(dim, 3 * dim)
        self.proj = _Dense(dim, dim)
        self.rel_pos_bias = _param((2 * ws - 1) ** 2, num_heads)

    def _init(self, g):
        trunc_normal_(self.rel_pos_bias, 0.02, g)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: float = 4.0, ln_bf16: bool = False,
                 fused_mlp: bool = True, dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.ws = dim, num_heads, window_size
        self.shift = shift
        self.dtype = dtype
        self.ln_dtype = dtype if ln_bf16 else torch.float32
        self.fused_mlp = fused_mlp and dim <= FUSED_MLP_MAX_C
        hidden = int(dim * mlp_ratio)
        self.norm1 = _LN(dim)
        self.attn = _Attn(dim, num_heads, window_size)
        self.norm2 = _LN(dim)
        self.mlp_fc1 = _Dense(dim, hidden)
        self.mlp_fc2 = _Dense(hidden, dim)
        n = window_size * window_size
        self.register_buffer("rel_idx", torch.as_tensor(
            _relative_position_index(window_size).reshape(-1)),
            persistent=False)
        self._masks = {}
        self._n = n

    def _mask(self, H: int, W: int, shift: int, device):
        key = (H, W, shift, str(device))
        if key not in self._masks:
            m = block_attn_mask(H, W, self.ws, shift)
            self._masks[key] = (None if m is None
                                else torch.as_tensor(m, device=device))
        return self._masks[key]

    def forward(self, x):
        B, H, W, C = x.shape
        ws, n = self.ws, self._n
        # one window covering the grid: no shift (timm parity, swin.py:282)
        shift = self.shift if min(H, W) > ws else 0
        hp = -(-H // ws) * ws
        wp = -(-W // ws) * ws
        mask = self._mask(H, W, shift, x.device)

        y = x.to(self.dtype)
        if hp != H or wp != W:
            y = F.pad(y, (0, 0, 0, wp - W, 0, hp - H))
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        a = self.attn
        bias = a.rel_pos_bias[self.rel_idx].reshape(n, n, self.num_heads)
        bias = bias.permute(2, 0, 1).contiguous()
        y = attention_branch(y.contiguous(), self.norm1.scale,
                             self.norm1.bias, a.qkv.kernel, a.qkv.bias,
                             a.proj.kernel, a.proj.bias, bias, mask,
                             self.num_heads)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if hp != H or wp != W:
            y = y[:, :H, :W, :]
        x = y.contiguous()  # residual is inside the branch

        if self.fused_mlp:
            return mlp_branch(x.to(self.dtype), self.norm2.scale,
                              self.norm2.bias, self.mlp_fc1.kernel,
                              self.mlp_fc1.bias, self.mlp_fc2.kernel,
                              self.mlp_fc2.bias)
        dt = self.dtype
        y = layer_norm(x, self.norm2.scale, self.norm2.bias, 1e-6,
                       self.ln_dtype)
        y = F.linear(y.to(dt), self.mlp_fc1.kernel.to(dt))
        y = F.gelu(y + self.mlp_fc1.bias.to(dt), approximate="tanh")
        y = F.linear(y, self.mlp_fc2.kernel.to(dt))
        return x + (y + self.mlp_fc2.bias.to(dt))


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat (order k = 2*di + dj) -> LN (f32 stats,
    eps 1e-6) -> Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, ln_bf16: bool = False, dtype=torch.float32):
        super().__init__()
        self.norm = _LN(4 * dim)
        self.reduction = _Dense(4 * dim, 2 * dim, use_bias=False)
        self.dtype = dtype
        self.ln_dtype = dtype if ln_bf16 else torch.float32

    def forward(self, x):
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        xc = torch.cat([x[:, di::2, dj::2, :] for di in (0, 1)
                        for dj in (0, 1)], dim=-1)
        # f32 stats over the 4C concat, as the sliced JAX formulation
        xf = xc.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mu * mu
        rstd = torch.rsqrt(var + 1e-6)
        lt = self.ln_dtype
        xh = (xc.to(lt) - mu.to(lt)) * rstd.to(lt)
        xn = (xh * self.norm.scale.to(lt) + self.norm.bias.to(lt))
        # bf16 operands, f32 accumulation, one rounding at the end
        return F.linear(xn.to(self.dtype),
                        self.reduction.kernel.to(self.dtype))


class SwinEncoder(nn.Module):
    """4-stage Swin pyramid: features at strides 4/8/16/32 with channels
    (C, 2C, 4C, 8C)."""

    def __init__(self, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 patch_size: int = 4, ln_bf16: bool = False,
                 fused_mlp: bool = True, dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.dtype = dtype
        self.ln_dtype = dtype if ln_bf16 else torch.float32
        self.patch_embed = Conv(3, embed_dim, patch_size, stride=patch_size,
                                dtype=dtype)
        self.patch_norm = _LN(embed_dim)
        for s, depth in enumerate(self.depths):
            dim = embed_dim * 2 ** s
            if s > 0:
                self.add_module(f"merge{s}", PatchMerging(
                    dim // 2, ln_bf16=ln_bf16, dtype=dtype))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", SwinBlock(
                    dim, num_heads[s], window_size,
                    shift=0 if b % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, ln_bf16=ln_bf16,
                    fused_mlp=fused_mlp, dtype=dtype))

    @property
    def out_channels(self):
        return tuple(self.embed_dim * 2 ** i for i in range(4))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.patch_embed(x.to(self.dtype))
        x = layer_norm(x, self.patch_norm.scale, self.patch_norm.bias, 1e-6,
                       self.ln_dtype)
        features = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"merge{s}")(x)
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            features.append(x)
        return features


_SWIN_VARIANTS = {
    "swin_t": dict(embed_dim=96, depths=(2, 2, 6, 2),
                   num_heads=(3, 6, 12, 24)),
    "swin_s": dict(embed_dim=96, depths=(2, 2, 18, 2),
                   num_heads=(3, 6, 12, 24)),
    "swin_b": dict(embed_dim=128, depths=(2, 2, 18, 2),
                   num_heads=(4, 8, 16, 32)),
    "swin_l": dict(embed_dim=192, depths=(2, 2, 18, 2),
                   num_heads=(6, 12, 24, 48)),
    "swin_nano": dict(embed_dim=32, depths=(1, 1, 1, 1),
                      num_heads=(2, 2, 4, 4)),
    "swin_micro": dict(embed_dim=32, depths=(2, 2, 2, 2),
                       num_heads=(2, 4, 8, 16)),
}


def build_swin(name: str, config=None, dtype=torch.float32) -> SwinEncoder:
    """The serving path's Swin: the attention half always runs the fused
    branch; ``model.encoder.fused_mlp`` (default on) routes the C <= 256
    MLP halves through the fused MLP branch."""
    if name not in _SWIN_VARIANTS:
        raise ValueError(
            f"Unknown swin variant {name!r}; have {sorted(_SWIN_VARIANTS)}")
    kwargs = dict(_SWIN_VARIANTS[name])
    window, ln_bf16, fused_mlp = 7, False, True
    if config is not None:
        window = int(config.get("model.encoder.window_size", 7))
        ln_bf16 = bool(config.get("model.encoder.ln_bf16", False))
        if config.get("model.encoder.fused_block", True) is False:
            raise NotImplementedError(
                "model.encoder.fused_block=false (the unfused XLA attention "
                "path) is not ported; the port always runs the fused "
                "attention branch (ROADMAP: port queue)")
        fused_mlp = bool(config.get("model.encoder.fused_mlp", True))
    return SwinEncoder(window_size=window, ln_bf16=ln_bf16,
                       fused_mlp=fused_mlp, dtype=dtype, **kwargs)
