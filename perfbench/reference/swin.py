"""Swin Transformer encoder: a frozen copy of the port's
``models/encoders/swin.py``, plain path only.

NHWC throughout, f32 params, compute in ``dtype``. Every block runs the
plain chain that the port's fused branches compute: LayerNorm (in
``ln_dtype``) -> pad -> roll -> window partition -> qkv -> scores +
rel-pos bias + shift/pad mask -> softmax -> .v -> proj -> unpartition ->
unroll -> crop -> ``x + drop_path(y)``, then LayerNorm -> Linear ->
tanh-GELU -> Linear -> ``x + drop_path(y)``. In train mode each block
applies stochastic depth at the rate ``linspace(0, drop_path_rate,
blocks)[block]``, its keep masks drawn in the port's order (attention
half, then MLP half).
"""


from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (
    Conv,
    Dense,
    _in_dtype,
    _param,
    apply_drop_path,
    drop_path_keep,
    keep_mask,
    layer_norm,
    trunc_normal_,
)



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


class _Attn(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rel_pos_bias = _param((2 * ws - 1) ** 2, num_heads)

    def _init(self, g):
        trunc_normal_(self.rel_pos_bias, 0.02, g)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: float = 4.0, ln_bf16: bool = False,
                 drop_path: float = 0.0, softmax_bf16: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.ws = dim, num_heads, window_size
        self.shift = shift
        self.drop_path = float(drop_path)
        self.dtype = dtype
        self.ln_dtype = dtype if ln_bf16 else torch.float32
        # scores, bias, mask and softmax
        self.score_dtype = (torch.bfloat16 if softmax_bf16
                            and dtype == torch.bfloat16 else torch.float32)
        hidden = int(dim * mlp_ratio)
        self.norm1 = _LN(dim)
        self.attn = _Attn(dim, num_heads, window_size)
        self.norm2 = _LN(dim)
        self.mlp_fc1 = Dense(dim, hidden)
        self.mlp_fc2 = Dense(hidden, dim)
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
            # a normal tensor even when first made under inference mode
            # (a served model): a train step saves it for backward
            with torch.inference_mode(False):
                self._masks[key] = (None if m is None
                                    else torch.as_tensor(m, device=device))
        return self._masks[key]

    def _keep_mask(self, x, train, generator):
        """Per-sample keep mask of stochastic depth, or None (eval, rate 0)."""
        if not train or self.drop_path == 0.0:
            return None
        return keep_mask((x.shape[0],), float(drop_path_keep(self.drop_path)),
                         generator, x.device)

    def _window_attention(self, y, bias, mask):
        """The JAX ``WindowAttention`` on [B*nW, N, C] windows ``y``:
        qkv and proj in ``dtype`` (each product rounded, then its bias
        added), scores + bias + mask and the softmax in ``score_dtype``,
        the .v product accumulated in f32 and rounded to ``dtype``."""
        Bn, N, C = y.shape
        H, dt, st = self.num_heads, self.dtype, self.score_dtype
        dh = C // H
        a = self.attn
        qkv = F.linear(y.to(dt), a.qkv.kernel.to(dt)) + a.qkv.bias.to(dt)
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(Bn, N, H, dh)
                   .transpose(1, 2) for i in range(3))
        q = q * _in_dtype(dh ** -0.5, dt)
        # bf16 operands: each product exact in f32, summed in f32, rounded
        # once to the score dtype
        if st == dt:
            attn = torch.matmul(q, k.transpose(-1, -2))
        else:
            attn = torch.matmul(q.to(st), k.to(st).transpose(-1, -2))
        attn = attn + bias.to(st)
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bn // nW, nW, H, N, N)
                    + mask[None, :, None].to(st)).reshape(Bn, H, N, N)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(Bn, N, C)
        return F.linear(out, a.proj.kernel.to(dt)) + a.proj.bias.to(dt)

    def _attention_unfused(self, x, bias, mask, shift, hp, wp, train,
                           generator):
        B, H, W, C = x.shape
        ws = self.ws
        y = layer_norm(x, self.norm1.scale, self.norm1.bias, 1e-6,
                       self.ln_dtype)
        if hp != H or wp != W:
            y = F.pad(y, (0, 0, 0, wp - W, 0, hp - H))
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        win = (y.reshape(B, hp // ws, ws, wp // ws, ws, C)
               .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C))
        win = self._window_attention(win, bias, mask)
        y = (win.reshape(B, hp // ws, wp // ws, ws, ws, C)
             .permute(0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C))
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if hp != H or wp != W:
            y = y[:, :H, :W, :]
        keep = self._keep_mask(x, train, generator)
        if keep is not None:
            y = apply_drop_path(y, keep, self.drop_path)
        return x + y

    def forward(self, x, train: bool = False, generator=None):
        B, H, W, C = x.shape
        ws, n = self.ws, self._n
        # one window covering the grid: no shift (timm parity, swin.py:282)
        shift = self.shift if min(H, W) > ws else 0
        hp = -(-H // ws) * ws
        wp = -(-W // ws) * ws
        mask = self._mask(H, W, shift, x.device)
        a = self.attn
        bias = a.rel_pos_bias[self.rel_idx].reshape(n, n, self.num_heads)
        bias = bias.permute(2, 0, 1).contiguous()
        x = self._attention_unfused(x, bias, mask, shift, hp, wp, train,
                                    generator)
        dt = self.dtype
        y = layer_norm(x, self.norm2.scale, self.norm2.bias, 1e-6,
                       self.ln_dtype)
        y = F.linear(y.to(dt), self.mlp_fc1.kernel.to(dt))
        y = F.gelu(y + self.mlp_fc1.bias.to(dt), approximate="tanh")
        y = F.linear(y, self.mlp_fc2.kernel.to(dt))
        y = y + self.mlp_fc2.bias.to(dt)
        keep = self._keep_mask(x, train, generator)
        if keep is not None:
            y = apply_drop_path(y, keep, self.drop_path)
        return x + y


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat (order k = 2*di + dj) -> LN (f32 stats,
    eps 1e-6) -> Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, ln_bf16: bool = False, dtype=torch.float32):
        super().__init__()
        self.norm = _LN(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, use_bias=False)
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
                 drop_path_rate: float = 0.1, softmax_bf16: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.dtype = dtype
        self.ln_dtype = dtype if ln_bf16 else torch.float32
        self.patch_embed = Conv(3, embed_dim, patch_size, stride=patch_size,
                                dtype=dtype)
        self.patch_norm = _LN(embed_dim)
        # per-block stochastic-depth rates (JAX swin.py:563)
        dpr = np.linspace(0, drop_path_rate, sum(self.depths))
        block_id = 0
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
                    drop_path=float(dpr[block_id]),
                    softmax_bf16=softmax_bf16, dtype=dtype))
                block_id += 1

    @property
    def out_channels(self):
        return tuple(self.embed_dim * 2 ** i for i in range(4))

    def forward(self, x, train: bool = False,
                generator=None) -> List[torch.Tensor]:
        x = self.patch_embed(x.to(self.dtype))
        x = layer_norm(x, self.patch_norm.scale, self.patch_norm.bias, 1e-6,
                       self.ln_dtype)
        features = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"merge{s}")(x)
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x, train, generator)
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
    """The Swin of ``model.encoder``: ``window_size`` (default 7),
    ``ln_bf16``, ``drop_path_rate`` (default 0.1) and ``softmax_bf16``;
    the port's fused-path switches (``fused_block``, ``fused_stages``,
    ``fused_mlp``, ``FMC_FUSED_MLP_MAX_C``) choose kernels for the same
    math and are not read."""
    if name not in _SWIN_VARIANTS:
        raise ValueError(
            f"Unknown swin variant {name!r}; have {sorted(_SWIN_VARIANTS)}")
    kwargs = dict(_SWIN_VARIANTS[name])
    window, ln_bf16, drop_path, softmax_bf16 = 7, False, 0.1, False
    if config is not None:
        drop_path = float(config.get("model.encoder.drop_path_rate", 0.1))
        window = int(config.get("model.encoder.window_size", 7))
        ln_bf16 = bool(config.get("model.encoder.ln_bf16", False))
        softmax_bf16 = bool(config.get("model.encoder.softmax_bf16", False))
    return SwinEncoder(window_size=window, ln_bf16=ln_bf16,
                       drop_path_rate=drop_path, softmax_bf16=softmax_bf16,
                       dtype=dtype, **kwargs)
