"""Shared layers and *banked* per-subtask layers: a frozen copy of the
port's ``models/layers.py``, kept as the benchmark's plain reference.

Activations stay NHWC at every public function, as in the JAX package. A
contiguous NHWC tensor permuted to NCHW is a channels_last tensor, so the
convolutions run on it without a copy.

Parameter names follow the JAX tree (``kernel``, ``bias``, ``scale``) so
that ``utils/convert.load_jax_params`` maps leaves by path; layouts follow
PyTorch: a dense kernel is ``[out, in]``, a conv kernel ``OIHW``, a banked
conv kernel ``[T, O, I, kh, kw]`` and a banked dense kernel ``[T, out, in]``.

A bank selects one ``[T, ...]`` slice by a device-side local index, then
calls ``F.conv2d``/``F.linear``: one module per task type serves every
subtask, as in the JAX package.

Train-mode randomness (dropout, drop path) draws its masks from an explicit
``torch.Generator`` on the activations' device; the bits differ from JAX's,
the distributions and the scaling do not.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F



def rand(shape, generator, device) -> torch.Tensor:
    """U[0, 1) f32 draws from ``generator`` (one process holds the whole
    batch: the port's per-row draw outside a batch scope)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.rand(shape, generator=generator, device=device)


def randn(shape, generator, device) -> torch.Tensor:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.randn(shape, generator=generator, device=device)

# flax truncated-normal variance scaling divides by the stddev of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def gn_groups(channels: int) -> int:
    """Largest group count <= 32 dividing channels."""
    groups = min(32, channels)
    while channels % groups != 0:
        groups -= 1
    return groups


def lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> None:
    """flax ``lecun_normal`` / ``variance_scaling(1, fan_in,
    truncated_normal)``: unit normal truncated to [-2, 2], rescaled."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def trunc_normal_(t: torch.Tensor, std: float, generator) -> None:
    """flax ``truncated_normal(std)``: std times a unit normal truncated to
    [-2, 2]."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random init of every submodule that defines ``_init(generator)``,
    in registration order, so one seed gives one set of weights."""
    for m in module.modules():
        init = getattr(m, "_init", None)
        if init is not None:
            init(generator)


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` for a 0-d index tensor on ``t``'s device, as a gather:
    indexing with a 0-d tensor reads it on the host (``.item()``), which
    would stall the host until the GPU has caught up."""
    return t.index_select(0, idx.reshape(1))[0]


def keep_mask(shape, keep: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Bernoulli(keep) mask, as ``jax.random.bernoulli``: uniform < keep
    (under a mesh, the global batch's rows drawn, this rank's kept)."""
    return rand(shape, generator, device) < keep


def _in_dtype(v: float, dtype) -> float:
    """The Python float ``v`` rounded to ``dtype``, on the host (a device
    scalar made from a host value would wait for the device)."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def apply_dropout(x: torch.Tensor, mask: torch.Tensor, rate: float
                  ) -> torch.Tensor:
    """flax ``nn.Dropout`` with a given (broadcastable) keep mask:
    ``select(mask, x / keep, 0)``, the Python-float keep taken in x's
    dtype as JAX takes a weak-typed scalar."""
    return torch.where(mask, x / _in_dtype(1.0 - rate, x.dtype), 0.0)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator],
            broadcast_dims: Sequence[int] = ()) -> torch.Tensor:
    """flax ``nn.Dropout(rate, broadcast_dims, deterministic=not train)``:
    identity at eval or rate 0; the mask is drawn over x's shape with the
    ``broadcast_dims`` set to 1."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    for d in broadcast_dims:
        shape[d] = 1
    return apply_dropout(x, keep_mask(shape, 1.0 - rate, generator,
                                      x.device), rate)


def drop_path_keep(rate: float) -> np.float32:
    """``1 - jnp.asarray(rate, float32)``, in f32 as the JAX DropPath."""
    return np.float32(1.0) - np.float32(rate)


def drop_path_scale(mask: torch.Tensor, rate: float, dtype) -> torch.Tensor:
    """The per-sample stochastic-depth factor the fused kernels take as
    ``dp`` (JAX ``DropPath(return_mask=True)``): ``where(mask, 1/keep, 0)``
    with 1/keep in f32, rounded to ``dtype`` (the block input's), as f32."""
    inv = _in_dtype(float(np.float32(1.0) / drop_path_keep(rate)), dtype)
    return torch.where(mask, inv, 0.0).float()


def apply_drop_path(y: torch.Tensor, mask: torch.Tensor, rate: float
                    ) -> torch.Tensor:
    """JAX ``DropPath`` applied to a branch output ``y`` [B, ...]:
    ``where(mask, y / keep.astype(y.dtype), 0)`` — a divide in y's dtype."""
    keep = _in_dtype(float(drop_path_keep(rate)), y.dtype)
    m = mask.view(-1, *([1] * (y.dim() - 1)))
    return torch.where(m, y / keep, 0.0)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=torch.float32))


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
    """'SAME'-padded conv of NHWC ``x`` with OIHW ``w`` (already in the
    compute dtype; ``[O, I/groups, kh, kw]`` when grouped, as flax's
    ``feature_group_count``); returns NHWC."""
    kh, kw = w.shape[-2:]
    ph = _same_pads(x.shape[1], kh, stride)
    pw = _same_pads(x.shape[2], kw, stride)
    if ph[0] != ph[1] or pw[0] != pw[1]:
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
        pad = 0
    else:
        pad = (ph[0], pw[0])
    w = w.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, stride, pad, 1, groups)
    return y.permute(0, 2, 3, 1)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm``: f32 stats (fast variance, clamped at 0),
    ``(x - mu) * (rsqrt(var + eps) * scale) + bias``, cast to out_dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * scale) + bias
    return y.to(out_dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` with 'SAME' padding: OIHW kernel, optional bias,
    ``groups`` (flax ``feature_group_count``), compute in ``dtype`` (output
    in ``dtype``)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True, groups: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.dtype = dtype
        self.kernel = _param(features, cin // groups, kernel_size,
                             kernel_size)
        self.bias = _param(features) if use_bias else None

    def _init(self, g):
        o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kh * kw, g)

    def forward(self, x):
        y = conv_nhwc(x.to(self.dtype), self.kernel.to(self.dtype),
                      self.stride, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Dense(nn.Module):
    """flax ``nn.Dense`` with f32 params: kernel [out, in] (lecun normal),
    bias [out] (zeros). ``forward`` computes in the input's dtype (the MoE
    router, f32); the Swin and ViT blocks hand the params to their fused
    branches instead."""

    def __init__(self, cin: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = _param(features, cin)
        self.bias = _param(features) if use_bias else None

    def _init(self, g):
        lecun_normal_(self.kernel, self.kernel.shape[1], g)

    def forward(self, x):
        return F.linear(x, self.kernel, self.bias)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(dtype=...)``: eps 1e-6, f32 stats with the fast
    variance, output in ``dtype``."""

    def __init__(self, channels: int, num_groups: int, dtype=torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = _param(channels)

    def forward(self, x):
        B, H, W, C = x.shape
        g = self.num_groups
        xf = x.float().reshape(B, H, W, g, C // g)
        mu = xf.mean((1, 2, 4), keepdim=True)
        var = torch.clamp((xf * xf).mean((1, 2, 4), keepdim=True) - mu * mu,
                          min=0.0)
        rs = torch.rsqrt(var + 1e-6).expand(B, 1, 1, g, C // g)
        mul = rs.reshape(B, 1, 1, C) * self.scale
        mu = mu.expand(B, 1, 1, g, C // g).reshape(B, 1, 1, C)
        return ((x.float() - mu) * mul + self.bias).to(self.dtype)


class ConvGNAct(nn.Module):
    """flax ``ConvGNAct``: a 'SAME' 3x3 conv without bias (stride 1 or
    2), GroupNorm in the compute dtype, SiLU. The submodules keep flax's
    auto names, ``Conv_0`` and ``GroupNorm_0``."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride=stride, use_bias=False,
                           dtype=dtype)
        self.GroupNorm_0 = GroupNorm(features, gn_groups(features),
                                     dtype=dtype)

    def forward(self, x):
        return F.silu(self.GroupNorm_0(self.Conv_0(x)))


class BankedConv(nn.Module):
    """Per-task 2D convolution bank. Kernel: [T, O, I, kh, kw]."""

    def __init__(self, num_banks: int, cin: int, features: int,
                 kernel_size: int = 3, use_bias: bool = True,
                 bias_init_value: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bias_init_value = float(bias_init_value)
        self.kernel = _param(num_banks, features, cin, kernel_size,
                             kernel_size)
        self.bias = _param(num_banks, features) if use_bias else None

    def _init(self, g):
        _, o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kh * kw, g)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.fill_(self.bias_init_value)

    def forward(self, x, idx):
        w = take(self.kernel, idx).to(self.dtype)
        y = conv_nhwc(x.to(self.dtype), w)
        if self.bias is not None:
            y = y + take(self.bias, idx).to(self.dtype)
        return y


class BankedDense(nn.Module):
    """Per-task dense bank. Kernel: [T, out, in]."""

    def __init__(self, num_banks: int, cin: int, features: int,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(num_banks, features, cin)
        self.bias = _param(num_banks, features) if use_bias else None

    def _init(self, g):
        lecun_normal_(self.kernel, self.kernel.shape[2], g)

    def forward(self, x, idx):
        # bf16 operands, f32 accumulation, rounded once to dtype
        y = F.linear(x.to(self.dtype), take(self.kernel, idx).to(self.dtype))
        if self.bias is not None:
            y = y + take(self.bias, idx).to(self.dtype)
        return y


class BankedGroupNorm(nn.Module):
    """Per-task GroupNorm bank: eps 1e-5, f32 two-pass stats, the
    normalize and affine in the input dtype."""

    def __init__(self, num_banks: int, channels: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(num_banks, channels))
        self.bias = _param(num_banks, channels)

    def forward(self, x, idx):
        dt = x.dtype
        B, H, W, C = x.shape
        g = self.num_groups
        xg = x.reshape(B, H, W, g, C // g)
        xf = xg.float()
        mean = xf.mean((1, 2, 4), keepdim=True)
        var = ((xf - mean) ** 2).mean((1, 2, 4), keepdim=True)
        rs = torch.rsqrt(var + 1e-5)
        xn = ((xg - mean.to(dt)) * rs.to(dt)).reshape(B, H, W, C)
        return xn * take(self.scale, idx).to(dt) + take(self.bias, idx).to(dt)


class BankedMLP(nn.Module):
    """Per-task MLP bank: dense + SiLU + dropout chain ending in a plain
    dense (dropout acts in train mode only)."""

    def __init__(self, num_banks: int, cin: int, hidden_dims: Sequence[int],
                 out_dim: int, dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        dims = [cin, *hidden_dims, out_dim]
        for i in range(len(dims) - 1):
            self.add_module(f"dense_{i}", BankedDense(
                num_banks, dims[i], dims[i + 1], dtype=dtype))
        self.n_layers = len(dims) - 1
        self.dropout = float(dropout)

    def forward(self, x, idx, train: bool = False, generator=None):
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x, idx)
            if i < self.n_layers - 1:
                x = dropout(F.silu(x), self.dropout, train, generator)
        return x


def _resize_nhwc(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    # jax.image.resize 'bilinear' on an upsample == half-pixel bilinear with
    # edge clamping (tests/test_torch_model.py holds the two equal)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def upsample_2x(x: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """2x spatial upsample, NHWC."""
    B, H, W, C = x.shape
    if method == "nearest":
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return _resize_nhwc(x, 2 * H, 2 * W)


def resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[1] == h and x.shape[2] == w:
        return x
    return _resize_nhwc(x, h, w)
