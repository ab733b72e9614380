"""Fused Swin attention and MLP branches: CUDA kernels, wrappers and their
plain PyTorch versions.

Port of ``fmc_uia_tpu/ops/swin_block_pallas.py`` (forward only):

  * ``attention_branch``: ``x + dp * proj(MHSA_window(LN1(x)))`` on the
    rolled, padded ``x`` [B, Hp, Wp, C] — kernel ``csrc/swin_attn_fwd.cu``.
  * ``mlp_branch``: ``x + dp * fc2(gelu_tanh(fc1(LN2(x))))`` on ``x``
    [B, H, W, C] — kernel ``csrc/swin_mlp_fwd.cu``.

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs the plain version (``*_reference``), which computes in f32
on values rounded to the compute dtype (``x.dtype``) at the same points as
the JAX kernel. Each wrapper counts its launches in ``.launches``.

Weights are the port's f32 params in PyTorch layout (``[out, in]``); the
kernels round them to the compute dtype themselves.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from fmc_uia_tpu_torch.ops import build

_LN_EPS = 1e-6
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    """Round to the compute dtype, keep computing in f32."""
    return t.to(dtype).float()


def _window_ln(xf: torch.Tensor, scale, bias, dtype) -> torch.Tensor:
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xh = (xf - mu) * torch.rsqrt(var + _LN_EPS)
    return _q(xh * scale + bias, dtype)


def _dp_scale(dp: Optional[torch.Tensor], B: int, x: torch.Tensor):
    if dp is None:
        return torch.ones(B, dtype=torch.float32, device=x.device)
    return dp.reshape(B).float()


# ---------------------------------------------------------------------------
# attention branch
# ---------------------------------------------------------------------------
def attention_branch_reference(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                               bproj, bias_hnn, mask, num_heads: int,
                               dp=None):
    """Plain version of ``_branch_math``. ``wqkv`` [3C, C], ``wproj``
    [C, C], ``bias_hnn`` [H, N, N], ``mask`` [nW, N, N] (or broadcastable,
    or None), ``dp`` [B] or None."""
    cd = x.dtype
    B, Hp, Wp, C = x.shape
    N = bias_hnn.shape[-1]
    ws = math.isqrt(N)
    H, dh = num_heads, C // num_heads
    nh, nw = Hp // ws, Wp // ws
    nW = nh * nw
    xw = x.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
    xn = _window_ln(xw.reshape(B, nW, N, C).float(), ln_scale, ln_bias, cd)
    qkv = _q(xn @ _q(wqkv, cd).t() + bqkv, cd)

    def heads(t):  # [B, nW, N, C] -> [B, H, nW, N, dh]
        return t.reshape(B, nW, N, H, dh).permute(0, 3, 1, 2, 4)

    q, k, v = (heads(t) for t in qkv.split(C, dim=-1))
    scale = _q(torch.tensor(dh ** -0.5), cd).to(x.device)
    s = _q(q * scale, cd) @ k.transpose(-1, -2)
    s = s + bias_hnn[None, :, None].float()
    if mask is not None:
        s = s + mask[None, None].float()
    p = _q(torch.softmax(s, dim=-1), cd)
    o = _q(p @ v, cd).permute(0, 2, 3, 1, 4).reshape(B, nW, N, C)
    y = _q(o @ _q(wproj, cd).t() + bproj, cd)
    y = y.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(B, Hp, Wp, C)
    dpc = _q(_dp_scale(dp, B, x), cd).view(B, 1, 1, 1)
    return (x.float() + _q(dpc * y, cd)).to(cd)


def _f32_on(t, device, shape, what):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{what}: need float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: kernels read 16-byte vectors; the data "
                         "pointer is not 16-byte aligned")
    return t


def _check_x(x: torch.Tensor, ndim: int):
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != ndim or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"kernel needs a contiguous, 16-byte aligned "
                         f"{ndim}-d tensor, got shape {tuple(x.shape)}")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def attention_branch(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                     bias_hnn, mask, num_heads: int, dp=None):
    """Fused attention branch on the rolled, padded ``x`` [B, Hp, Wp, C];
    returns the block's first half (residual included). CPU tensors take
    the plain version; CUDA tensors launch ``swin_attn_fwd``."""
    if x.device.type == "cpu":
        return attention_branch_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                          wproj, bproj, bias_hnn, mask,
                                          num_heads, dp)
    _check_x(x, 4)
    B, Hp, Wp, C = x.shape
    N = bias_hnn.shape[-1]
    ws = math.isqrt(N)
    if ws * ws != N or N > 64:
        raise ValueError(f"window of {N} tokens: need ws*ws with ws <= 8")
    if Hp % ws or Wp % ws:
        raise ValueError(f"padded grid ({Hp},{Wp}) not divisible by {ws}")
    if C % num_heads or C // num_heads > 32:
        raise ValueError(f"C={C}, heads={num_heads}: need head dim <= 32")
    if x.dtype == torch.bfloat16 and (C % 16 or (C // num_heads) % 16):
        raise ValueError(f"bf16 kernel: C={C} and head dim "
                         f"{C // num_heads} must be multiples of 16")
    dev = x.device
    args = [_f32_on(t, dev, shape, what) for t, shape, what in (
        (ln_scale, (C,), "ln_scale"), (ln_bias, (C,), "ln_bias"),
        (wqkv, (3 * C, C), "wqkv"), (bqkv, (3 * C,), "bqkv"),
        (wproj, (C, C), "wproj"), (bproj, (C,), "bproj"),
        (bias_hnn, (num_heads, N, N), "bias_hnn"))]
    nW = (Hp // ws) * (Wp // ws)
    if mask is not None:
        mask = _f32_on(mask.expand(nW, N, N), dev, (nW, N, N), "mask")
    if dp is not None:
        dp = _f32_on(dp.reshape(B), dev, (B,), "dp")
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    rc = build.load("swin_attn_fwd")(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        *[t.data_ptr() for t in args], _ptr(mask), _ptr(dp),
        (C // num_heads) ** -0.5, B, Hp, Wp, C, num_heads, ws,
        int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"swin_attn_fwd launch failed: CUDA error {rc}")
    attention_branch.launches += 1
    return out


attention_branch.launches = 0


# ---------------------------------------------------------------------------
# MLP branch
# ---------------------------------------------------------------------------
def mlp_branch_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, dp=None):
    """Plain version of ``_mlp_math`` on ``x`` [B, H, W, C]; ``w1``
    [4C, C], ``w2`` [C, 4C], ``dp`` [B] or None."""
    cd = x.dtype
    B = x.shape[0]
    xf = x.float()
    xn = _window_ln(xf, ln_scale, ln_bias, cd)
    h = xn @ _q(w1, cd).t() + b1
    h = _q(F.gelu(h, approximate="tanh"), cd)
    y = _q(h @ _q(w2, cd).t() + b2, cd)
    dpc = _q(_dp_scale(dp, B, x), cd).view(B, 1, 1, 1)
    return (xf + _q(dpc * y, cd)).to(cd)


def mlp_branch(x, ln_scale, ln_bias, w1, b1, w2, b2, dp=None):
    """Fused MLP branch on ``x`` [B, H, W, C] (residual included). CPU
    tensors take the plain version; CUDA tensors launch ``swin_mlp_fwd``."""
    if x.device.type == "cpu":
        return mlp_branch_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, dp)
    _check_x(x, 4)
    B, H, W, C = x.shape
    Ch = w1.shape[0]
    dev = x.device
    args = [_f32_on(t, dev, shape, what) for t, shape, what in (
        (ln_scale, (C,), "ln_scale"), (ln_bias, (C,), "ln_bias"),
        (w1, (Ch, C), "w1"), (b1, (Ch,), "b1"),
        (w2, (C, Ch), "w2"), (b2, (C,), "b2"))]
    if dp is not None:
        dp = _f32_on(dp.reshape(B), dev, (B,), "dp")
    if x.dtype == torch.bfloat16 and (C % 32 or C > 256):
        raise ValueError(f"bf16 kernel: C={C} must be a multiple of 32 and "
                         "at most 256")
    out = torch.empty_like(x)
    # a C whose block would need more shared memory than the card allows
    # fails in the launcher (cudaFuncSetAttribute) and raises below
    rc = build.load("swin_mlp_fwd")(
        x.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in args],
        _ptr(dp), B * H * W, C, Ch, H * W,
        int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"swin_mlp_fwd launch failed: CUDA error {rc}")
    mlp_branch.launches += 1
    return out


mlp_branch.launches = 0
