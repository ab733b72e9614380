"""Fused Swin attention and MLP branches: CUDA kernels, wrappers and their
plain PyTorch versions, forward and backward.

Port of ``fmc_uia_tpu/ops/swin_block_pallas.py``:

  * ``attention_branch``: ``x + dp * proj(MHSA_window(LN1(x)))`` on the
    rolled, padded ``x`` [B, Hp, Wp, C] — forward kernel
    ``csrc/swin_attn_fwd.cu``, backward kernel ``csrc/swin_attn_bwd.cu``
    (the analytic pullback ``_branch_pullback``).
  * ``mlp_branch``: ``x + dp * fc2(gelu_tanh(fc1(LN2(x))))`` on ``x``
    [B, H, W, C] — forward ``csrc/swin_mlp_fwd.cu``, backward
    ``csrc/swin_mlp_bwd.cu`` (``_mlp_pullback``).

Both are ``torch.autograd.Function``s: the backward returns dx (identity
path included) and f32 grads of the LayerNorm, weights, biases and the
expanded rel-pos bias; ``mask`` and ``dp`` get none. A wrapper given a CUDA
tensor launches its kernel or raises; given a CPU tensor it runs the plain
version (``*_reference``), which computes in f32 on values rounded to the
compute dtype (``x.dtype``) at the same points as the JAX kernel. Each
wrapper counts its launches in ``.launches``.

Weights are the port's f32 params in PyTorch layout (``[out, in]``); the
kernels round them to the compute dtype themselves (bf16: into a bf16
workspace that TMA reads, once per launch).

The bf16 kernels run on Hopper's TMA and wgmma (``csrc/sm90_gemm.cuh``,
``csrc/swin_attn_sm90.cuh``). What they take from the host is computed
here, where the CPU tests hold it: the window box of the [B, Hp, Wp, C]
tensor maps (``window_tma_layout``), the head groups of the window
kernels (``head_groups``), the token slots of K1b's and K2b's split-K
weight gradients (``split_k_plan``), K2b's launch plan and workspace
(``mlp_bwd_plan``) and the widths the MLP kernels take
(``mlp_kernel_dims``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from fmc_uia_tpu_torch.ops import build

_LN_EPS = 1e-6
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_GELU_K = math.sqrt(2.0 / math.pi)
MAX_WINDOW = 8  # K1's largest window: ws * ws <= 64 tokens


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    """Round to the compute dtype, keep computing in f32."""
    return t.to(dtype).float()


def _ln_stats(xf: torch.Tensor):
    """f32 LayerNorm statistics (flax fast variance): (xh, rstd)."""
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + _LN_EPS)
    return (xf - mu) * rstd, rstd


def _window_ln(xf: torch.Tensor, scale, bias, dtype) -> torch.Tensor:
    xh, _ = _ln_stats(xf)
    return _q(xh * scale + bias, dtype)


def _ln_backward(dxn, xh, rstd, scale):
    """Pullback of ``xh * scale + bias`` through the f32 LayerNorm over the
    last axis: (dxf, dscale, dbias), grads summed over every other axis."""
    dims = tuple(range(dxn.dim() - 1))
    dg = (dxn * xh).sum(dims)
    db = dxn.sum(dims)
    dxh = dxn * scale
    dxf = (dxh - dxh.mean(-1, keepdim=True)
           - xh * (dxh * xh).mean(-1, keepdim=True)) * rstd
    return dxf, dg, db


def _dp_scale(dp: Optional[torch.Tensor], B: int, x: torch.Tensor):
    if dp is None:
        return torch.ones(B, dtype=torch.float32, device=x.device)
    return dp.reshape(B).float()


# ---------------------------------------------------------------------------
# attention branch
# ---------------------------------------------------------------------------
def _windows(t, ws):
    """[B, Hp, Wp, C] -> [B, nW, N, C] in window order, and back."""
    B, Hp, Wp, C = t.shape
    nh, nw = Hp // ws, Wp // ws
    t = t.reshape(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, nh * nw, ws * ws, C)


def _unwindows(t, ws, Hp, Wp):
    B, _, _, C = t.shape
    nh, nw = Hp // ws, Wp // ws
    t = t.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, Hp, Wp, C)


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
    nW = (Hp // ws) * (Wp // ws)
    xn = _window_ln(_windows(x, ws).float(), ln_scale, ln_bias, cd)
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
    y = _unwindows(y, ws, Hp, Wp)
    dpc = _q(_dp_scale(dp, B, x), cd).view(B, 1, 1, 1)
    return (x.float() + _q(dpc * y, cd)).to(cd)


def attention_branch_backward_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                        wproj, bproj, bias_hnn, mask,
                                        num_heads: int, dy, dp=None):
    """Plain version of ``_branch_pullback``: recomputes the forward, then
    the analytic pullback, rounding to the compute dtype where the JAX
    pullback casts (dy * dp; do; dq, dk, dv; ds once, as dsb; dx before the
    bf16 identity-path add). Returns (dx, dln_scale, dln_bias, dwqkv
    [3C, C], dbqkv, dwproj [C, C], dbproj, dbias [H, N, N]), the grads in
    f32. ``dp`` enters the pullback unrounded, as the kernel reads it."""
    cd = x.dtype
    B, Hp, Wp, C = x.shape
    N = bias_hnn.shape[-1]
    ws = math.isqrt(N)
    H, dh = num_heads, C // num_heads
    nW = (Hp // ws) * (Wp // ws)

    def heads(t):  # [B, nW, N, C] -> [B, H, nW, N, dh]
        return t.reshape(B, nW, N, H, dh).permute(0, 3, 1, 2, 4)

    def unheads(t):  # [B, H, nW, N, dh] -> [B, nW, N, C]
        return t.permute(0, 2, 3, 1, 4).reshape(B, nW, N, C)

    # recompute the forward (the casts of _branch_math)
    xh, rstd = _ln_stats(_windows(x, ws).float())
    xn = _q(xh * ln_scale + ln_bias, cd)
    wq = _q(wqkv, cd)
    q, k, v = (heads(t) for t in _q(xn @ wq.t() + bqkv, cd).split(C, -1))
    scale = _q(torch.tensor(dh ** -0.5), cd).to(x.device)
    qb = _q(q * scale, cd)
    s = qb @ k.transpose(-1, -2) + bias_hnn[None, :, None].float()
    if mask is not None:
        s = s + mask[None, None].float()
    pf = torch.softmax(s, dim=-1)
    p = _q(pf, cd)
    o = unheads(_q(p @ v, cd))

    # pullback
    dpv = _dp_scale(dp, B, x).view(B, 1, 1, 1)
    dyf = _q(_windows(dy, ws).float() * dpv, cd)
    flat = (-1, C)
    dbproj = dyf.sum((0, 1, 2))
    dwproj = dyf.reshape(flat).t() @ o.reshape(flat)
    dob = heads(_q(dyf @ _q(wproj, cd), cd))
    dv = p.transpose(-1, -2) @ dob
    dpm = dob @ v.transpose(-1, -2)
    ds = pf * (dpm - (dpm * pf).sum(-1, keepdim=True))
    dbias = ds.sum((0, 2))
    dsb = _q(ds, cd)
    dq = _q(unheads(_q(dsb @ k, cd)) * scale, cd)
    dk = unheads(_q(dsb.transpose(-1, -2) @ qb, cd))
    dqkv = torch.cat([dq, dk, unheads(_q(dv, cd))], dim=-1)
    dbqkv = dqkv.sum((0, 1, 2))
    dwqkv = dqkv.reshape(-1, 3 * C).t() @ xn.reshape(flat)
    dxf, dg, db = _ln_backward(dqkv @ wq, xh, rstd, ln_scale)
    dx = _unwindows(dxf, ws, Hp, Wp).to(cd) + dy.to(cd)
    return dx, dg, db, dwqkv, dbqkv, dwproj, dbproj, dbias


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


def _check_dy(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cotangent may arrive strided from the roll/crop backward: make
    it contiguous (a fresh, 16-byte aligned allocation)."""
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} on {dy.device} "
                         f"does not match x {x.dtype} {tuple(x.shape)}")
    dy = dy.contiguous()
    _check_x(dy, x.dim())
    return dy


# the Hopper GEMM's tile (csrc/sm90_gemm.cuh kGemmM, kGemmN, kGemmK) and
# the split-K budget: at most 256 slot tiles of 128 x 128 f32 partials
# (16 MB), at least 1024 tokens a slot
GEMM_M, GEMM_N, GEMM_K = 128, 128, 64
SPLIT_TILES, SPLIT_MIN_K = 256, 1024


def window_tma_layout(t: torch.Tensor, ws: int):
    """The rank-4 TMA map the bf16 K1 kernels encode for a [B, Hp, Wp, C]
    bf16 grid (``make_map_window``): dims innermost first (C, Wp, Hp, B),
    the byte strides of Wp, Hp and B, and the box (64, ws, ws, 1) that
    brings one window's N = ws^2 tokens as N rows of 64 channels. Raises
    ``ValueError`` on what TMA cannot take: not bf16, a channel axis that
    is not contiguous, a base or a stride that is not a multiple of 16
    bytes (C % 8 != 0), a stride of 2^40 bytes or more, or a grid that
    windows of ws do not tile."""
    if t.dim() != 4:
        raise ValueError(f"TMA grid: [B, Hp, Wp, C], got {tuple(t.shape)}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"TMA grid: bfloat16, got {t.dtype}")
    B, Hp, Wp, C = t.shape
    if not 1 <= ws <= 8 or Hp % ws or Wp % ws:
        raise ValueError(f"TMA grid: windows of {ws} do not tile "
                         f"({Hp}, {Wp})")
    if t.stride(-1) != 1:
        raise ValueError(f"TMA grid: channel stride {t.stride(-1)} != 1")
    if t.data_ptr() % 16:
        raise ValueError(f"TMA grid: base address {t.data_ptr():#x} not "
                         "16-byte aligned")
    es = t.element_size()
    strides = tuple(st * es for st in (t.stride(2), t.stride(1),
                                       t.stride(0)))
    for name, sb in zip(("Wp", "Hp", "B"), strides):
        if sb % 16 or not 0 < sb < 2 ** 40:
            raise ValueError(f"TMA grid: {name} stride of {sb} bytes (a "
                             "multiple of 16 below 2^40 needed)")
    return (C, Wp, Hp, B), strides, (64, ws, ws, 1)


def head_groups(C: int, num_heads: int):
    """(G, groups): heads per group (64 / dh, so that a group's q, k or v
    is 64 channels: group g's are channels p C + 64 g .. + 63 of qkv, p =
    0, 1, 2) and groups (heads padded up to a multiple of G)."""
    dh = C // num_heads
    if dh not in (16, 32):
        raise ValueError(f"head dim {dh}: the bf16 kernels take 16 or 32")
    G = 64 // dh
    return G, -(-num_heads // G)


def split_k_plan(M: int, N: int, K: int):
    """The token slots of a split-K weight gradient (M x N over K tokens),
    as ``gemm_run`` runs it: (kchunk, slots). Slot z covers tokens
    [z kchunk, min(K, (z + 1) kchunk)); kchunk is a multiple of GEMM_K;
    slots x tiles stays within SPLIT_TILES (the partials within 16 MB)
    and a slot holds at least SPLIT_MIN_K tokens where K allows. The
    slots are added in index order (reduce_slots)."""
    tiles = -(-M // GEMM_M) * -(-N // GEMM_N)
    s = max(1, min(SPLIT_TILES // tiles, -(-K // SPLIT_MIN_K)))
    per = -(-K // s)  # tokens a slot, then rounded up to whole chunks
    kchunk = -(-per // GEMM_K) * GEMM_K
    return kchunk, -(-K // kchunk)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _attn_kernel_args(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                      bias_hnn, mask, num_heads, dp):
    """Checks shared by K1f and K1b; returns (f32 params, mask, dp)."""
    _check_x(x, 4)
    B, Hp, Wp, C = x.shape
    N = bias_hnn.shape[-1]
    ws = math.isqrt(N)
    if ws * ws != N or ws > MAX_WINDOW:
        raise ValueError(f"window of {N} tokens: need ws*ws with ws <= "
                         f"{MAX_WINDOW}")
    if Hp % ws or Wp % ws:
        raise ValueError(f"padded grid ({Hp},{Wp}) not divisible by {ws}")
    if C % num_heads or C // num_heads > 32:
        raise ValueError(f"C={C}, heads={num_heads}: need head dim <= 32")
    if x.dtype == torch.bfloat16:
        head_groups(C, num_heads)  # head dim 16 or 32
        window_tma_layout(x, ws)   # the workspace grids are laid out as x
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
    return args, mask, dp


_workspace_bytes = {}


def _workspace(lib, *dims) -> int:
    """Bytes of ``lib``'s scratch for ``dims``, asked once per shape."""
    key = (lib, dims)
    if key not in _workspace_bytes:
        _workspace_bytes[key] = build.load(lib, lib + "_workspace")(*dims)
    return _workspace_bytes[key]


def _attention_forward(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                       bias_hnn, mask, num_heads: int, dp=None):
    if x.device.type == "cpu":
        return attention_branch_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                          wproj, bproj, bias_hnn, mask,
                                          num_heads, dp)
    args, mask, dp = _attn_kernel_args(x, ln_scale, ln_bias, wqkv, bqkv,
                                       wproj, bproj, bias_hnn, mask,
                                       num_heads, dp)
    B, Hp, Wp, C = x.shape
    ws = math.isqrt(bias_hnn.shape[-1])
    bf = int(x.dtype == torch.bfloat16)
    out = torch.empty_like(x)
    nbytes = _workspace("swin_attn_fwd", B, Hp, Wp, C, num_heads, ws, bf)
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    rc = build.load("swin_attn_fwd")(
        x.data_ptr(), out.data_ptr(), work.data_ptr(),
        *[t.data_ptr() for t in args], _ptr(mask), _ptr(dp),
        (C // num_heads) ** -0.5, B, Hp, Wp, C, num_heads, ws, bf,
        _stream(x))
    if rc != 0:
        raise RuntimeError(f"swin_attn_fwd launch failed: CUDA error {rc}")
    attention_branch.launches += 1
    return out


def attention_branch_backward(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                              bproj, bias_hnn, mask, num_heads: int, dy,
                              dp=None):
    """K1b: the pullback of ``attention_branch`` at ``x`` for the
    cotangent ``dy``; returns what ``attention_branch_backward_reference``
    returns. CPU tensors take the plain version; CUDA tensors launch
    ``swin_attn_bwd``."""
    if x.device.type == "cpu":
        return attention_branch_backward_reference(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias_hnn, mask,
            num_heads, dy, dp)
    args, mask, dp = _attn_kernel_args(x, ln_scale, ln_bias, wqkv, bqkv,
                                       wproj, bproj, bias_hnn, mask,
                                       num_heads, dp)
    dy = _check_dy(dy, x)
    B, Hp, Wp, C = x.shape
    N = bias_hnn.shape[-1]
    ws = math.isqrt(N)
    bf = int(x.dtype == torch.bfloat16)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    grads = [torch.empty(shape, **f32) for shape in (
        (C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,),
        (num_heads, N, N))]
    dx = torch.empty_like(x)
    T = B * Hp * Wp
    kchunks = (split_k_plan(C, C, T)[0], split_k_plan(3 * C, C, T)[0])
    nbytes = _workspace("swin_attn_bwd", B, Hp, Wp, C, num_heads, ws, bf,
                        *kchunks)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rc = build.load("swin_attn_bwd")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        *[t.data_ptr() for t in args], _ptr(mask), _ptr(dp),
        *[g.data_ptr() for g in grads], work.data_ptr(),
        (C // num_heads) ** -0.5, B, Hp, Wp, C, num_heads, ws, bf,
        *kchunks, _stream(x))
    if rc != 0:
        raise RuntimeError(f"swin_attn_bwd launch failed: CUDA error {rc}")
    attention_branch_backward.launches += 1
    return (dx, *grads)


attention_branch_backward.launches = 0


class _AttentionBranchFn(torch.autograd.Function):
    """K1f forward, K1b backward (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                bias_hnn, mask, dp, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                              bproj, bias_hnn, mask, dp)
        return _attention_forward(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                  bproj, bias_hnn, mask, num_heads, dp)

    @staticmethod
    def backward(ctx, dy):
        (x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias_hnn, mask,
         dp) = ctx.saved_tensors
        grads = attention_branch_backward(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias_hnn, mask,
            ctx.num_heads, dy, dp)
        return (*grads, None, None, None)


def attention_branch(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                     bias_hnn, mask, num_heads: int, dp=None):
    """Fused attention branch on the rolled, padded ``x`` [B, Hp, Wp, C];
    returns the block's first half (residual included), differentiable in
    ``x``, the LayerNorm, the weights and ``bias_hnn``. CPU tensors take
    the plain versions; CUDA tensors launch ``swin_attn_fwd`` forward and
    ``swin_attn_bwd`` backward."""
    return _AttentionBranchFn.apply(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                    bproj, bias_hnn, mask, dp, num_heads)


attention_branch.launches = 0


# ---------------------------------------------------------------------------
# MLP branch
# ---------------------------------------------------------------------------
def _gelu_and_grad(h: torch.Tensor):
    """jax.nn.gelu (tanh approximation) and its derivative, f32."""
    inner = _GELU_K * (h + 0.044715 * (h * h * h))
    t = torch.tanh(inner)
    g = h * (0.5 * (1.0 + t))
    dg = (0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * _GELU_K
          * (1.0 + 3.0 * 0.044715 * h * h))
    return g, dg


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


def mlp_branch_backward_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
                                  dp=None):
    """Plain version of ``_mlp_pullback``: recomputes the forward, then the
    analytic pullback, rounding where the JAX pullback casts (dy * dp; the
    GELU output; dh1 before its products, while db1 sums it in f32; dx
    before the bf16 identity-path add). Returns (dx, dln_scale, dln_bias,
    dw1 [4C, C], db1, dw2 [C, 4C], db2), the grads in f32."""
    cd = x.dtype
    B = x.shape[0]
    C = x.shape[-1]
    xh, rstd = _ln_stats(x.float().reshape(B, -1, C))
    xn = _q(xh * ln_scale + ln_bias, cd)
    w1c = _q(w1, cd)
    h1 = xn @ w1c.t() + b1
    g, dgelu = _gelu_and_grad(h1)
    dpv = _dp_scale(dp, B, x).view(B, 1, 1)
    dyc = _q(dy.float().reshape(B, -1, C) * dpv, cd)
    flat = (-1, C)
    db2 = dyc.sum((0, 1))
    dw2 = dyc.reshape(flat).t() @ _q(g, cd).reshape(-1, w1.shape[0])
    dh1 = dgelu * (dyc @ _q(w2, cd))
    db1 = dh1.sum((0, 1))
    dh1c = _q(dh1, cd)
    dw1 = dh1c.reshape(-1, w1.shape[0]).t() @ xn.reshape(flat)
    dxf, dg, db = _ln_backward(dh1c @ w1c, xh, rstd, ln_scale)
    dx = dxf.reshape(x.shape).to(cd) + dy.to(cd)
    return dx, dg, db, dw1, db1, dw2, db2


# K2b's dual product takes 128-token tiles: one db1 slot a tile
MLP_TILE = 128


def mlp_kernel_dims(C: int, Ch: int, dtype) -> None:
    """Raise ``ValueError`` on widths the MLP kernels do not take. bf16:
    C % 32 == 0 and C <= 256 (K2f keeps y, 64 x C in f32 a warpgroup, in
    registers, with wgmma widths that sum to C; K2b keeps a tile's xn and
    dyc in shared memory) and Ch % 64 == 0 (whole hidden chunks). f32:
    C <= 1024 (the pullback's rows of 32 lanes)."""
    if dtype == torch.bfloat16:
        if C % 32 or not 32 <= C <= 256 or Ch % 64 or Ch < 64:
            raise ValueError(f"bf16 MLP kernels: C={C}, Ch={Ch}: need C a "
                             "multiple of 32 up to 256 and Ch a multiple "
                             "of 64")
    elif not 1 <= C <= 1024 or Ch < 1:
        raise ValueError(f"f32 MLP kernels: C={C}, Ch={Ch}: need "
                         "1 <= C <= 1024")


def _rows_per_slot(rows: int, least: int) -> int:
    return max(-(-rows // 256), least)  # swin_bwd_common.cuh rows_per_slot


def _carve(pieces) -> int:
    """Bytes of a workspace carved as ``Carver`` does: (count, item bytes)
    pieces in order, each starting at a multiple of 256 bytes."""
    off = 0
    for n, size in pieces:
        off = -(-off // 256) * 256 + n * size
    return off


@functools.lru_cache(maxsize=None)
def mlp_bwd_plan(T: int, C: int, Ch: int):
    """K2b's bf16 launch plan over T tokens, as ``csrc/swin_mlp_bwd.cu``
    runs it: the split-K slots of dW1 [Ch, C] and dW2 [C, Ch] over the
    tokens (``split_k_plan``), db1's slots (one per 128-token tile of the
    dual product, ``tiles``) and the workspace bytes (``MlpBwdWorkBf16``,
    carved in the same order; the wrapper allocates them, and the launch
    refuses a buffer smaller than its own carving). Cached per shape:
    read it, do not change it."""
    kchunk_w1, slots_w1 = split_k_plan(Ch, C, T)
    kchunk_w2, slots_w2 = split_k_plan(C, Ch, T)
    tiles = -(-T // MLP_TILE)
    colsum = -(-T // _rows_per_slot(T, 512)) * C
    ln_parts = -(-T // _rows_per_slot(T, 64)) * C
    workspace = _carve([
        (Ch * C, 2), (C * Ch, 2),      # W1, W2 in bf16
        (T, 4), (T, 4),                # mu, rstd
        (T * C, 2), (T * C, 2),        # xn, dyc
        (T * Ch, 2), (T * Ch, 2),      # gc, dh1c
        (T * C, 4),                    # dxn
        (slots_w1 * Ch * C, 4), (slots_w2 * C * Ch, 4),
        (tiles * Ch, 4), (colsum, 4),  # db1, db2 partials
        (ln_parts, 4), (ln_parts, 4)])  # dLN scale, bias partials
    return dict(kchunk_w1=kchunk_w1, slots_w1=slots_w1,
                kchunk_w2=kchunk_w2, slots_w2=slots_w2, tiles=tiles,
                workspace=workspace)


def _mlp_kernel_args(x, ln_scale, ln_bias, w1, b1, w2, b2, dp):
    _check_x(x, 4)
    B, H, W, C = x.shape
    Ch = w1.shape[0]
    mlp_kernel_dims(C, Ch, x.dtype)
    dev = x.device
    args = [_f32_on(t, dev, shape, what) for t, shape, what in (
        (ln_scale, (C,), "ln_scale"), (ln_bias, (C,), "ln_bias"),
        (w1, (Ch, C), "w1"), (b1, (Ch,), "b1"),
        (w2, (C, Ch), "w2"), (b2, (C,), "b2"))]
    if dp is not None:
        dp = _f32_on(dp.reshape(B), dev, (B,), "dp")
    return args, dp


def _mlp_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, dp=None):
    if x.device.type == "cpu":
        return mlp_branch_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, dp)
    args, dp = _mlp_kernel_args(x, ln_scale, ln_bias, w1, b1, w2, b2, dp)
    B, H, W, C = x.shape
    Ch = w1.shape[0]
    bf = int(x.dtype == torch.bfloat16)
    out = torch.empty_like(x)
    # bf16: the bf16 copies of W1 and W2 that TMA reads
    work = torch.empty(_workspace("swin_mlp_fwd", C, Ch, bf),
                       dtype=torch.uint8, device=x.device)
    # an f32 C whose block would need more shared memory than the card
    # allows fails in the launcher (cudaFuncSetAttribute) and raises below
    rc = build.load("swin_mlp_fwd")(
        x.data_ptr(), out.data_ptr(), work.data_ptr(),
        *[t.data_ptr() for t in args], _ptr(dp), B * H * W, C, Ch, H * W,
        bf, _stream(x))
    if rc != 0:
        raise RuntimeError(f"swin_mlp_fwd launch failed: CUDA error {rc}")
    mlp_branch.launches += 1
    return out


def mlp_branch_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, dy, dp=None):
    """K2b: the pullback of ``mlp_branch`` at ``x`` for ``dy``; returns
    what ``mlp_branch_backward_reference`` returns. CPU tensors take the
    plain version; CUDA tensors launch ``swin_mlp_bwd``."""
    if x.device.type == "cpu":
        return mlp_branch_backward_reference(x, ln_scale, ln_bias, w1, b1,
                                             w2, b2, dy, dp)
    args, dp = _mlp_kernel_args(x, ln_scale, ln_bias, w1, b1, w2, b2, dp)
    dy = _check_dy(dy, x)
    B, H, W, C = x.shape
    Ch = w1.shape[0]
    bf = int(x.dtype == torch.bfloat16)
    dev = x.device
    grads = [torch.empty(shape, dtype=torch.float32, device=dev)
             for shape in ((C,), (C,), (Ch, C), (Ch,), (C, Ch), (C,))]
    dx = torch.empty_like(x)
    T = B * H * W
    # the split-K slots of dW1 and dW2 (bf16; ignored in f32)
    plan = mlp_bwd_plan(T, C, Ch)
    kchunks = (plan["kchunk_w1"], plan["kchunk_w2"])
    # bf16: the plan's bytes; the launch refuses fewer than it carves
    nbytes = (plan["workspace"] if bf
              else _workspace("swin_mlp_bwd", T, C, Ch, bf, *kchunks))
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rc = build.load("swin_mlp_bwd")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        *[t.data_ptr() for t in args], _ptr(dp),
        *[g.data_ptr() for g in grads], work.data_ptr(), nbytes,
        T, C, Ch, H * W, bf, *kchunks, _stream(x))
    if rc != 0:
        raise RuntimeError(f"swin_mlp_bwd launch failed: CUDA error {rc}")
    mlp_branch_backward.launches += 1
    return (dx, *grads)


mlp_branch_backward.launches = 0


class _MlpBranchFn(torch.autograd.Function):
    """K2f forward, K2b backward (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, dp):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, dp)
        return _mlp_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, dp)

    @staticmethod
    def backward(ctx, dy):
        return (*mlp_branch_backward(*ctx.saved_tensors[:7], dy,
                                     ctx.saved_tensors[7]), None)


def mlp_branch(x, ln_scale, ln_bias, w1, b1, w2, b2, dp=None):
    """Fused MLP branch on ``x`` [B, H, W, C] (residual included),
    differentiable in ``x``, the LayerNorm and the weights. CPU tensors
    take the plain versions; CUDA tensors launch ``swin_mlp_fwd`` forward
    and ``swin_mlp_bwd`` backward."""
    return _MlpBranchFn.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, dp)


mlp_branch.launches = 0
