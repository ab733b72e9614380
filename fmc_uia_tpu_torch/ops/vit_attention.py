"""Global (full) attention of the ViT/DINOv3 encoders: CUDA kernels, their
wrappers and plain PyTorch versions, forward and backward.

Port of ``fmc_uia_tpu/ops/vit_attention.py``, whose ``global_attention``
runs the Pallas TPU flash-attention library kernel (forward, and its
dK/dV and dQ backward kernels) on sequences padded to a multiple of 512
with the pad tokens in a second segment:

  * ``global_attention(q, k, v, sm_scale)`` on q, k, v [B, H, N, dh]:
    forward kernel ``csrc/vit_flash_fwd.cu`` (K4f), backward kernel
    ``csrc/vit_flash_bwd.cu`` (K4b), as a ``torch.autograd.Function``.

The semantics are the TPU kernel's, not the XLA einsum's (which rounds
``q * scale`` to the compute dtype first): ``q k^T`` accumulated in f32,
then multiplied by ``sm_scale``; softmax with f32 max and sum; the
unnormalized ``p`` rounded to ``v``'s dtype before ``p v``; f32
accumulation, the output rounded to the input dtype. For the real rows the
second pad segment equals masking keys >= N, which the kernels do without
padding. The forward also returns the per-row log-sum-exp (f32 [B, H, N]);
the backward recomputes ``p`` from it and takes ``di = rowsum(o * do)``
in f32, as the JAX VJP does. The kernels take dh = 64 (every ViT variant
but the test-size ``vit_nano``).

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs the plain version (``*_reference``). Each wrapper counts
its launches in ``.launches`` and, while spans are recorded, times each
launch path in a span of its kernel's name (``kernel.K4f``,
``kernel.K4b``). On the card the outputs and grads are laid
out [B, N, H, dh] and returned as [B, H, N, dh] views, so the block's
reshape back to [B, N, C] costs nothing; the inputs may be column slices
of the qkv projection (any strides with a contiguous last axis and
16-byte multiples, which the bf16 kernels' TMA maps take as they lie:
``tma_layout``; others are copied).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fmc_uia_tpu_torch.ops import build
from fmc_uia_tpu_torch.utils.profiling import span

KERNEL_DH = 64
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(dtype) -> torch.dtype:
    """f32 accumulation, f64 for f64 inputs (the gradient check)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    """Round to ``dtype``, keep computing in the accumulation dtype."""
    return t.to(dtype).to(_acc_dtype(dtype))


def global_attention_reference(q, k, v, sm_scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4f: returns (o [B, H, N, dh] in q's dtype, lse
    [B, H, N] in the accumulation dtype). Products of values in the input
    dtype, summed in f32 (f64 for f64 inputs)."""
    acc = _acc_dtype(q.dtype)
    s = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * sm_scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (_q(p, v.dtype) @ v.to(acc)) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def global_attention_backward_reference(q, k, v, o, lse, do, sm_scale: float
                                        ) -> Tuple[torch.Tensor, ...]:
    """Plain version of K4b: (dq, dk, dv) in q's dtype, rounding where the
    TPU backward casts (p before ``p^T do``, ds before ``ds^T q`` and
    ``ds k``)."""
    dt = q.dtype
    acc = _acc_dtype(dt)
    qa, ka, va, da = (t.to(acc) for t in (q, k, v, do))
    p = torch.exp((qa @ ka.transpose(-1, -2)) * sm_scale
                  - lse.to(acc)[..., None])
    dv = _q(p, dt).transpose(-1, -2) @ da
    dp = da @ va.transpose(-1, -2)
    di = (o.to(acc) * da).sum(-1, keepdim=True)
    ds = _q((dp - di) * p * sm_scale, dt)
    dq = ds @ ka
    dk = ds.transpose(-1, -2) @ qa
    return dq.to(dt), dk.to(dt), dv.to(dt)


def tma_layout(t: torch.Tensor):
    """The TMA geometry of a [B, H, N, dh] view as the bf16 kernels encode
    their tensor maps (``csrc/vit_flash_sm90.cuh`` ``make_map``): the dims
    innermost first, (dh, N, H, B), and the byte strides of N, H and B.
    Raises ``ValueError`` on what TMA cannot take: a last axis that is not
    contiguous, a base address or a stride that is not a multiple of 16
    bytes, or a stride of 2^40 bytes or more. The f32 kernels read rows
    with 16-byte loads and take the same views."""
    if t.dim() != 4:
        raise ValueError(f"TMA view: [B, H, N, dh], got {tuple(t.shape)}")
    B, H, N, dh = t.shape
    es = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"TMA view: last axis stride {t.stride(-1)} != 1")
    if t.data_ptr() % 16:
        raise ValueError(f"TMA view: base address {t.data_ptr():#x} not "
                         "16-byte aligned")
    strides = tuple(s * es for s in (t.stride(2), t.stride(1), t.stride(0)))
    for name, sb in zip("nhb", strides):
        if sb % 16 or not 0 <= sb < 2 ** 40:
            raise ValueError(f"TMA view: {name} stride of {sb} bytes (a "
                             "multiple of 16 below 2^40 needed)")
    return (dh, N, H, B), strides


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can read it as it lies, else a fresh contiguous
    copy (new storage, so aligned even where ``t`` was a misaligned but
    contiguous slice)."""
    try:
        tma_layout(t)
    except ValueError:
        t = t.clone(memory_format=torch.contiguous_format)
        tma_layout(t)
    return t


def _kernel_view(t: torch.Tensor, shape, dtype, what) -> torch.Tensor:
    """A [B, H, N, dh] ``t`` as the kernels read it: CUDA, ``dtype``,
    ``shape``, and a TMA-ready layout (``tma_ready``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: kernel needs a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {t.dtype} {tuple(t.shape)} != "
                         f"{dtype} {tuple(shape)}")
    return tma_ready(t)


def _check_qkv(q, k, v):
    if q.dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] != KERNEL_DH:
        raise ValueError(f"kernel takes [B, H, N, {KERNEL_DH}], got "
                         f"{tuple(q.shape)}")
    return [_kernel_view(t, q.shape, q.dtype, w)
            for t, w in ((q, "q"), (k, "k"), (v, "v"))]


def _bnhd(q: torch.Tensor) -> torch.Tensor:
    """An empty [B, H, N, dh] view of a contiguous [B, N, H, dh] tensor."""
    B, H, N, dh = q.shape
    return torch.empty((B, N, H, dh), dtype=q.dtype,
                       device=q.device).permute(0, 2, 1, 3)


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# the entry points' own codes beside CUDA's (csrc/vit_flash_sm90.cuh)
_OWN_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
               -2: "cuTensorMapEncodeTiled refused a tensor map"}


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_OWN_ERRORS.get(rc, f'CUDA error {rc}')}")


def global_attention_forward(q, k, v, sm_scale: float):
    """K4f: (o, lse) of ``global_attention`` at q, k, v. CPU tensors take
    the plain version; CUDA tensors launch ``vit_flash_fwd``, counted in
    ``global_attention.launches``."""
    if q.device.type == "cpu":
        return global_attention_reference(q, k, v, sm_scale)
    with span("kernel.K4f"):
        q, k, v = _check_qkv(q, k, v)
        B, H, N, dh = q.shape
        o = _bnhd(q)
        lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
        rc = build.load("vit_flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _strides(q, k, v, o), sm_scale, B, H, N, dh,
            int(q.dtype == torch.bfloat16), _stream(q))
        _raise_on(rc, "vit_flash_fwd")
        global_attention.launches += 1
        return o, lse


def global_attention_backward(q, k, v, o, lse, do, sm_scale: float):
    """K4b: (dq, dk, dv) of ``global_attention`` at q, k, v for the
    cotangent ``do``, given the forward's output and lse. CPU tensors take
    the plain version; CUDA tensors launch ``vit_flash_bwd``."""
    if q.device.type == "cpu":
        return global_attention_backward_reference(q, k, v, o, lse, do,
                                                   sm_scale)
    with span("kernel.K4b"):
        q, k, v = _check_qkv(q, k, v)
        o = _kernel_view(o, q.shape, q.dtype, "o")
        do = _kernel_view(do, q.shape, q.dtype, "do")
        B, H, N, dh = q.shape
        if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, N):
            raise ValueError(f"lse: {lse.dtype} {tuple(lse.shape)} != "
                             f"float32 {(B, H, N)}")
        lse = lse.contiguous()
        # f32 workspace: lse * log2(e) and di = rowsum(o * do), rows padded
        ws = torch.empty(build.load(
            "vit_flash_bwd", "vit_flash_bwd_workspace")(B, H, N) // 4,
            dtype=torch.float32, device=q.device)
        dq, dk, dv = _bnhd(q), _bnhd(q), _bnhd(q)
        rc = build.load("vit_flash_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), ws.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, o, do, dq, dk, dv),
            sm_scale, B, H, N, dh, int(q.dtype == torch.bfloat16), _stream(q))
        _raise_on(rc, "vit_flash_bwd")
        global_attention_backward.launches += 1
        return dq, dk, dv


global_attention_backward.launches = 0


class _GlobalAttentionFn(torch.autograd.Function):
    """K4f forward, K4b backward (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = global_attention_forward(q, k, v, sm_scale)
        ctx.sm_scale = sm_scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*global_attention_backward(q, k, v, o, lse, do,
                                           ctx.sm_scale), None)


def global_attention(q, k, v, sm_scale: float) -> torch.Tensor:
    """Full attention over q, k, v [B, H, N, dh] -> [B, H, N, dh],
    differentiable in q, k and v. CPU tensors take the plain versions;
    CUDA tensors launch ``vit_flash_fwd`` forward and ``vit_flash_bwd``
    backward."""
    return _GlobalAttentionFn.apply(q, k, v, float(sm_scale))


global_attention.launches = 0
