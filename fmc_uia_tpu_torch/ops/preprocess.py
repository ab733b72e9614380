"""Fused photometric train preprocessing, K3 (port of
``fmc_uia_tpu/ops/preprocess_pallas.py``).

    uint8 [B, H, W, 3] -> brightness/contrast -> clip -> gaussian noise
                       -> clip -> (x - 255 mean) / (255 std) -> f32/bf16

in one pass over the batch: ``csrc/preprocess_fwd.cu`` on a CUDA tensor,
the plain version ``augment_normalize_reference`` on a CPU tensor. The TPU
kernel draws its noise from the core's hardware PRNG; here the bits are
Philox4x32-10 with the counter layout of the CUDA source's header
(counter (e >> 1, 0, 0, 0), key (seed, 0); even elements take words 0/1,
odd elements words 2/3), which ``philox4x32_10`` computes in plain
PyTorch, so kernel and plain version draw the same noise.

The per-image parameters (apply flags, alpha, beta, sigma, seed) are
drawn on the images' device from an explicit ``torch.Generator``, in the
order of the JAX function, and never leave the device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fmc_uia_tpu_torch.ops import build
from fmc_uia_tpu_torch.parallel import comm
from fmc_uia_tpu_torch.utils.profiling import span

_M = (0xD2511F53, 0xCD9E8D57)          # Philox4x32 multipliers
_W = (0x9E3779B9, 0xBB67AE85)          # Philox4x32 key increments
_MASK32 = 0xFFFFFFFF
_TWO_PI = float(2 * np.float32(np.pi))  # 2 pi as the f32 the kernels use
_INV24 = 1.0 / 16777216.0              # 2^-24
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32)
    and a 32-bit constant ``m``, by 16-bit limbs of ``m`` so that no int64
    product overflows."""
    t1 = a * (m & 0xFFFF)
    t2 = a * (m >> 16)
    s = (t1 >> 16) + t2
    return s >> 16, ((s & 0xFFFF) << 16) | (t1 & 0xFFFF)


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 (Random123) on int64 tensors holding 32-bit words:
    ``counter`` [..., 4] and ``key`` [..., 2], broadcast against each
    other; returns the four output words [..., 4]."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for r in range(10):
        if r:
            k0 = (k0 + _W[0]) & _MASK32
            k1 = (k1 + _W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M[0])
        hi1, lo1 = _mulhilo(c2, _M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), -1)


def _stats(mean, std, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """255 mean and 1 / (255 std) in f32, as the JAX function makes its
    rows."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(std, dtype=torch.float32, device=device)
    return mean * 255.0, 1.0 / (std * 255.0)


@functools.lru_cache(maxsize=16)
def _device_stats(mean: Tuple[float, ...], std: Tuple[float, ...],
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_stats`` made once per (mean, std, device) for the kernel: f32
    products and reciprocals round alike on the host and the card, so
    computing them on the host gives the same bits, and a call copies
    nothing to the card."""
    return tuple(t.to(device) for t in _stats(mean, std, "cpu"))


def box_muller(bits1: torch.Tensor, bits2: torch.Tensor) -> torch.Tensor:
    """The standard normal draw of two Philox words (int64 tensors holding
    32-bit words), in f32 with the kernel's rounding points: u = (w >> 8)
    2^-24, n = sqrt(-2 ln max(u1, 1e-7)) cos(2 pi u2)."""
    u1 = torch.clamp_min((bits1 >> 8).float() * _INV24, 1e-7)
    u2 = (bits2 >> 8).float() * _INV24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def augment_normalize_reference(images: torch.Tensor, scalars: torch.Tensor,
                                seeds: torch.Tensor, mean: Sequence[float],
                                std: Sequence[float], dtype=torch.float32
                                ) -> torch.Tensor:
    """The plain version of K3: ``images`` uint8 [B, H, W, C], ``scalars``
    [B, 3] f32 (alpha, beta, sigma), ``seeds`` [B] int32; the function of
    the CUDA source's header, from the Philox bits up, in f32 with the
    kernel's rounding points, cast to ``dtype`` at the end."""
    B, C = images.shape[0], images.shape[-1]
    dev = images.device
    x = images.reshape(B, -1).float()
    P = x.shape[1]
    sc = scalars.to(dev, torch.float32)
    alpha, beta, sigma = sc[:, 0:1], sc[:, 1:2], sc[:, 2:3]
    x = torch.clamp(x * alpha + beta, 0.0, 255.0)
    k = torch.arange((P + 1) // 2, dtype=torch.int64, device=dev)
    z = torch.zeros_like(k)
    key = torch.stack([seeds.to(dev, torch.int64),
                       torch.zeros(B, dtype=torch.int64, device=dev)], -1)
    w = philox4x32_10(torch.stack([k, z, z, z], -1)[None], key[:, None])
    bits1 = torch.stack([w[..., 0], w[..., 2]], -1).reshape(B, -1)[:, :P]
    bits2 = torch.stack([w[..., 1], w[..., 3]], -1).reshape(B, -1)[:, :P]
    del w
    x = torch.clamp(x + sigma * box_muller(bits1, bits2), 0.0, 255.0)
    mean255, inv_std = _stats(mean, std, dev)
    x = (x.view(B, -1, C) - mean255) * inv_std
    return x.reshape(images.shape).to(dtype)


def augment_normalize(images: torch.Tensor, scalars: torch.Tensor,
                      seeds: torch.Tensor, mean: Sequence[float],
                      std: Sequence[float], dtype=torch.float32
                      ) -> torch.Tensor:
    """K3 on given per-image parameters (see
    ``augment_normalize_reference``). A CPU tensor takes the plain version;
    a CUDA tensor launches ``preprocess_fwd`` or raises, in span
    ``kernel.K3`` while spans are recorded. Counts its launches in
    ``.launches``, and in ``.launches_by_kernel`` by the kernel
    that ``preprocess_fwd`` chose: ``vector``, the 16-byte chunk kernel
    (P % 16 == 0, C <= 16, the images and the output 16-byte aligned), or
    ``edge``, the per-pair kernel for anything else."""
    if images.device.type == "cpu":
        return augment_normalize_reference(images, scalars, seeds, mean, std,
                                           dtype)
    with span("kernel.K3"):
        if images.dtype != torch.uint8 or images.dim() != 4:
            raise ValueError(f"images: need uint8 [B, H, W, C], got "
                             f"{images.dtype} {tuple(images.shape)}")
        B, C = images.shape[0], images.shape[-1]
        if not images.is_contiguous():
            raise ValueError("images must be contiguous")
        if dtype not in _OUT_DTYPES:
            raise ValueError(f"output dtype {dtype}: need f32 or bf16")
        dev = images.device
        for t, shape, dt, what in ((scalars, (B, 3), torch.float32, "scalars"),
                                   (seeds, (B,), torch.int32, "seeds")):
            if (t.device != dev or tuple(t.shape) != shape or t.dtype != dt
                    or not t.is_contiguous()):
                raise ValueError(f"{what}: need contiguous {dt} {shape} on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}")
        mean255, inv_std = _device_stats(tuple(map(float, mean)),
                                         tuple(map(float, std)), dev)
        if mean255.shape != (C,) or inv_std.shape != (C,):
            raise ValueError(f"mean/std need {C} entries, one per channel")
        P = images[0].numel()
        if P >= 2 ** 31:
            raise ValueError(f"{P} elements per image: the kernels index an "
                             "image in 32 bits (P < 2^31)")
        out = torch.empty(images.shape, dtype=dtype, device=dev)
        vector = ctypes.c_int(0)
        rc = build.load("preprocess_fwd")(
            images.data_ptr(), out.data_ptr(), scalars.data_ptr(),
            seeds.data_ptr(), mean255.data_ptr(), inv_std.data_ptr(), B, C, P,
            int(dtype == torch.bfloat16), ctypes.byref(vector),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("preprocess_fwd launch failed: CUDA error "
                               f"{rc}")
        augment_normalize.launches += 1
        augment_normalize.launches_by_kernel[
            "vector" if vector.value else "edge"] += 1
        return out


augment_normalize.launches = 0
augment_normalize.launches_by_kernel = {"vector": 0, "edge": 0}


def draw_params(B: int, device, generator: Optional[torch.Generator],
                brightness_contrast_p: float = 0.2,
                gauss_noise_p: float = 0.1, brightness_limit: float = 0.2,
                contrast_limit: float = 0.2,
                var_limit: Tuple[float, float] = (10.0, 50.0)):
    """Per-image (scalars [B, 3] f32, seeds [B] int32) on ``device``, drawn
    in the order of ``preprocess_pallas.py:107-127``: apply_bc, alpha,
    beta, apply_noise, var, seeds in [0, 2^31 - 1)."""
    def uniform(lo, hi):
        return lo + comm.rand(B, generator, device) * (
            hi - lo)

    apply_bc = comm.rand(B, generator, device) < brightness_contrast_p
    one, zero = (torch.ones(B, device=device), torch.zeros(B, device=device))
    alpha = torch.where(apply_bc, 1.0 + uniform(-contrast_limit,
                                                contrast_limit), one)
    beta = torch.where(apply_bc, uniform(-brightness_limit,
                                         brightness_limit) * 255.0, zero)
    apply_noise = comm.rand(B, generator, device) < gauss_noise_p
    var = uniform(var_limit[0], var_limit[1])
    sigma = torch.where(apply_noise, torch.sqrt(var), zero)
    seeds = comm.randint(0, 2 ** 31 - 1, (B,), generator, device,
                         dtype=torch.int32)
    return torch.stack([alpha, beta, sigma], 1), seeds


def fused_augment_normalize(images: torch.Tensor, mean: Sequence[float],
                            std: Sequence[float],
                            brightness_contrast_p: float = 0.2,
                            gauss_noise_p: float = 0.1,
                            brightness_limit: float = 0.2,
                            contrast_limit: float = 0.2,
                            var_limit: Tuple[float, float] = (10.0, 50.0),
                            dtype=torch.bfloat16,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """The train preprocessing of ``data.fused_preprocess``: draws the
    per-image parameters from ``generator`` on the images' device
    (``draw_params``), then runs K3 (``augment_normalize``)."""
    scalars, seeds = draw_params(
        images.shape[0], images.device, generator, brightness_contrast_p,
        gauss_noise_p, brightness_limit, contrast_limit, var_limit)
    return augment_normalize(images, scalars, seeds, mean, std, dtype)
