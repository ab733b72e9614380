"""Device-side photometric augmentation and normalization: a frozen copy
of the port's ``ops/image.py`` (the plain chain).

    uint8 [B, H, W, 3] -> brightness/contrast -> gauss noise
                       -> (x/255 - mean)/std

Each random op draws its per-image apply flag and parameters from an
explicit ``torch.Generator`` on the images' device, then applies a
deterministic function of those parameters (``brightness_contrast``,
``gauss_noise``), so a test can force the parameters. The distributions
are the JAX package's (albumentations' defaults: brightness/contrast limits
±0.2 with brightness_by_max, noise variance uniform in [10, 50] on the
0..255 scale); the random bits are not.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .layers import rand, randn


def normalize_images(images: torch.Tensor, mean: Sequence[float],
                     std: Sequence[float], dtype=torch.float32
                     ) -> torch.Tensor:
    """(x/255 - mean) / std, as A.Normalize (max_pixel_value=255):
    computed as (x - 255*mean) / (255*std) in f32, then cast. ``mean`` and
    ``std`` may be sequences or f32 tensors already on the images'
    device."""
    dev = images.device
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev) * 255.0
    denom = torch.as_tensor(std, dtype=torch.float32, device=dev) * 255.0
    return ((images.float() - mean) / denom).to(dtype)


def _uniform(shape, lo: float, hi: float, generator, device):
    """U[lo, hi) as jax.random.uniform(minval, maxval): lo + u (hi - lo)."""
    u = rand(shape, generator, device)
    return lo + u * (hi - lo)


def brightness_contrast(images: torch.Tensor, alpha: torch.Tensor,
                        beta: torch.Tensor) -> torch.Tensor:
    """clip(x * alpha + beta, 0, 255) in f32, alpha/beta per image [B]."""
    x = images.float()
    return torch.clamp(x * alpha.view(-1, 1, 1, 1) + beta.view(-1, 1, 1, 1),
                       0.0, 255.0)


def random_brightness_contrast(images: torch.Tensor, p: float = 0.2,
                               brightness_limit: float = 0.2,
                               contrast_limit: float = 0.2,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """Per-image random brightness/contrast on the 0..255 scale, applied
    with probability p: alpha = 1 + U(-c, c), beta = 255 U(-b, b)."""
    B, dev = images.shape[0], images.device
    apply = rand(B, generator, dev) < p
    alpha = 1.0 + _uniform(B, -contrast_limit, contrast_limit, generator,
                           dev)
    beta = _uniform(B, -brightness_limit, brightness_limit, generator,
                    dev) * 255.0
    alpha = torch.where(apply, alpha, torch.ones_like(alpha))
    beta = torch.where(apply, beta, torch.zeros_like(beta))
    return brightness_contrast(images, alpha, beta)


def gauss_noise(images: torch.Tensor, sigma: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """clip(x + noise * sigma, 0, 255) in f32, sigma per image [B]."""
    x = images.float()
    return torch.clamp(x + noise * sigma.view(-1, 1, 1, 1), 0.0, 255.0)


def random_gauss_noise(images: torch.Tensor, p: float = 0.1,
                       var_limit: Tuple[float, float] = (10.0, 50.0),
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Per-image additive gaussian noise on the 0..255 scale, applied with
    probability p, sigma = sqrt(U(var_limit))."""
    B, dev = images.shape[0], images.device
    apply = rand(B, generator, dev) < p
    sigma = torch.sqrt(_uniform(B, var_limit[0], var_limit[1], generator,
                                dev))
    noise = randn(images.shape, generator, dev)
    scale = torch.where(apply, sigma, torch.zeros_like(sigma))
    return gauss_noise(images, scale, noise)


def random_flips(images: torch.Tensor, labels: torch.Tensor, task_type: str,
                 horizontal_p: float = 0.0, vertical_p: float = 0.0,
                 generator: Optional[torch.Generator] = None):
    """Synchronized per-image random flips of images AND labels:
    segmentation masks flip with the image; detection boxes map
    x1' = 1 - x2, x2' = 1 - x1 (and y for vertical), invalid sentinel boxes
    untouched; regression points x' = 1 - x / y' = 1 - y; classification
    labels unchanged."""
    B, dev = images.shape[0], images.device
    none = torch.zeros(B, dtype=torch.bool, device=dev)
    do_h = (rand(B, generator, dev) < horizontal_p
            if horizontal_p > 0 else none)
    do_v = (rand(B, generator, dev) < vertical_p
            if vertical_p > 0 else none)

    def sel(flag, a, b):
        return torch.where(flag.view(-1, *([1] * (a.dim() - 1))), a, b)

    images = sel(do_h, images.flip(2), images)
    images = sel(do_v, images.flip(1), images)
    if task_type == "segmentation":
        labels = sel(do_h, labels.flip(2), labels)
        labels = sel(do_v, labels.flip(1), labels)
    elif task_type == "detection":
        valid = (labels >= 0).all(dim=1)
        x1, y1, x2, y2 = labels.unbind(1)
        fh = torch.stack([1.0 - x2, y1, 1.0 - x1, y2], dim=1)
        labels = sel(do_h & valid, fh, labels)
        x1, y1, x2, y2 = labels.unbind(1)
        fv = torch.stack([x1, 1.0 - y2, x2, 1.0 - y1], dim=1)
        labels = sel(do_v & valid, fv, labels)
    elif task_type == "Regression":
        is_x = torch.arange(labels.shape[-1], device=dev) % 2 == 0
        labels = sel(do_h, torch.where(is_x, 1.0 - labels, labels), labels)
        labels = sel(do_v, torch.where(~is_x, 1.0 - labels, labels), labels)
    return images, labels


def augment_and_normalize(images: torch.Tensor, mean: Sequence[float],
                          std: Sequence[float],
                          brightness_contrast_p: float = 0.2,
                          gauss_noise_p: float = 0.1, train: bool = True,
                          dtype=torch.float32,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Train: brightness/contrast -> noise -> normalize. Val: normalize."""
    x = images
    if train:
        x = random_brightness_contrast(x, p=brightness_contrast_p,
                                       generator=generator)
        x = random_gauss_noise(x, p=gauss_noise_p, generator=generator)
    return normalize_images(x, mean, std, dtype=dtype)


def input_prep_fns(config, compute_dtype=torch.float32):
    """(train_prep(images, generator), eval_prep(images)): device
    photometric augmentation + dataset-stats normalization. The fused K3
    path and adaptive normalisation compute the same chain; the reference
    takes the plain chain for both and refuses adaptive normalisation,
    which no configuration of the benchmark uses."""
    if config.get("data.use_adaptive_norm", False):
        raise ValueError("the reference has no adaptive normalisation")
    aug = config.get("data.augmentation.train", {}) or {}
    bc_p = float(aug.get("random_brightness_contrast", 0.2))
    noise_p = float(aug.get("gauss_noise", 0.1))

    def mean_std(device):
        return tuple(torch.as_tensor(
            config.get(f"data.augmentation.normalize.{k}"),
            dtype=torch.float32, device=device) for k in ("mean", "std"))

    def train_prep(images, generator=None):
        return augment_and_normalize(
            images, *mean_std(images.device), brightness_contrast_p=bc_p,
            gauss_noise_p=noise_p, train=True, dtype=compute_dtype,
            generator=generator)

    def eval_prep(images):
        return normalize_images(images, *mean_std(images.device),
                                dtype=compute_dtype)

    return train_prep, eval_prep
