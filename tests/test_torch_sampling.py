"""The port's bilinear gather (``fmc_uia_tpu_torch/ops/sampling.py``)
against the JAX package's ``grid_sample_bilinear``, on the CPU, with the
same seeded numpy inputs. Coordinates are drawn in [-1.3, 1.3], so that
some corners fall outside the image (zeros there), plus a few exactly on
the border and at pixel centres.

Tolerances: f32 within 1e-6 of the output's largest magnitude (the same
f32 operations in the same order); a bf16 image gives an f32 result on
both sides (the bf16 gather times f32 weights promotes), within 1e-6 too;
``jax.vjp`` against autograd, grads with respect to the image and to the
coordinates, within 1e-5 of each grad's largest magnitude (the image's
grad sums up to 4·N contributions per pixel in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.ops.sampling import grid_sample_bilinear as jax_sample
from fmc_uia_tpu_torch.ops.sampling import grid_sample_bilinear


def _inputs(seed, B=2, H=5, W=7, C=3, pts=(4, 6, 3)):
    rng = np.random.RandomState(seed)
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (B, *pts, 2)).astype(np.float32)
    # exact border and pixel-centre points: x = -1 is the left edge,
    # x = (2 i + 1) / W - 1 the centre of column i
    coords[0, 0, 0, 0] = (-1.0, -1.0)
    coords[0, 0, 0, 1] = (1.0, 1.0)
    coords[0, 0, 0, 2] = (1.0 / W - 1.0, 3.0 / H - 1.0)
    return img, coords


def _close(got, ref, rel):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1.0), err


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_f32_matches_jax(seed):
    img, coords = _inputs(seed)
    ref = jax_sample(jnp.asarray(img), jnp.asarray(coords))
    got = grid_sample_bilinear(torch.from_numpy(img),
                               torch.from_numpy(coords))
    assert got.dtype == torch.float32
    assert got.shape == (2, 4, 6, 3, 3)
    _close(got, ref, 1e-6)
    # some samples lie wholly outside the image (|x| > 1 + 1/W or |y| >
    # 1 + 1/H: no corner inside): zero on both sides
    outside = ((np.abs(coords[..., 0]) > 1.0 + 1.0 / 7)
               | (np.abs(coords[..., 1]) > 1.0 + 1.0 / 5))
    assert outside.any()
    assert np.all(got.numpy()[outside] == 0.0)


def test_forward_bf16_image_matches_jax():
    img, coords = _inputs(2)
    ref = jax_sample(jnp.asarray(img, jnp.bfloat16), jnp.asarray(coords))
    assert ref.dtype == jnp.float32  # bf16 gather x f32 weights promotes
    got = grid_sample_bilinear(torch.from_numpy(img).bfloat16(),
                               torch.from_numpy(coords))
    assert got.dtype == torch.float32
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_vjp_matches_jax(seed):
    img, coords = _inputs(seed)
    dy = np.random.RandomState(seed + 10).standard_normal(
        (2, 4, 6, 3, 3)).astype(np.float32)
    _, vjp = jax.vjp(jax_sample, jnp.asarray(img), jnp.asarray(coords))
    dimg_ref, dcoords_ref = vjp(jnp.asarray(dy))

    ti = torch.from_numpy(img).requires_grad_()
    tc = torch.from_numpy(coords).requires_grad_()
    out = grid_sample_bilinear(ti, tc)
    dimg, dcoords = torch.autograd.grad(out, (ti, tc),
                                        torch.from_numpy(dy))
    _close(dimg, dimg_ref, 1e-5)
    _close(dcoords, dcoords_ref, 1e-5)
    assert float(np.abs(np.asarray(dcoords_ref)).max()) > 0
