"""K3, the fused photometric preprocessing, in the port against the JAX
package's Pallas kernel (``ops/preprocess_pallas.py``, run in interpret
mode on the CPU) and against its own law.

In interpret mode the JAX kernel's hardware PRNG yields zeros, so its
noise cannot serve as a reference: the port's plain version is held to it
where sigma = 0, and its noise to the Gaussian law. Tolerances: at sigma =
0 bitwise in f32 and equal in bf16 where x * alpha is exact (XLA's CPU
backend contracts x * alpha + beta into a fused multiply-add, which the
kernels keep apart; for other alphas the two differ by at most one f32
ulp of the affine result, carried through the normalize, plus two ulps
of the output for the roundings after it); at p = 0
within 5e-7 (the JAX normalize divides, K3 multiplies by the reciprocal);
the noise's mean and std within 0.05 and its Kolmogorov-Smirnov distance
to N(0, 1) below 0.01 on 393,216 samples (the 1 % critical value there
is 0.0026); apply rates within 4 standard deviations of a binomial count.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fmc_uia_tpu.ops import image as JI
from fmc_uia_tpu.ops import preprocess_pallas as JP
from fmc_uia_tpu_torch.ops import preprocess as PP

MEAN, STD = [0.33, 0.31, 0.35], [0.18, 0.2, 0.17]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = PP.philox4x32_10(torch.tensor(ctr), torch.tensor(key))
    assert " ".join(f"{int(v):08x}" for v in got) == want


def _jax_fused_call(img, scalars, seeds, dtype_name):
    W = img.shape[2]
    mean_row = jnp.tile(jnp.asarray(MEAN, jnp.float32) * 255.0, W)
    inv_row = jnp.tile(1.0 / (jnp.asarray(STD, jnp.float32) * 255.0), W)
    with pltpu.force_tpu_interpret_mode():
        out = JP._fused_call(jnp.asarray(img), jnp.asarray(scalars),
                             jnp.asarray(seeds), mean_row, inv_row,
                             dtype_name)
    return np.asarray(out.astype(jnp.float32))


def _images(B=4, H=16, W=24, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_kernel_at_sigma_0(dtype):
    """Forced alpha/beta that saturate both clips (x * alpha exact)."""
    img = _images()
    scalars = np.array([[1.5, -100.0, 0.0], [0.5, 120.0, 0.0],
                        [2.0, -200.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    seeds = np.array([1, 2, 3, 2 ** 31 - 2], np.int32)
    ref = _jax_fused_call(img, scalars, seeds, dtype)
    tdt = getattr(torch, dtype)
    got = PP.augment_normalize_reference(
        torch.from_numpy(img), torch.from_numpy(scalars),
        torch.from_numpy(seeds), MEAN, STD, tdt)
    assert got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_array_equal(got, ref)
    lo = (0.0 - np.float32(255) * np.float32(MEAN[0])) / (255 * STD[0])
    assert np.isclose(got[..., 0].min(), lo, rtol=1e-2)  # clipped at 0
    assert (got[..., 0] > 3.0).any()  # and at 255 (4.07)


def test_reference_within_an_ulp_of_the_fma_contracted_kernel():
    img = _images(seed=1)
    scalars = np.array([[1.2, -10.0, 0.0], [0.83, 17.3, 0.0],
                        [1.17, -40.1, 0.0], [0.91, 3.0, 0.0]], np.float32)
    seeds = np.arange(4, dtype=np.int32)
    ref = _jax_fused_call(img, scalars, seeds, "float32")
    got = PP.augment_normalize_reference(
        torch.from_numpy(img), torch.from_numpy(scalars),
        torch.from_numpy(seeds), MEAN, STD).numpy()
    inv = 1.0 / (np.float32(255) * np.float32(min(STD)))
    tol = np.spacing(np.float32(255)) * inv + 2 * np.spacing(np.abs(ref))
    assert (np.abs(got - ref) <= tol).all()


def test_fused_at_p0_matches_jax():
    """p = 0: no image is changed; JAX's fused kernel and normalize."""
    img = _images(B=3, H=20, W=32, seed=2)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JP.fused_augment_normalize(
            jax.random.PRNGKey(0), jnp.asarray(img), MEAN, STD,
            brightness_contrast_p=0.0, gauss_noise_p=0.0, dtype=jnp.float32))
    got = PP.fused_augment_normalize(
        torch.from_numpy(img), MEAN, STD, brightness_contrast_p=0.0,
        gauss_noise_p=0.0, dtype=torch.float32,
        generator=torch.Generator().manual_seed(0)).numpy()
    assert np.abs(got - ref).max() <= 5e-7
    norm = np.asarray(JI.normalize_images(jnp.asarray(img), MEAN, STD))
    assert np.abs(got - norm).max() <= 5e-7


def _noise(B=2, S=256, sigma=5.0, seeds=(11, 12)):
    img = torch.full((B, S, S, 3), 128, dtype=torch.uint8)
    scalars = torch.tensor([[1.0, 0.0, sigma]] * B)
    out = PP.augment_normalize_reference(
        img, scalars, torch.tensor(seeds, dtype=torch.int32), [0.0] * 3,
        [1 / 255.0] * 3)
    return (out.double().numpy() - 128.0) / sigma


def test_noise_law():
    """sigma = 5 on a constant 128: the pixel noise is N(0, 1) scaled."""
    n = _noise().ravel()
    assert n.size >= 2e5
    assert abs(5 * n.mean()) < 0.05 and abs(5 * n.std() - 5.0) < 0.05
    s = np.sort(n)
    cdf = np.array([0.5 * (1 + math.erf(v / math.sqrt(2))) for v in s[::7]])
    emp_hi = (np.arange(len(s))[::7] + 1) / len(s)
    emp_lo = np.arange(len(s))[::7] / len(s)
    ks = max(np.abs(emp_hi - cdf).max(), np.abs(emp_lo - cdf).max())
    assert ks < 0.01, ks


def test_noise_uncorrelated_across_seeds_and_lanes():
    n = _noise(seeds=(5, 6))
    a, b = n[0].ravel(), n[1].ravel()
    lim = 4 / math.sqrt(a.size)
    assert abs(np.corrcoef(a, b)[0, 1]) < lim
    # the two elements of one Philox output, and neighbouring pairs
    assert abs(np.corrcoef(a[0::2], a[1::2])[0, 1]) < 2 * lim
    assert abs(np.corrcoef(a[:-2:2], a[2::2])[0, 1]) < 2 * lim
    same = _noise(seeds=(5, 5))
    np.testing.assert_array_equal(same[0], same[1])


def test_draws_follow_the_jax_law():
    """Apply rates p, alpha in 1 +- 0.2, beta in +-51, sigma in
    [sqrt 10, sqrt 50], seeds in [0, 2^31 - 1); unapplied images keep
    alpha 1, beta 0, sigma 0."""
    n = 20000
    sc, seeds = PP.draw_params(n, "cpu", torch.Generator().manual_seed(3),
                               brightness_contrast_p=0.2, gauss_noise_p=0.1)
    a, b, s = sc.double().numpy().T
    bc = (a != 1.0) | (b != 0.0)
    for flag, p in ((bc, 0.2), (s > 0, 0.1)):
        sd = math.sqrt(n * p * (1 - p))
        assert abs(flag.sum() - n * p) <= 4 * sd
    assert (np.abs(a[bc] - 1) <= 0.2).all() and (np.abs(b[bc]) <= 51).all()
    assert (a[~bc] == 1).all() and (b[~bc] == 0).all()
    on = s > 0
    assert (s[on] >= math.sqrt(10) - 1e-5).all()
    assert (s[on] <= math.sqrt(50) + 1e-5).all()
    assert seeds.dtype == torch.int32
    assert int(seeds.min()) >= 0 and int(seeds.max()) < 2 ** 31 - 1
    # uniform in its range: the mean of alpha - 1 and beta near 0
    assert abs((a[bc] - 1).mean()) < 4 * 0.2 / math.sqrt(3 * bc.sum())


SIGMA0_SCALARS = {
    # the saturating alpha/beta of the sigma = 0 test above, and the
    # non-saturating ones of the FMA test
    "saturating": [[1.5, -100.0], [0.5, 120.0], [2.0, -200.0], [1.0, 0.0]],
    "inside": [[1.2, -10.0], [0.83, 17.3], [1.17, -40.1], [0.91, 3.0]],
}


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sigma", [0.0, -0.0])
@pytest.mark.parametrize("which", sorted(SIGMA0_SCALARS))
def test_sigma0_equals_the_noise_free_chain(which, sigma, dtype):
    """What lets the kernel skip Philox and Box-Muller where sigma == 0:
    for every byte value and channel, the plain version with its noise
    drawn and multiplied by sigma = +0 or -0 equals, bitwise, affine ->
    clip -> clip -> normalise with no noise at all."""
    ab = torch.tensor(SIGMA0_SCALARS[which])
    B = ab.shape[0]
    # 768 = 3 x 256 elements an image: every byte value in every channel
    img = (torch.arange(B * 16 * 16 * 3) % 256).to(torch.uint8).reshape(
        B, 16, 16, 3)
    scalars = torch.cat([ab, torch.full((B, 1), sigma)], 1)
    seeds = torch.tensor([7, 2 ** 31 - 2, 0, 12345], dtype=torch.int32)
    got = PP.augment_normalize_reference(img, scalars, seeds, MEAN, STD,
                                         dtype)
    x = img.float()
    alpha, beta = ab[:, 0].view(B, 1, 1, 1), ab[:, 1].view(B, 1, 1, 1)
    x = torch.clamp(torch.clamp(x * alpha + beta, 0.0, 255.0), 0.0, 255.0)
    mean255 = torch.tensor(MEAN) * 255.0
    inv_std = 1.0 / (torch.tensor(STD) * 255.0)
    want = ((x - mean255) * inv_std).to(dtype)
    assert torch.equal(_bits(got), _bits(want))


def test_noise_is_finite_at_the_extreme_philox_words():
    """u1 >= 1e-7 bounds |n| by sqrt(-2 ln 1e-7) = 5.68 at the extreme
    words (w = 0 clamps u1, w = 0xFFFFFFFF gives the largest u), so sigma
    * n is +-0 exactly at sigma = +-0."""
    w = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64)
    w1, w2 = torch.meshgrid(w, w, indexing="ij")
    n = PP.box_muller(w1.reshape(-1), w2.reshape(-1))
    assert torch.isfinite(n).all()
    assert float(n.abs().max()) <= 5.7
    assert float(n.abs().max()) >= 5.6  # w1 = 0, w2 = 0: u1 = 1e-7, cos 1
    for s in (0.0, -0.0):
        assert (s * n == 0).all()


# the edge shapes of the kernel's two paths: an odd P (pairs of odd
# images start at odd flat offsets), C = 1 and C = 4, B = 1, and a view at
# offset 1 into a larger buffer
EDGE_SHAPES = {"odd_P": ((3, 17, 23, 3), 0), "C1": ((4, 16, 16, 1), 0),
               "C4": ((4, 16, 16, 4), 0), "B1": ((1, 16, 24, 3), 0),
               "view_at_1": ((2, 16, 24, 3), 1)}


def _edge_images(shape, offset, seed=5):
    n = math.prod(shape)
    buf = np.random.RandomState(seed).randint(0, 256, n + offset).astype(
        np.uint8)
    return torch.from_numpy(buf)[offset:].view(shape)


def _stats(C):
    return (MEAN + [0.4])[:C], (STD + [0.22])[:C]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", sorted(EDGE_SHAPES))
def test_reference_matches_pallas_kernel_at_edge_shapes(which, dtype):
    """sigma = 0 with alpha/beta that saturate both clips (x * alpha
    exact): bitwise equal to the Pallas kernel in interpret mode."""
    shape, offset = EDGE_SHAPES[which]
    img = _edge_images(shape, offset)
    B, W, C = shape[0], shape[2], shape[3]
    mean, std = _stats(C)
    ab = np.array([[1.5, -100.0], [0.5, 120.0], [2.0, -200.0],
                   [1.0, 0.0]], np.float32)[np.arange(B) % 4]
    scalars = np.concatenate([ab, np.zeros((B, 1), np.float32)], 1)
    seeds = np.arange(1, B + 1, dtype=np.int32)
    mean_row = jnp.tile(jnp.asarray(mean, jnp.float32) * 255.0, W)
    inv_row = jnp.tile(1.0 / (jnp.asarray(std, jnp.float32) * 255.0), W)
    with pltpu.force_tpu_interpret_mode():
        ref = JP._fused_call(jnp.asarray(img.numpy()), jnp.asarray(scalars),
                             jnp.asarray(seeds), mean_row, inv_row, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    got = PP.augment_normalize_reference(
        img, torch.from_numpy(scalars), torch.from_numpy(seeds), mean, std,
        getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("which", ["odd_P", "B1", "C4"])
def test_noise_follows_the_per_image_philox_layout(which):
    """The layout the kernel reproduces, element by element: element e of
    image b draws Philox4x32-10 at counter (e >> 1, 0, 0, 0), key
    (seed_b, 0), words 0/1 for even e and 2/3 for odd e, counted within
    the image (not the batch)."""
    shape, offset = EDGE_SHAPES[which]
    img = _edge_images(shape, offset)
    B, C = shape[0], shape[3]
    mean, std = _stats(C)
    P = img[0].numel()
    scalars = torch.tensor([[1.0, 0.0, 7.0]] * B)
    seeds = torch.tensor([2 ** 31 - 2, 3, 99, 0][:B], dtype=torch.int32)
    got = PP.augment_normalize_reference(img, scalars, seeds, mean, std)
    e = torch.arange(P, dtype=torch.int64)
    z = torch.zeros_like(e)
    for b in range(B):
        key = torch.tensor([int(seeds[b]), 0], dtype=torch.int64)
        w = PP.philox4x32_10(torch.stack([e >> 1, z, z, z], -1), key)
        odd = (e & 1).bool()
        n = PP.box_muller(torch.where(odd, w[:, 2], w[:, 0]),
                          torch.where(odd, w[:, 3], w[:, 1]))
        x = torch.clamp(img[b].reshape(-1).float() + 7.0 * n, 0.0, 255.0)
        mean255 = torch.tensor(mean) * 255.0
        inv_std = 1.0 / (torch.tensor(std) * 255.0)
        want = ((x.view(-1, C) - mean255) * inv_std).reshape(img[b].shape)
        assert torch.equal(_bits(got[b]), _bits(want))
