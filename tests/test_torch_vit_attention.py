"""The plain versions of K4 (the port's ViT global attention, forward and
pullback) against the JAX package, on the CPU, at the real head shape
(H = 12, dh = 64) with short sequences: N = 37, one full tile of the bf16
kernels (128), a tail after it (130) and a one-row tail after two tiles
(257).

* Against ``_xla_attention`` (the JAX package's CPU path of
  ``global_attention``) and its ``jax.vjp``: f32 within 1e-5 of the
  largest magnitude (sums in another order); bf16 within 4 bf16 ulps
  of each row's largest magnitude (measured: 1.25 forward, 2.25
  pullback) -- the port rounds the unnormalized
  probabilities to bf16 and divides by the row sum after ``p v`` (the TPU
  kernel's order), the einsum path normalizes first, so each side's
  probabilities differ by up to an ulp; the bf16 pullback also rounds
  the einsum's intermediates where autodiff of the einsum casts.
* The masking of the TPU path: ``mha_reference_no_custom_vjp`` (the
  Pallas library's reference) on inputs padded to 512 with the pad tokens
  in a second segment, as ``global_attention`` pads them, cropped to N:
  forward and pullback in f32, 1e-5.
* A gradient check of the pullback in f64 (``torch.autograd.gradcheck``),
  and the autograd wiring: ``global_attention(...).backward`` gives the
  plain pullback and counts no kernel launch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference_no_custom_vjp,
)

from fmc_uia_tpu.ops.vit_attention import _xla_attention
from fmc_uia_tpu_torch.ops import vit_attention as va

H, DH = 12, 64
SCALE = DH ** -0.5


def _inputs(N, seed, B=2):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, H, N, DH)).astype(np.float32)
            for _ in range(4)]  # q, k, v, do


def _bf16_ulp(x):
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


def _close_rel(got, ref, rel):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), (err, rel)


def _close_rows_bf16(got, ref, ulps):
    """Each row (last axis) within ``ulps`` bf16 ulps of its largest
    magnitude."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max(-1)
    tol = ulps * _bf16_ulp(np.abs(ref).max(-1))
    assert (err <= tol).all(), float((err / tol).max())


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("N", [37, 128, 130, 257])
def test_forward_matches_xla_attention_f32(N):
    q, k, v, _ = _inputs(N, seed=N)
    ref = _xla_attention(*(jnp.asarray(t) for t in (q, k, v)), SCALE)
    o, lse = va.global_attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), SCALE)
    _close_rel(o, ref, 1e-5)
    s = np.einsum("bhnd,bhmd->bhnm", q.astype(np.float64),
                  k.astype(np.float64)) * SCALE
    lse_ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("N", [37, 128, 130, 257])
def test_forward_matches_xla_attention_bf16(N):
    q, k, v, _ = _inputs(N, seed=N + 1)
    ref = _xla_attention(*(_jax(t, jnp.bfloat16) for t in (q, k, v)), SCALE)
    o, _ = va.global_attention_reference(
        *(_torch(t, torch.bfloat16) for t in (q, k, v)), SCALE)
    assert o.dtype == torch.bfloat16
    _close_rows_bf16(o.float().numpy(), np.asarray(ref, np.float32), 4)


def _jax_vjp(q, k, v, do, dtype):
    args = [_jax(t, dtype) for t in (q, k, v)]
    _, pull = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, SCALE), *args)
    return pull(_jax(do, dtype))


def _port_pullback(q, k, v, do, dtype):
    qt, kt, vt, dot = (_torch(t, dtype) for t in (q, k, v, do))
    o, lse = va.global_attention_reference(qt, kt, vt, SCALE)
    return va.global_attention_backward_reference(qt, kt, vt, o, lse, dot,
                                                  SCALE)


@pytest.mark.parametrize("N", [37, 128, 130, 257])
def test_pullback_matches_jax_vjp_f32(N):
    q, k, v, do = _inputs(N, seed=10 + N)
    refs = _jax_vjp(q, k, v, do, jnp.float32)
    for got, ref in zip(_port_pullback(q, k, v, do, torch.float32), refs):
        _close_rel(got, ref, 1e-5)


@pytest.mark.parametrize("N", [37, 128, 130, 257])
def test_pullback_matches_jax_vjp_bf16(N):
    q, k, v, do = _inputs(N, seed=20 + N)
    refs = _jax_vjp(q, k, v, do, jnp.bfloat16)
    for got, ref in zip(_port_pullback(q, k, v, do, torch.bfloat16), refs):
        assert got.dtype == torch.bfloat16
        _close_rows_bf16(got.float().numpy(), np.asarray(ref, np.float32), 4)


@pytest.mark.parametrize("N", [37, 128, 130, 257])
def test_masking_matches_padded_segment_reference(N):
    """The TPU path pads to a multiple of 512 with pad tokens in segment
    1; for the real rows that is the port's masking of keys >= N."""
    q, k, v, do = _inputs(N, seed=30 + N, B=1)
    n_pad = -(-N // 512) * 512
    pad = ((0, 0), (0, 0), (0, n_pad - N), (0, 0))
    seg = jnp.asarray(np.concatenate(
        [np.zeros((1, N)), np.ones((1, n_pad - N))], 1).astype(np.int32))
    ids = SegmentIds(q=seg, kv=seg)

    def ref_fn(a, b, c):
        return mha_reference_no_custom_vjp(a, b, c, segment_ids=ids,
                                           sm_scale=SCALE)

    padded = [jnp.asarray(np.pad(t, pad)) for t in (q, k, v)]
    out, pull = jax.vjp(ref_fn, *padded)
    grads = pull(jnp.asarray(np.pad(do, pad)))
    got = _port_pullback(q, k, v, do, torch.float32)
    o, _ = va.global_attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), SCALE)
    _close_rel(o, np.asarray(out)[:, :, :N], 1e-5)
    for g, r in zip(got, grads):
        _close_rel(g, np.asarray(r)[:, :, :N], 1e-5)


def test_gradcheck_f64():
    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2, 9, 8)),
                            dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: va.global_attention(a, b, c, 8 ** -0.5), (q, k, v))


def test_autograd_function_gives_the_plain_pullback():
    q, k, v, do = _inputs(37, seed=7)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    before = (va.global_attention.launches,
              va.global_attention_backward.launches)
    o = va.global_attention(*ts, SCALE)
    o.backward(torch.from_numpy(do))
    ref = _port_pullback(q, k, v, do, torch.float32)
    for t, r in zip(ts, ref):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)
    assert (va.global_attention.launches,
            va.global_attention_backward.launches) == before
