"""The port's plain backward versions of the fused Swin branches (which the
CUDA kernels K1b/K2b are held against on the card by chip_smoke.py)
against the JAX package: the analytic pullbacks ``_branch_pullback`` /
``_mlp_pullback``, ``jax.grad`` through ``fused_attention_branch`` /
``fused_mlp_branch`` (Pallas in interpret mode), and torch autograd
through the port's own plain forward.

Tolerances, per gradient leaf, against that leaf's largest magnitude:
f32 1e-5 (the same f32 arithmetic summed in another order), except dx at
4e-5: dx is the LayerNorm pullback's difference of nearly equal terms (its
input reaches several times |dx|), and one early run of the MLP case saw
1.6e-5 there; bf16 2 bf16 ulps (both sides round at the same points, so
they differ only where an f32 sum in another order rounds an intermediate
to a neighbouring bf16 value). The autograd comparison is f32, as above.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.ops.swin_block_pallas import (
    _branch_pullback,
    _mlp_pullback,
    fused_attention_branch,
    fused_mlp_branch,
)
from fmc_uia_tpu_torch.ops import swin_block as sb
from test_torch_swin_kernels import (
    ATTN_CASES,
    DTYPES,
    _attn_inputs,
    _mlp_inputs,
    _to_np,
    _torch_mlp_args,
)

ATTN_NAMES = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwproj",
              "dbproj", "dbias")
MLP_NAMES = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")


def _leaf_tol(ref: np.ndarray, dt: str, name: str) -> float:
    top = max(float(np.abs(ref).max()), 1e-30)
    if dt == "f32":
        return (4e-5 if name == "dx" else 1e-5) * top
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def _check(names, got, ref, dt):
    for name, g, r in zip(names, got, ref):
        g = np.asarray(g.float().numpy() if torch.is_tensor(g) else g,
                       np.float32)
        r = np.asarray(r, np.float32)
        assert g.shape == r.shape, (name, g.shape, r.shape)
        err = float(np.abs(g - r).max())
        tol = _leaf_tol(r, dt, name)
        assert err <= tol, (name, err, tol)


def _attn_torch_args(w, bias, mask, H):
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    return (tw["ln_scale"], tw["ln_bias"], tw["wqkv"].t().contiguous(),
            tw["bqkv"], tw["wproj"].t().contiguous(), tw["bproj"],
            torch.from_numpy(bias),
            None if mask is None else torch.from_numpy(mask), H)


def _attn_port_order(grads):
    """JAX [in, out] kernels -> the port's [out, in]."""
    dx, dg, db, dwqkv, dbqkv, dwproj, dbproj, dbias = grads
    return (dx, dg, db, np.asarray(dwqkv).T, dbqkv, np.asarray(dwproj).T,
            dbproj, dbias)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_backward_matches_branch_pullback(case, dt):
    ws, grid, shift = ATTN_CASES[case]
    C, H, B = 32, 2, 2
    rng = np.random.RandomState(20 + sorted(ATTN_CASES).index(case))
    x, w, bias, mask = _attn_inputs(rng, B, grid, C, H, ws, shift)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dp = np.array([1.0, 0.5], np.float32)  # dp != 1 on one sample
    jdt, tdt = DTYPES[dt]

    # JAX: one whole image per _branch_pullback call; weight grads summed
    per = []
    for b in range(B):
        per.append([_to_np(g) for g in _branch_pullback(
            jnp.asarray(x[b], jdt), jnp.asarray(w["ln_scale"]),
            jnp.asarray(w["ln_bias"]), jnp.asarray(w["wqkv"]),
            jnp.asarray(w["bqkv"]), jnp.asarray(w["wproj"]),
            jnp.asarray(w["bproj"]), jnp.asarray(bias),
            None if mask is None else jnp.asarray(mask),
            jnp.asarray(dp[b]), jnp.asarray(dy[b], jdt),
            num_heads=H, ws=ws, compute_dtype=jdt)])
    ref = [np.stack([p[0] for p in per])]
    ref += [sum(p[i] for p in per) for i in range(1, 8)]

    args = _attn_torch_args(w, bias, mask, H)
    xt = torch.from_numpy(x).to(tdt)
    dyt = torch.from_numpy(dy).to(tdt)
    got = sb.attention_branch_backward_reference(
        xt, *args, dyt, dp=torch.from_numpy(dp))
    assert got[0].dtype == tdt
    assert all(g.dtype == torch.float32 for g in got[1:])
    _check(ATTN_NAMES, got, _attn_port_order(ref), dt)

    # the wrapper on CPU tensors is the plain version and launches nothing
    sb.attention_branch_backward.launches = 0
    via = sb.attention_branch_backward(xt, *args, dyt,
                                       dp=torch.from_numpy(dp))
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    assert sb.attention_branch_backward.launches == 0


@pytest.mark.parametrize("case", ["ws8_shift_pad", "ws7_shift"])
def test_attention_backward_matches_jax_grad_interpret(case):
    """Against jax.grad through the whole Pallas kernel pair (interpret
    mode: the custom_vjp's own backward kernel), f32."""
    ws, grid, shift = ATTN_CASES[case]
    C, H, B = 32, 2, 2
    rng = np.random.RandomState(7)
    x, w, bias, mask = _attn_inputs(rng, B, grid, C, H, ws, shift)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dp = np.array([0.5, 1.0], np.float32)
    keys = ("ln_scale", "ln_bias", "wqkv", "bqkv", "wproj", "bproj")

    def f(x, ls, lb, wqkv, bqkv, wproj, bproj, bias):
        y = fused_attention_branch(x, ls, lb, wqkv, bqkv, wproj, bproj,
                                   bias, jnp.asarray(mask), H,
                                   dp_scale=jnp.asarray(dp))
        return jnp.sum(y * jnp.asarray(dy))

    ref = jax.grad(f, argnums=tuple(range(8)))(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in keys),
        jnp.asarray(bias))
    got = sb.attention_branch_backward(
        torch.from_numpy(x), *_attn_torch_args(w, bias, mask, H),
        torch.from_numpy(dy), dp=torch.from_numpy(dp))
    _check(ATTN_NAMES, got,
           _attn_port_order([np.asarray(r) for r in ref]), "f32")


@pytest.mark.parametrize("case", ["ws8_plain", "ws8_shift_pad", "ws7_pad"])
def test_attention_backward_matches_autograd(case):
    """Against torch autograd through the port's plain forward, f32; and
    the autograd Function (plain versions on CPU) gives the same grads."""
    ws, grid, shift = ATTN_CASES[case]
    C, H, B = 32, 2, 2
    rng = np.random.RandomState(9)
    x, w, bias, mask = _attn_inputs(rng, B, grid, C, H, ws, shift)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    dp = torch.tensor([0.5, 1.0])
    args = _attn_torch_args(w, bias, mask, H)
    leaves = [torch.from_numpy(x)] + [a for a in args[:7]]

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in leaves]
        y = fn(*ins, args[7], H, dp=dp)
        (y * dy).sum().backward()
        return [t.grad for t in ins]

    ref = grads(sb.attention_branch_reference)
    got = sb.attention_branch_backward(torch.from_numpy(x), *args, dy,
                                       dp=dp)
    _check(ATTN_NAMES, got, [r.numpy() for r in ref], "f32")
    via_fn = grads(sb.attention_branch)
    assert all(torch.equal(a, b) for a, b in zip(via_fn, got))


def _mlp_port_order(grads):
    dx, dg, db, dw1, db1, dw2, db2 = grads
    return (dx, dg, db, np.asarray(dw1).T, db1, np.asarray(dw2).T, db2)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("C", [32, 64, 96])
def test_mlp_backward_matches_mlp_pullback(C, dt):
    B, grid = 2, 8
    rng = np.random.RandomState(40 + C)
    x, w = _mlp_inputs(rng, B, grid, C)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dp = np.array([1.0, 0.5], np.float32)
    jdt, tdt = DTYPES[dt]
    per = []
    for b in range(B):  # one sample per call: dp is one scalar there
        per.append([_to_np(g) for g in _mlp_pullback(
            jnp.asarray(x[b].reshape(-1, C), jdt),
            *(jnp.asarray(w[k]) for k in (
                "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")),
            jnp.asarray(dp[b]), jnp.asarray(dy[b].reshape(-1, C), jdt),
            compute_dtype=jdt)])
    ref = [np.stack([p[0] for p in per]).reshape(x.shape)]
    ref += [sum(p[i] for p in per) for i in range(1, 7)]

    xt = torch.from_numpy(x).to(tdt)
    dyt = torch.from_numpy(dy).to(tdt)
    args = _torch_mlp_args(w)
    got = sb.mlp_branch_backward_reference(xt, *args, dyt,
                                           dp=torch.from_numpy(dp))
    assert got[0].dtype == tdt
    _check(MLP_NAMES, got, _mlp_port_order(ref), dt)

    sb.mlp_branch_backward.launches = 0
    via = sb.mlp_branch_backward(xt, *args, dyt, dp=torch.from_numpy(dp))
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    assert sb.mlp_branch_backward.launches == 0


def test_mlp_backward_matches_jax_grad_interpret():
    """Against jax.grad through the whole Pallas MLP kernel pair
    (interpret mode), f32."""
    rng = np.random.RandomState(13)
    x, w = _mlp_inputs(rng, 2, 16, 32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dp = np.array([0.5, 1.0], np.float32)
    keys = ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")

    def f(x, *ws):
        y = fused_mlp_branch(x, *ws, dp_scale=jnp.asarray(dp))
        return jnp.sum(y * jnp.asarray(dy))

    ref = jax.grad(f, argnums=tuple(range(7)))(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in keys))
    got = sb.mlp_branch_backward(torch.from_numpy(x), *_torch_mlp_args(w),
                                 torch.from_numpy(dy),
                                 dp=torch.from_numpy(dp))
    _check(MLP_NAMES, got, _mlp_port_order([np.asarray(r) for r in ref]),
           "f32")


def test_mlp_backward_matches_autograd():
    """Against torch autograd through the plain forward, f32; and the
    autograd Function gives the same grads."""
    rng = np.random.RandomState(17)
    x, w = _mlp_inputs(rng, 2, 8, 32)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    dp = torch.tensor([0.5, 1.0])
    leaves = [torch.from_numpy(x), *_torch_mlp_args(w)]

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in leaves]
        (fn(*ins, dp=dp) * dy).sum().backward()
        return [t.grad for t in ins]

    ref = grads(sb.mlp_branch_reference)
    got = sb.mlp_branch_backward(*leaves, dy, dp=dp)
    _check(MLP_NAMES, got, [r.numpy() for r in ref], "f32")
    via_fn = grads(sb.mlp_branch)
    assert all(torch.equal(a, b) for a, b in zip(via_fn, got))
