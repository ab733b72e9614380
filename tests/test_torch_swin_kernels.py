"""The port's fused Swin branches (plain PyTorch versions, which the CUDA
kernels are held against on the card by chip_smoke.py) against the JAX
kernel math: ``_branch_math`` / ``fused_attention_branch`` (Pallas in
interpret mode) and ``_mlp_math`` / ``fused_mlp_branch``.

Tolerances: f32 1e-5 of the output's largest magnitude (the same f32
arithmetic summed in another order). bf16: both sides round at the same
points, so they differ only where an f32 sum in another order rounds to a
neighbouring bf16 value; allowed is 2 bf16 ulps of the largest magnitude.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.ops.swin_block_pallas import (
    _branch_math,
    _mlp_math,
    fused_attention_branch,
    fused_mlp_branch,
)
from fmc_uia_tpu_torch.models.encoders.swin import (
    _relative_position_index,
    block_attn_mask,
)
from fmc_uia_tpu_torch.ops import swin_block as sb

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(ref: np.ndarray, dt: str) -> float:
    top = max(float(np.abs(ref).max()), 1.0)
    if dt == "f32":
        return 1e-5 * top
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def _to_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _attn_inputs(rng, B, grid, C, H, ws, shift):
    hp = -(-grid // ws) * ws
    N = ws * ws
    x = rng.standard_normal((B, hp, hp, C)).astype(np.float32)
    w = dict(
        ln_scale=1 + 0.1 * rng.standard_normal(C),
        ln_bias=0.1 * rng.standard_normal(C),
        wqkv=rng.standard_normal((C, 3 * C)) / np.sqrt(C),
        bqkv=0.05 * rng.standard_normal(3 * C),
        wproj=rng.standard_normal((C, C)) / np.sqrt(C),
        bproj=0.05 * rng.standard_normal(C))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    table = (0.02 * rng.standard_normal(((2 * ws - 1) ** 2, H))).astype(
        np.float32)
    idx = _relative_position_index(ws).reshape(-1)
    bias = table[idx].reshape(N, N, H).transpose(2, 0, 1).copy()
    mask = block_attn_mask(grid, grid, ws, shift)
    return x, w, bias, mask


# (ws, grid, shift): no mask, shift mask, pad mask, shift + pad
ATTN_CASES = {
    "ws8_plain": (8, 16, 0), "ws8_shift": (8, 16, 4),
    "ws8_pad": (8, 12, 0), "ws8_shift_pad": (8, 12, 4),
    "ws7_plain": (7, 14, 0), "ws7_shift": (7, 14, 3),
    "ws7_pad": (7, 10, 0), "ws7_shift_pad": (7, 10, 3),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_branch_matches_branch_math(case, dt):
    ws, grid, shift = ATTN_CASES[case]
    C, H, B = 32, 2, 2
    rng = np.random.RandomState(sorted(ATTN_CASES).index(case))
    x, w, bias, mask = _attn_inputs(rng, B, grid, C, H, ws, shift)
    if "plain" in case:
        assert mask is None
    elif "pad" in case or "shift" in case:
        assert mask is not None
    dp = np.array([1.0, 0.5], np.float32)  # dp != 1 on one sample
    jdt, tdt = DTYPES[dt]

    # JAX: one whole image per _branch_math call (all window rows)
    outs = []
    for b in range(B):
        outs.append(_branch_math(
            jnp.asarray(x[b], jdt), jnp.asarray(w["ln_scale"]),
            jnp.asarray(w["ln_bias"]), jnp.asarray(w["wqkv"]),
            jnp.asarray(w["bqkv"]), jnp.asarray(w["wproj"]),
            jnp.asarray(w["bproj"]), jnp.asarray(bias),
            None if mask is None else jnp.asarray(mask),
            jnp.asarray(dp[b]), num_heads=H, ws=ws, compute_dtype=jdt))
    ref = np.stack([_to_np(o) for o in outs])

    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    args = (tw["ln_scale"], tw["ln_bias"], tw["wqkv"].t().contiguous(),
            tw["bqkv"], tw["wproj"].t().contiguous(), tw["bproj"],
            torch.from_numpy(bias),
            None if mask is None else torch.from_numpy(mask), H)
    xt = torch.from_numpy(x).to(tdt)
    got = sb.attention_branch_reference(xt, *args, dp=torch.from_numpy(dp))
    assert got.dtype == tdt and got.shape == xt.shape
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= _tol(ref, dt), (err, _tol(ref, dt))

    # the wrapper on a CPU tensor is the plain version and launches nothing
    sb.attention_branch.launches = 0
    via = sb.attention_branch(xt, *args, dp=torch.from_numpy(dp))
    assert torch.equal(via, got)
    assert sb.attention_branch.launches == 0


@pytest.mark.parametrize("case", ["ws8_shift_pad", "ws7_shift"])
def test_attention_branch_matches_pallas_interpret(case):
    """Against the whole Pallas kernel (interpret mode), f32."""
    ws, grid, shift = ATTN_CASES[case]
    C, H, B = 32, 2, 2
    rng = np.random.RandomState(5)
    x, w, bias, mask = _attn_inputs(rng, B, grid, C, H, ws, shift)
    dp = np.array([0.5, 1.0], np.float32)
    ref = np.asarray(fused_attention_branch(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in (
            "ln_scale", "ln_bias", "wqkv", "bqkv", "wproj", "bproj")),
        jnp.asarray(bias), jnp.asarray(mask), H,
        dp_scale=jnp.asarray(dp)))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = sb.attention_branch(
        torch.from_numpy(x), tw["ln_scale"], tw["ln_bias"],
        tw["wqkv"].t().contiguous(), tw["bqkv"], tw["wproj"].t().contiguous(),
        tw["bproj"], torch.from_numpy(bias), torch.from_numpy(mask), H,
        dp=torch.from_numpy(dp)).numpy()
    err = float(np.abs(got - ref).max())
    assert err <= _tol(ref, "f32"), err


def _mlp_inputs(rng, B, grid, C):
    x = rng.standard_normal((B, grid, grid, C)).astype(np.float32)
    w = dict(
        ln_scale=1 + 0.1 * rng.standard_normal(C),
        ln_bias=0.1 * rng.standard_normal(C),
        w1=rng.standard_normal((C, 4 * C)) / np.sqrt(C),
        b1=0.05 * rng.standard_normal(4 * C),
        w2=rng.standard_normal((4 * C, C)) / np.sqrt(4 * C),
        b2=0.05 * rng.standard_normal(C))
    return x, {k: v.astype(np.float32) for k, v in w.items()}


def _torch_mlp_args(w):
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    return (tw["ln_scale"], tw["ln_bias"], tw["w1"].t().contiguous(),
            tw["b1"], tw["w2"].t().contiguous(), tw["b2"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("C", [32, 64, 96])
def test_mlp_branch_matches_mlp_math(C, dt):
    B, grid = 2, 8
    rng = np.random.RandomState(C)
    x, w = _mlp_inputs(rng, B, grid, C)
    dp = np.array([1.0, 0.5], np.float32)
    jdt, tdt = DTYPES[dt]
    T = B * grid * grid
    dp_rows = np.repeat(dp, grid * grid)[:, None]
    ref = _to_np(_mlp_math(
        jnp.asarray(x.reshape(T, C), jdt), *(jnp.asarray(w[k]) for k in (
            "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")),
        jnp.asarray(dp_rows), compute_dtype=jdt)).reshape(x.shape)
    xt = torch.from_numpy(x).to(tdt)
    args = _torch_mlp_args(w)
    got = sb.mlp_branch_reference(xt, *args, dp=torch.from_numpy(dp))
    assert got.dtype == tdt
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= _tol(ref, dt), (err, _tol(ref, dt))

    sb.mlp_branch.launches = 0
    via = sb.mlp_branch(xt, *args, dp=torch.from_numpy(dp))
    assert torch.equal(via, got)
    assert sb.mlp_branch.launches == 0


def test_mlp_branch_matches_pallas_interpret():
    """Against the whole Pallas MLP kernel (interpret mode), f32."""
    rng = np.random.RandomState(11)
    x, w = _mlp_inputs(rng, 2, 16, 32)
    dp = np.array([0.5, 1.0], np.float32)
    ref = np.asarray(fused_mlp_branch(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in (
            "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")),
        dp_scale=jnp.asarray(dp)))
    got = sb.mlp_branch(torch.from_numpy(x), *_torch_mlp_args(w),
                        dp=torch.from_numpy(dp)).numpy()
    err = float(np.abs(got - ref).max())
    assert err <= _tol(ref, "f32"), err
