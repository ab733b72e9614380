"""The fused Swin MLP branch above C = 256, on the CPU, against the JAX
package: the widths it fuses under ``FMC_FUSED_MLP_MAX_C`` (C % 32 == 0
up to 1003, here 320, 384, 512, 640, 768 and 960: the port's K2 kernels,
held against these plain versions on the card by chip_smoke.py phase 15)
and the widths whose weights overflow its Pallas kernel's budget (C =
1024, 1536: ``_mlp_math`` under XLA, the port's plain version under
autograd).

- the plain forward against ``_mlp_math``, the plain pullback against
  ``_mlp_pullback`` (what K2b computes) and autograd through the plain
  forward against ``jax.vjp`` of ``_mlp_math`` (JAX's XLA branch), T = 64,
  f32 and bf16; ``test_torch_swin_kernels``' and ``test_torch_swin_bwd``'
  tolerances (f32 1e-5 of the largest magnitude, 4e-5 for dx; bf16 2 bf16
  ulps of it);
- the wrappers against ``fused_mlp_branch`` itself (Pallas in interpret
  mode) at C = 512 and 640, B = 1 on an 8 x 8 grid (``_pick_mlp_tile``
  picks 64), forward and VJP, f32;
- the port's gate (``mlp_fits_jax_kernel``) against ``_pick_mlp_tile``
  finding no tile at any token count, at every width of the JAX Swin
  variants and every C % 32 == 0 in (256, 1024]; a ``SwinBlock`` at
  C = 640 under a gate of 1003 runs the fused branch;
- a swin_b-width encoder, depths (1, 1, 2, 1) at 64², window 8, under the
  knob at 512 and 1024 with the fused MLP on: f32 features within 2e-5
  and grads within 1e-4 of their largest magnitude, bf16 features within
  5e-2 (the encoder rules of ``torch_port_utils``);
- one segmentation train step of that encoder's model under the knob at
  1024 (stage 2 on K2's plain versions, stage 3 on the XLA-branch math),
  ``check_train_step``'s tolerances, with the grad norm taken in f64 from
  the port's grads: torch's f32 ``clip_grad_norm_`` on the CPU lands
  3.2e-5 from the f64 norm of its own 22.9 M grads here (the grads' f64
  norm is 2.2e-6 from JAX's logged norm), so the logged norm is held to
  1e-4 of that f64 norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models.encoders import swin as jax_swin
from fmc_uia_tpu.ops.swin_block_pallas import (
    _mlp_math,
    _mlp_pullback,
    _pick_mlp_tile,
    fused_mlp_branch,
)
from fmc_uia_tpu_torch.models.encoders import swin as port_swin
from fmc_uia_tpu_torch.ops import swin_block as sb
from test_torch_swin_bwd import MLP_NAMES, _check, _mlp_port_order
from test_torch_swin_kernels import (
    DTYPES,
    _mlp_inputs,
    _to_np,
    _tol,
    _torch_mlp_args,
)
from torch_port_utils import (
    check_encoder_bf16,
    check_encoder_f32,
    check_train_step,
    encoder_overrides,
    train_step_pair,
)

KEYS = ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")
WIDE = (320, 384, 512, 640, 768, 960)
# swin_b's widths (128, 256, 512, 1024) at a depth the CPU runs in seconds
SWIN_B_CUT = dict(embed_dim=128, depths=(1, 1, 2, 1),
                  num_heads=(4, 8, 16, 32))


def _rows(C, seed):
    """x [1, 8, 8, C] (T = 64) and seeded weights in the JAX layout."""
    return _mlp_inputs(np.random.RandomState(seed), 1, 8, C)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("C", WIDE)
def test_plain_forward_matches_mlp_math(C, dt):
    x, w = _rows(C, C)
    jdt, tdt = DTYPES[dt]
    T = x.size // C
    dp = np.float32(0.5)
    ref = _to_np(_mlp_math(jnp.asarray(x.reshape(T, C), jdt),
                           *(jnp.asarray(w[k]) for k in KEYS),
                           jnp.asarray(dp), compute_dtype=jdt))
    got = sb.mlp_branch_reference(torch.from_numpy(x).to(tdt),
                                  *_torch_mlp_args(w),
                                  dp=torch.tensor([dp]))
    assert got.dtype == tdt
    err = float(np.abs(got.float().numpy().reshape(T, C) - ref).max())
    assert err <= _tol(ref, dt), (err, _tol(ref, dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("C", WIDE)
def test_plain_pullback_matches_mlp_pullback(C, dt):
    x, w = _rows(C, 10 + C)
    dy = np.random.RandomState(C).standard_normal(x.shape).astype(
        np.float32)
    jdt, tdt = DTYPES[dt]
    T, dp = x.size // C, np.float32(0.5)
    ref = [_to_np(g) for g in _mlp_pullback(
        jnp.asarray(x.reshape(T, C), jdt),
        *(jnp.asarray(w[k]) for k in KEYS),
        jnp.asarray(dp), jnp.asarray(dy.reshape(T, C), jdt),
        compute_dtype=jdt)]
    ref[0] = ref[0].reshape(x.shape)
    got = sb.mlp_branch_backward_reference(
        torch.from_numpy(x).to(tdt), *_torch_mlp_args(w),
        torch.from_numpy(dy).to(tdt), dp=torch.tensor([dp]))
    _check(MLP_NAMES, got, _mlp_port_order(ref), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("C", WIDE)
def test_plain_autograd_matches_vjp_of_mlp_math(C, dt):
    """JAX's XLA branch: ``jax.vjp`` of ``_mlp_math``; the port's: torch
    autograd through ``mlp_branch_reference`` (the casts round the
    cotangents at the same points on both sides)."""
    x, w = _rows(C, 20 + C)
    dy = np.random.RandomState(1 + C).standard_normal(x.shape).astype(
        np.float32)
    jdt, tdt = DTYPES[dt]
    T, dp = x.size // C, np.float32(0.5)

    def f(xt, *ws):
        return _mlp_math(xt, *ws, jnp.asarray(dp), compute_dtype=jdt)

    _, pull = jax.vjp(f, jnp.asarray(x.reshape(T, C), jdt),
                      *(jnp.asarray(w[k]) for k in KEYS))
    ref = [_to_np(g) for g in pull(jnp.asarray(dy.reshape(T, C), jdt))]
    ref[0] = ref[0].reshape(x.shape)
    leaves = [torch.from_numpy(x).to(tdt), *_torch_mlp_args(w)]
    ins = [t.clone().requires_grad_(True) for t in leaves]
    out = sb.mlp_branch_reference(*ins, dp=torch.tensor([dp]))
    got = torch.autograd.grad(out, ins, torch.from_numpy(dy).to(tdt))
    assert got[0].dtype == tdt
    _check(MLP_NAMES, got, _mlp_port_order(ref), dt)


def test_wrappers_match_pallas_interpret_c512():
    """``mlp_branch`` / ``mlp_branch_backward`` (their plain versions on
    CPU tensors) against the Pallas kernel pair at C = 512, f32."""
    _check_wrappers_against_pallas(512, 5)


def test_wrappers_match_pallas_interpret_c640():
    """The same at C = 640, a width only the run-time-C kernels take."""
    _check_wrappers_against_pallas(640, 7)


def _check_wrappers_against_pallas(C, seed):
    x, w = _rows(C, seed)
    T = x.size // C
    assert _pick_mlp_tile(T, C, 4 * C, bwd=False) == 64
    assert _pick_mlp_tile(T, C, 4 * C, bwd=True) == 64
    dy = np.random.RandomState(seed + 1).standard_normal(x.shape).astype(
        np.float32)
    dp = np.array([0.5], np.float32)

    def f(xx, *ws):
        return fused_mlp_branch(xx, *ws, dp_scale=jnp.asarray(dp))

    ref, pull = jax.vjp(f, jnp.asarray(x),
                        *(jnp.asarray(w[k]) for k in KEYS))
    ref = np.asarray(ref)
    jgrads = [np.asarray(g) for g in pull(jnp.asarray(dy))]
    args = _torch_mlp_args(w)
    got = sb.mlp_branch(torch.from_numpy(x), *args, dp=torch.from_numpy(dp))
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= _tol(ref, "f32"), err
    grads = sb.mlp_branch_backward(torch.from_numpy(x), *args,
                                   torch.from_numpy(dy),
                                   dp=torch.from_numpy(dp))
    _check(MLP_NAMES, grads, _mlp_port_order(jgrads), "f32")


# token counts: B in (1, 8, 24, 64) over the stage grids of 512² and 224²
TOKENS = sorted({b * g * g for b in (1, 8, 24, 64)
                 for g in (128, 64, 56, 32, 28, 16, 14, 8, 7, 4, 2)})


def test_gate_matches_pick_mlp_tile():
    """At every width of the JAX Swin variants and every C % 32 == 0 in
    (256, 1024] (Ch = 4C): the port sends a block to K2 exactly where
    ``_pick_mlp_tile`` finds a tile at some token count, and K2 takes
    every such width and no other above 256."""
    variants = {v["embed_dim"] * 2 ** s
                for v in jax_swin._SWIN_VARIANTS.values() for s in range(4)}
    assert {384, 512, 768, 1024, 1536} <= variants
    widths = sorted(variants | set(range(288, 1025, 32)))
    for C in widths:
        some_tile = any(_pick_mlp_tile(T, C, 4 * C, bwd=bwd) > 0
                        for T in TOKENS for bwd in (False, True))
        assert sb.mlp_fits_jax_kernel(C, 4 * C) == some_tile, C
        if some_tile:
            sb.mlp_kernel_dims(C, 4 * C, torch.bfloat16)
            if C <= sb.MLP_F32_MAX_C:
                sb.mlp_kernel_dims(C, 4 * C, torch.float32)
        else:
            with pytest.raises(ValueError, match="MLP kernels"):
                sb.mlp_kernel_dims(C, 4 * C, torch.bfloat16)
    assert not sb.mlp_fits_jax_kernel(1024, 4096)
    assert sb.mlp_fits_jax_kernel(992, 3968)
    assert sb.MLP_MAX_C == 1003


def test_swin_block_c640_routes_to_the_fused_branch(monkeypatch):
    """A block at C = 640 under a gate of 1003 builds, takes the fused
    branch (K2 on the card, its plain version here) and not the XLA-branch
    math, and its output is the branch's."""
    blk = port_swin.SwinBlock(640, 20, 8, 0, fused_mlp=True,
                              fused_mlp_max_c=1003)
    assert blk.fused_mlp and not blk.mlp_math
    g = torch.Generator().manual_seed(64)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return sb.mlp_branch(*args, **kw)

    monkeypatch.setattr(port_swin, "mlp_branch", counted)
    monkeypatch.setattr(port_swin, "mlp_branch_reference", None)
    x = torch.randn(1, 8, 8, 640, generator=g)
    out = blk(x)
    assert calls == [torch.Size([1, 8, 8, 640])]
    assert out.shape == x.shape and torch.isfinite(out).all()


def _encoder_pair(max_c, dtype, monkeypatch):
    monkeypatch.setenv("FMC_FUSED_MLP_MAX_C", str(max_c))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jenc = jax_swin.SwinEncoder(window_size=8, drop_path_rate=0.0,
                                fused_block=True, fused_mlp=True,
                                ln_bf16=True, dtype=jdt, **SWIN_B_CUT)
    port = port_swin.SwinEncoder(window_size=8, drop_path_rate=0.0,
                                 fused_block=True, fused_mlp=True,
                                 ln_bf16=True, fused_mlp_max_c=max_c,
                                 dtype=dtype, **SWIN_B_CUT)
    kernel = [getattr(port, f"stage{s}_block0").fused_mlp for s in range(4)]
    math = [getattr(port, f"stage{s}_block0").mlp_math for s in range(4)]
    assert kernel == [True, True, True, False]
    assert math == [False, False, False, max_c >= 1024]
    return jenc, port


def _x():
    # B = 1: the C = 512 stage's 16 tokens make one Pallas tile in JAX
    return np.random.RandomState(9).rand(1, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("max_c", [512, 1024])
def test_swin_b_width_encoder_f32(max_c, monkeypatch):
    jenc, port = _encoder_pair(max_c, torch.float32, monkeypatch)
    check_encoder_f32(jenc, port, _x(), seed=max_c)


@pytest.mark.parametrize("max_c", [512, 1024])
def test_swin_b_width_encoder_bf16(max_c, monkeypatch):
    jenc, port = _encoder_pair(max_c, torch.bfloat16, monkeypatch)
    dtypes = check_encoder_bf16(jenc, port, _x(), max_c + 1, 5e-2)
    assert dtypes[1:] == [torch.bfloat16] * 3


def test_swin_b_width_seg_train_step(monkeypatch):
    monkeypatch.setenv("FMC_FUSED_MLP_MAX_C", "1024")
    for variants in (jax_swin._SWIN_VARIANTS, port_swin._SWIN_VARIANTS):
        monkeypatch.setitem(variants, "swin_b", SWIN_B_CUT)
    r = train_step_pair(("segmentation",), overrides=encoder_overrides(
        name="swin_b", window_size=8, fused_block=True, fused_mlp=True,
        ln_bf16=True))["segmentation"]
    blocks = [getattr(r["model"].encoder, f"stage{s}_block0")
              for s in range(4)]
    assert [b.fused_mlp for b in blocks] == [True, True, True, False]
    assert blocks[3].mlp_math
    own = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                            for g in r["grads"].values())))
    assert abs(r["logs"]["grad_norm"] - own) <= 1e-4 * own
    check_train_step(dict(r, logs=dict(r["logs"], grad_norm=own)))
