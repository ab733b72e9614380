"""The port's unfused Swin attention path (``fused_block: false``, or a
stage left out of ``fused_stages``) against the JAX package's
``WindowAttention`` chain, on the CPU, with the same seeded numpy weights
bridged into both (the JAX fused stages run their Pallas kernels in
interpret mode, the port's their plain versions).

swin_micro (2, 2, 2, 2) x 32 at 64²: window 8 gives a shifted stage 0
(grid 16), no shift at grid 8 and padded stages 2-3; window 7 pads and
shifts stages 0-1. Cases: every stage unfused, ``fused_stages`` [0, 1],
[3] and [], under ``softmax_bf16`` and ``ln_bf16`` on and off.

Tolerances, of each output's or grad's largest magnitude:
- f32: the four features within 2e-5, the grads of the input and of
  every leaf (one seeded cotangent) within 1e-4;
- bf16 compute (f32 params): the features within 5e-2 (both sides round
  every product, the bf16 scores and softmax and each LayerNorm output to
  bf16 in other orders), in JAX's dtype per feature; the grads of every
  leaf (one bf16 cotangent) no further from JAX's f32 grads than 1.5 x
  JAX's own bf16 grads are, or 2e-2 (``test_bf16_grads``);
- ``FMC_FUSED_MLP_MAX_C=128``: the C = 256 stage takes the plain MLP on
  both sides, f32 within 2e-5.

The train steps are in test_torch_swin_unfused_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models.encoders.swin import SwinEncoder as JaxSwinEncoder
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models.encoders.swin import (
    SwinEncoder,
    build_swin,
)
from fmc_uia_tpu_torch.utils.convert import jax_leaves_to_port
from helpers import make_tiny_config
from torch_port_utils import (
    check_encoder_bf16,
    check_encoder_f32,
    close_rel,
    encoder_pair,
)

MICRO = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))
# (window, fused_block, fused_stages, softmax_bf16, ln_bf16)
CASES = {
    "unfused_w8_sb_lb": (8, False, None, True, True),
    "unfused_w7": (7, False, None, False, False),
    "stages01_w8_sb_lb": (8, True, (0, 1), True, True),
    "stages3_w7_lb": (7, True, (3,), False, True),
    "stages_none_w8_sb": (8, True, (), True, False),
}


def _pair(case, dtype, scan=True):
    ws, fb, fs, sb, lb = CASES[case]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # a bf16 stream changes dtype inside a block (an f32 LayerNorm output
    # plus a bf16 branch), which a JAX scan carry refuses: bf16 unrolled
    jenc = JaxSwinEncoder(window_size=ws, drop_path_rate=0.0,
                          scan_stages=(0, 1, 3) if scan and jdt ==
                          jnp.float32 else (),
                          fused_block=fb, fused_mlp=True, fused_stages=fs,
                          softmax_bf16=sb, ln_bf16=lb, dtype=jdt, **MICRO)
    port = SwinEncoder(window_size=ws, drop_path_rate=0.0, fused_block=fb,
                       fused_stages=fs, softmax_bf16=sb, ln_bf16=lb,
                       fused_mlp=True, dtype=dtype, **MICRO)
    want = [fb and (fs is None or s in fs) for s in range(4)]
    got = [getattr(port, f"stage{s}_block0").fused_block for s in range(4)]
    assert got == want
    return jenc, port


def _x(seed=7):
    return np.random.RandomState(seed).rand(2, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_outputs_and_grads(case):
    jenc, port = _pair(case, torch.float32)
    check_encoder_f32(jenc, port, _x(), seed=CASES[case][0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_outputs(case):
    jenc, port = _pair(case, torch.bfloat16)
    dtypes = check_encoder_bf16(jenc, port, _x(), CASES[case][0], 5e-2)
    assert dtypes[1:] == [torch.bfloat16] * 3


def _jax_grads(jenc, params, x, dys):
    """The params' grads of ``jenc`` at ``x`` for the cotangents ``dys``
    (cast to each output's dtype), as port names and layouts."""
    shapes = jax.eval_shape(lambda p: jenc.apply({"params": p}, x), params)

    @jax.jit
    def grads(p, a, d):
        return jax.vjp(lambda p: jenc.apply({"params": p}, a), p)[1](d)[0]

    g = grads(params, jnp.asarray(x),
              [jnp.asarray(d, s.dtype) for d, s in zip(dys, shapes)])
    return jax_leaves_to_port(jax.tree_util.tree_map(np.asarray, g))


@pytest.mark.parametrize("case", ["unfused_w8_sb_lb", "unfused_w7"])
def test_bf16_grads(case):
    """bf16 compute, one seeded cotangent: every leaf's grad no further
    from the f32 grad (JAX, the same weights) than 1.5 x the JAX
    package's own bf16 grad is, or 2e-2 of the leaf's largest magnitude.
    The rel-pos tables of the 4² and 2² stages sum many windows' score
    grads that cancel, and their bf16 grads move by up to 0.12 of their
    max in JAX itself (the port's by up to 0.08)."""
    jenc16, port = _pair(case, torch.bfloat16)
    jenc32, _ = _pair(case, torch.float32, scan=False)
    x = _x(3)
    params = encoder_pair(jenc16, port, x, seed=11)
    outs = port(torch.from_numpy(x))
    rng = np.random.RandomState(12)
    dys = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
           for o in outs]
    got = torch.autograd.grad(
        outs, list(port.parameters()),
        [torch.from_numpy(d).to(o.dtype) for d, o in zip(dys, outs)])
    j16 = _jax_grads(jenc16, params, x, dys)
    j32 = _jax_grads(jenc32, params, x, dys)
    names = [n for n, _ in port.named_parameters()]
    assert set(j16) == set(j32) == set(names)
    for name, g in zip(names, got):
        assert g.dtype == torch.float32
        top = float(np.abs(j32[name]).max())
        assert top > 0, name
        own = float(np.abs(j16[name] - j32[name]).max()) / top
        close_rel(g, j32[name], max(1.5 * own, 2e-2), f"bf16 d {name}")


def test_fused_mlp_max_c_128_matches_jax(monkeypatch):
    monkeypatch.setenv("FMC_FUSED_MLP_MAX_C", "128")
    cfg = Config(config_dict=make_tiny_config(model={"encoder": {
        "name": "swin_micro", "window_size": 8, "drop_path_rate": 0.0,
        "fused_block": True, "fused_mlp": True}}).config)
    port = build_swin("swin_micro", cfg)
    flags = [getattr(port, f"stage{s}_block1").fused_mlp for s in range(4)]
    assert flags == [True, True, True, False]  # C = 32, 64, 128, 256
    jenc = JaxSwinEncoder(window_size=8, drop_path_rate=0.0,
                          fused_block=True, fused_mlp=True, **MICRO)
    check_encoder_f32(jenc, port, _x(5), seed=128)


def test_build_swin_reads_the_unfused_keys():
    cfg = Config(config_dict=make_tiny_config(model={"encoder": {
        "name": "swin_micro", "fused_block": True, "fused_stages": [0, 1],
        "softmax_bf16": True}}).config)
    enc = build_swin("swin_micro", cfg, dtype=torch.bfloat16)
    blocks = [getattr(enc, f"stage{s}_block{b}") for s in range(4)
              for b in range(2)]
    assert [b.fused_block for b in blocks] == [True] * 4 + [False] * 4
    assert all(b.score_dtype == torch.bfloat16 for b in blocks)
    # bf16 scores only where the compute dtype is bf16, as in JAX
    enc = build_swin("swin_micro", cfg, dtype=torch.float32)
    assert enc.stage3_block0.score_dtype == torch.float32
