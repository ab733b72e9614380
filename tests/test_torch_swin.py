"""The port's SwinEncoder against the JAX SwinEncoder (fused attention and
MLP branches, Pallas in interpret mode), f32, with the same seeded numpy
weights bridged into both.

swin_micro at 64² with scan_stages (0, 1, 3) covers scanned and unrolled
stages; window 8 gives a shifted stage 0 (grid 16), no shift at grid 8 = ws
and padding at stages 2/3 (grids 4, 2); window 7 gives shift + pad at
stages 0/1 (grids 16 -> 21, 8 -> 14). Tolerance: 2e-5 of each output's
largest magnitude (f32 through 8 blocks, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models.encoders.swin import SwinBlock as JaxSwinBlock
from fmc_uia_tpu.models.encoders.swin import SwinEncoder as JaxSwinEncoder
from fmc_uia_tpu_torch.models.encoders.swin import SwinBlock, SwinEncoder
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from torch_port_utils import random_like_tree

MICRO = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))


def _close(got: torch.Tensor, ref, rel: float = 2e-5):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1.0), err


@pytest.mark.parametrize("ws", [8, 7])
def test_swin_encoder_matches_jax(ws):
    enc = JaxSwinEncoder(window_size=ws, drop_path_rate=0.0,
                         scan_stages=(0, 1, 3), fused_block=True,
                         fused_mlp=True, ln_bf16=True, dtype=jnp.float32,
                         **MICRO)
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), x)["params"]
    assert "stage0_scan" in shapes and "stage2_block1" in shapes
    params = random_like_tree(shapes, seed=ws)
    ref = jax.jit(lambda p, x: enc.apply({"params": p}, x))(params, x)

    port = SwinEncoder(window_size=ws, ln_bf16=True, fused_mlp=True,
                       dtype=torch.float32, **MICRO)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == 4
    for g, r in zip(got, ref):
        _close(g, r)


def test_swin_block_c512_unfused_mlp_matches_jax():
    """C = 512 > 256: the MLP half takes LayerNorm -> Linear -> tanh-GELU
    -> Linear outside the fused branch; grid 16 > ws shifts."""
    C, heads = 512, 16
    blk = JaxSwinBlock(dim=C, num_heads=heads, window_size=8, shift=4,
                       fused_block=True, fused_mlp=True, dtype=jnp.float32)
    x = np.random.RandomState(3).standard_normal((1, 16, 16, C)).astype(
        np.float32)
    shapes = jax.eval_shape(blk.init, jax.random.PRNGKey(0), x)["params"]
    params = random_like_tree(shapes, seed=512)
    ref = blk.apply({"params": params}, x)

    port = SwinBlock(C, heads, 8, shift=4, fused_mlp=True,
                     dtype=torch.float32)
    assert not port.fused_mlp
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, ref)
