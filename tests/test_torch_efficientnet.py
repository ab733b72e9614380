"""The port's EfficientNet encoder against the JAX package's, on the CPU,
with the same seeded numpy weights bridged into both.

- ``round_filters`` / ``round_repeats``, the feature widths and the param
  trees of b0..b7 equal the JAX package's.
- b0 at 32² and 64², f32: the four features within 2e-5 of each one's
  largest magnitude (at 32² the last two features are 2x2 and 1x1), the
  grads of the input and of every leaf (one seeded cotangent) within
  1e-4.
- bf16 compute at 64²: each feature within 5e-2 of the JAX feature's
  largest magnitude (both sides round every conv output to bf16 in other
  orders and the GroupNorms rescale the difference; JAX's own bf16 output
  is 1.4-4.1e-2 from its f32 one on these weights), f32 features on both
  sides (every GroupNorm returns f32).
- A whole train step per type (``check_train_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models.encoders import efficientnet as jef
from fmc_uia_tpu_torch.models.encoders import efficientnet as pef
from torch_port_utils import (
    check_encoder_bf16,
    check_encoder_f32,
    check_train_step,
    encoder_overrides,
    port_shapes,
    train_step_pair,
)

VARIANTS = [f"b{i}" for i in range(8)]


@pytest.mark.parametrize("variant", VARIANTS)
def test_scaling_rules_and_param_tree(variant):
    w, d = jef._COEFFS[variant]
    assert pef._COEFFS[variant] == (w, d)
    for c in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        assert pef.round_filters(c, w) == jef.round_filters(c, w), c
    for r in (1, 2, 3, 4):
        assert pef.round_repeats(r, d) == jef.round_repeats(r, d), r
    name = f"efficientnet-{variant}"
    jenc = jef.build_efficientnet(name)
    with torch.device("meta"):  # shapes only, no memory
        enc = pef.build_efficientnet(name)
    assert enc.out_channels == jenc.out_channels
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    assert {n: tuple(p.shape) for n, p in enc.named_parameters()} == (
        port_shapes(shapes))


def test_build_names():
    for name in ("efficientnet-b4", "efficientnet_b4",
                 "timm:efficientnet_b4"):
        with torch.device("meta"):
            enc = pef.build_efficientnet(name)
        assert (enc.width, enc.depth) == (1.4, 1.8)
        assert enc.out_channels == (32, 56, 160, 448)
    with pytest.raises(ValueError, match="b0..b7"):
        pef.build_efficientnet("efficientnet-b9")


@pytest.mark.parametrize("size", [32, 64])
def test_b0_f32_and_grads(size):
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(
        np.float32)
    check_encoder_f32(jef.EfficientNetEncoder(), pef.EfficientNetEncoder(),
                      x, size)


def test_b0_bf16():
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    dtypes = check_encoder_bf16(
        jef.EfficientNetEncoder(dtype=jnp.bfloat16),
        pef.EfficientNetEncoder(dtype=torch.bfloat16), x, 0, 5e-2)
    assert dtypes == [torch.float32] * 4


TYPES = ("segmentation", "classification", "detection", "Regression")


@pytest.fixture(scope="module")
def step_pair():
    return train_step_pair(TYPES, overrides=encoder_overrides(
        name="efficientnet-b0"))


@pytest.mark.parametrize("ttype", TYPES)
def test_b0_train_step_matches_jax(step_pair, ttype):
    check_train_step(step_pair[ttype])
