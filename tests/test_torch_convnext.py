"""The port's ConvNeXt encoder against the JAX package's, on the CPU, with
the same seeded numpy weights bridged into both.

- ``convnext_nano_test`` (one block a stage, 16..128 wide) at 64², f32:
  the four features within 2e-5 of each one's largest magnitude, the
  grads of the input and of every leaf (``gamma`` included; one seeded
  cotangent) within 1e-4.
- bf16 compute: each feature within 5e-2 of the JAX feature's largest
  magnitude (both sides round each conv and dense output to bf16 in other
  orders), in JAX's dtype per feature: f32 at stage 0 (the stem
  LayerNorm returns f32 and f32 + bf16 promotes), bf16 at stages 1-3
  (after each ``down{s}`` conv).
- The variants' param trees equal the JAX trees; ``build_convnext`` reads
  ``model.encoder.drop_path_rate`` and takes ``timm:`` names with a tag.
- Stochastic depth in train mode drops whole samples' branches.
- A whole train step per type (``check_train_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models.encoders import convnext as jcn
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models.encoders import convnext as pcn
from helpers import make_tiny_config
from torch_port_utils import (
    check_encoder_bf16,
    check_encoder_f32,
    check_train_step,
    encoder_overrides,
    port_shapes,
    train_step_pair,
)

NANO = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
BF16_TOL = 5e-2


def _x(seed=0, size=64, batch=2):
    return np.random.RandomState(seed).rand(batch, size, size, 3).astype(
        np.float32)


def test_convnext_nano_f32_and_grads():
    check_encoder_f32(
        jcn.ConvNeXtEncoder(drop_path_rate=0.0, **NANO),
        pcn.ConvNeXtEncoder(drop_path_rate=0.0, **NANO), _x(), 1)


def test_convnext_nano_bf16_feature_dtypes():
    dtypes = check_encoder_bf16(
        jcn.ConvNeXtEncoder(drop_path_rate=0.0, dtype=jnp.bfloat16, **NANO),
        pcn.ConvNeXtEncoder(drop_path_rate=0.0, dtype=torch.bfloat16,
                            **NANO), _x(1), 2, BF16_TOL)
    assert dtypes == [torch.float32] + [torch.bfloat16] * 3


@pytest.mark.parametrize("name", sorted(pcn._CONVNEXT_VARIANTS))
def test_convnext_variant_param_trees(name):
    jenc = jcn.build_convnext(name)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    with torch.device("meta"):  # shapes only, no memory
        enc = pcn.build_convnext(name)
    assert {n: tuple(p.shape) for n, p in enc.named_parameters()} == (
        port_shapes(shapes))
    assert enc.out_channels == jenc.out_channels
    assert enc.depths == jenc.depths


def test_build_convnext_names_and_drop_path():
    cfg = Config(config_dict=make_tiny_config(model={"encoder": {
        "name": "timm:convnext_tiny.fb_in22k", "drop_path_rate": 0.3}})
        .config)
    enc = pcn.build_convnext("timm:convnext_tiny.fb_in22k", cfg)
    assert enc.depths == (3, 3, 9, 3) and enc.dims == (96, 192, 384, 768)
    rates = [m.drop_path for m in enc.modules()
             if isinstance(m, pcn.ConvNeXtBlock)]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 18))
    assert rates[0] == 0.0
    with pytest.raises(ValueError, match="Unknown convnext variant"):
        pcn.build_convnext("convnext_t")


def test_convnext_drop_path_drops_whole_samples():
    """Train mode at rate 0.5 on one block: each sample's branch is kept
    (scaled by 1/keep) or dropped whole; eval mode is deterministic."""
    blk = pcn.ConvNeXtBlock(16, drop_path=0.5)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())))
        x = torch.randn(64, 8, 8, 16, generator=torch.Generator()
                        .manual_seed(0))
        full = blk(x) - x
        y = blk(x, train=True, generator=torch.Generator().manual_seed(1)) - x
    kept = (y.abs().flatten(1).amax(1) > 0)
    assert 10 < int(kept.sum()) < 54
    torch.testing.assert_close(y[kept], 2.0 * full[kept], rtol=1e-5,
                               atol=1e-5)
    assert bool((y[~kept] == 0).all())


TYPES = ("segmentation", "classification", "detection", "Regression")


@pytest.fixture(scope="module")
def step_pair():
    return train_step_pair(TYPES, overrides=encoder_overrides(
        name="convnext_nano_test"))


@pytest.mark.parametrize("ttype", TYPES)
def test_convnext_nano_train_step_matches_jax(step_pair, ttype):
    check_train_step(step_pair[ttype])
