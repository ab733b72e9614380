"""The port's ViT/DINOv3 encoder against the JAX package's, f32, on the
CPU, with the same seeded numpy weights bridged into both
(``load_jax_params``): ``rope_sincos`` and ``apply_rope``; ``ViTBlock``
with the global attention 'on' (the port's K4 plain versions; the JAX
package's CPU path ``_xla_attention``) and 'off' (the einsum path on both
sides), with and without LayerScale and RoPE; ``ViTBackbone`` in the
plain (prefix tokens + pos_embed) and DINOv3 (cls + storage tokens, RoPE,
LayerScale) regimes; ``ViTMultiScaleEncoder`` with the 'resize' adapter;
and the whole DINOv3 model for the four task types.

Narrow widths: 64 wide, 2 heads, depth 2, patch 8 at 32² (16 patches + 5
prefix tokens); the model patches ``_VIT_VARIANTS['vit_b']`` to that in
both packages inside the test. Tolerances: 1e-6 absolute for the RoPE
tables (values in [-1, 1]); 2e-5 of each output's largest magnitude
elsewhere (f32 through blocks and the FPN, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.encoders import vit as jvit
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.models.encoders import vit as pvit
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from helpers import make_tiny_config
from torch_port_utils import random_like_tree

DIM, HEADS, DEPTH, PATCH, SIZE = 64, 2, 2, 8, 32
NARROW = dict(embed_dim=DIM, depth=DEPTH, num_heads=HEADS)
DINO = dict(rope=True, layerscale=True, num_storage_tokens=4)
# the DINOv3 preset's encoder section, at the narrow widths
DINO_OVERRIDES = {
    "data": {"image_size": SIZE},
    "model": {"encoder": {
        "name": "dinov3", "timm_name": "vit_base_patch8_dinov3",
        "pretrained": None, "freeze_dino": True, "out_indices": [0, 1],
        "flash_attention": "on",
        "adapter": {"type": "resize", "channels": 32}}}}
TASKS = {"T2B_organ_b": "segmentation", "T1_planes": "classification",
         "T4_box": "detection", "T5_points": "Regression"}


def _close(got, ref, rel=2e-5):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1.0), err


@pytest.mark.parametrize("periods", [(100.0, None, None), (100.0, 0.5, 40.0)])
def test_rope_tables_and_rotation_match_jax(periods):
    base, pmin, pmax = periods
    per = jvit.rope_default_periods(64, base, pmin, pmax)
    np.testing.assert_array_equal(
        pvit.rope_default_periods(64, base, pmin, pmax), per)
    jsin, jcos = jvit.rope_sincos(4, 6, jnp.asarray(per), 5)
    sin, cos = pvit.rope_sincos(4, 6, torch.from_numpy(per), 5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-6)
    t = np.random.RandomState(0).standard_normal((2, 29, 3, 64)).astype(
        np.float32)
    ref = jvit.apply_rope(jnp.asarray(t), jsin, jcos)
    got = pvit.apply_rope(torch.from_numpy(t), sin, cos)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("dino", [False, True])
def test_vit_block_matches_jax(mode, dino):
    N = 21
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, N, DIM)).astype(np.float32)
    rope = None
    if dino:
        per = jvit.rope_default_periods(DIM // HEADS)
        rope = jvit.rope_sincos(4, 4, jnp.asarray(per), 5)
    blk = jvit.ViTBlock(dim=DIM, num_heads=HEADS, flash_attention=mode,
                        layerscale=dino)
    shapes = jax.eval_shape(blk.init, jax.random.PRNGKey(0), x,
                            rope)["params"]
    assert ("ls1" in shapes) == dino
    params = random_like_tree(shapes, seed=11)
    ref = blk.apply({"params": params}, x, rope)

    port = pvit.ViTBlock(DIM, HEADS, flash_attention=mode, layerscale=dino)
    assert port.use_flash(N) == (mode == "on")
    load_jax_params(port, params)
    prope = None if rope is None else tuple(
        torch.from_numpy(np.array(t)) for t in rope)
    with torch.no_grad():
        got = port(torch.from_numpy(x), prope)
    _close(got, ref)


def test_auto_mode_switches_at_1024_tokens():
    blk = pvit.ViTBlock(DIM, HEADS, flash_attention="auto")
    assert not blk.use_flash(1023) and blk.use_flash(1024)


@pytest.mark.parametrize("dino", [False, True])
def test_vit_backbone_matches_jax(dino):
    kw = dict(NARROW, patch_size=PATCH, out_indices=(0, 1),
              flash_attention="on")
    kw.update(DINO if dino else dict(num_prefix_tokens=1))
    jbb = jvit.ViTBackbone(**kw)
    x = np.random.RandomState(4).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(jbb.init, jax.random.PRNGKey(0), x)["params"]
    params = random_like_tree(shapes, seed=12)
    ref = jbb.apply({"params": params}, x)

    port = pvit.ViTBackbone(**kw)
    port.make_pos_embed(SIZE // PATCH, SIZE // PATCH)
    load_jax_params(port, params)
    assert ("rope_periods" in dict(port.named_parameters())) == dino
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _close(g, r)


def test_multiscale_encoder_resize_matches_jax():
    kw = dict(NARROW, patch_size=PATCH, out_indices=(0, 1),
              adapter_type="resize", adapter_channels=32,
              flash_attention="on", **DINO)
    jenc = jvit.ViTMultiScaleEncoder(**kw)
    x = np.random.RandomState(5).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), x)["params"]
    assert set(shapes["adapter"]) == {f"proj{i}" for i in range(4)}
    params = random_like_tree(shapes, seed=13)
    ref = jenc.apply({"params": params}, x)

    port = pvit.ViTMultiScaleEncoder(**kw)
    load_jax_params(port, params)
    assert port.out_channels == (32,) * 4
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    # strides 4, 8, 16, 32 of 32²: 8² (bilinear up), 4², 2², 1² (pools)
    assert [tuple(g.shape[1:3]) for g in got] == [(8, 8), (4, 4), (2, 2),
                                                  (1, 1)]
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.fixture(scope="module")
def dino_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        mp.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        jcfg = make_tiny_config(**DINO_OVERRIDES)
        jreg = JaxRegistry.from_config(jcfg)
        jmodel = jax_build_model(jcfg, jreg)
        x0 = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
        shapes = jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                                method=JaxModel.init_all))["params"]
        params = random_like_tree(shapes, seed=14)
        cfg = Config(config_dict=jcfg.config)
        reg = TaskRegistry.from_config(cfg)
        model = build_model(cfg, reg, device="cpu")
        x = np.random.RandomState(6).standard_normal(
            (2, SIZE, SIZE, 3)).astype(np.float32)
        jax_out = {}  # flax builds the encoder at apply time: patched too
        for task_id, ttype in TASKS.items():
            gidx = reg[task_id].global_index
            jax_out[task_id] = jax.jit(lambda p, x, i: jmodel.apply(
                {"params": p}, x, ttype, i))(params, x, jnp.int32(gidx))
    load_jax_params(model, params)
    return dict(reg=reg, model=model, x=x, jax_out=jax_out)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_dino_model_outputs_match_jax(dino_pair, task_id):
    ttype = TASKS[task_id]
    enc = dino_pair["model"].encoder
    assert isinstance(enc, pvit.ViTMultiScaleEncoder)
    assert enc.backbone.rope and enc.backbone.num_prefix == 5
    jout = dino_pair["jax_out"][task_id]
    with torch.no_grad():
        out = dino_pair["model"](
            torch.from_numpy(dino_pair["x"]), ttype,
            torch.tensor(dino_pair["reg"][task_id].global_index))
    if ttype == "detection":
        assert set(out) == set(jout)
        for k in jout:
            _close(out[k], jout[k])
    else:
        _close(out, jout)
