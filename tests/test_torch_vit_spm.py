"""The DINOv3 ViT encoder with the 'spm_interaction' adapter, port against
the JAX package, f32, on the CPU, with the same seeded numpy weights
bridged into both (``load_jax_params``):

* ``ViTMultiScaleEncoder(adapter_type='spm_interaction')`` (DINOv3 arch:
  RoPE, LayerScale, 4 storage tokens), with the default and a clipped
  ``vit_layer_mapping``;
* the whole model for the four task types;
* one ``freeze_dino`` train step per type (``train_step_pair`` /
  ``check_train_step``): the loss and the grad norm within 1e-5
  relative, every grad leaf within 1e-4 of its largest magnitude, the
  frozen backbone, ``offset_proj`` and ``vit_proj*`` included;
* a patch-14 'resize' encoder at 224² (a 16² map to strides 16 and 32:
  14² and 7², the antialiased non-integer downsample);
* ``dinov3_spm_config_dict()`` against the YAML, and the full-size
  encoder's parameter names and shapes against the JAX tree.

Test size, as the ViT tests: ``_VIT_VARIANTS['vit_b']`` patched to 64
wide, 2 heads, depth 2 in both packages (flax builds the encoder at apply
time, so the patch stays on while the JAX model runs); adapter 32
channels, stem 16, 4 heads, 4 points, at 64² (a 4² ViT map at patch 16,
21 tokens: the einsum attention path on both sides; pyramid 16²…2²).
Outputs within 2e-5 of their largest magnitude (f32 through the blocks,
the adapter and the FPN, summed in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.encoders import vit as jvit
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.models.encoders import vit as pvit
from fmc_uia_tpu_torch.models.encoders.adapters import (
    DeformableCrossAttention2D,
)
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from helpers import make_tiny_config
from torch_port_utils import (
    check_train_step,
    random_like_tree,
    train_step_pair,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(embed_dim=64, depth=2, num_heads=2)
SIZE = 64
SPM = {"type": "spm_interaction", "channels": 32, "spm_stem_channels": 16,
       "interaction_heads": 4, "interaction_points": 4,
       "interaction_offset_range": 0.25}
ENC_KW = dict(NARROW, patch_size=16, out_indices=(0, 1),
              adapter_type="spm_interaction", adapter_channels=32,
              spm_stem_channels=16, interaction_heads=4, interaction_points=4,
              interaction_offset_range=0.25, rope=True, layerscale=True,
              num_storage_tokens=4)
# the preset's encoder section at the test size; augmentation, dropout off
OVERRIDES = {
    "data": {"image_size": SIZE,
             "augmentation": {"train": {"random_brightness_contrast": 0.0,
                                        "gauss_noise": 0.0}}},
    "model": {
        "encoder": {"name": "dinov3",
                    "timm_name": "vit_base_patch16_dinov3", "pretrained": None,
                    "freeze_dino": True, "out_indices": [0, 1],
                    "adapter": SPM},
        "decoder": {"dropout": 0.0},
        "heads": {"classification": {"dropout": 0.0},
                  "regression": {"hidden_dims": [16, 8], "dropout": 0.0}}},
}
TYPES = ("segmentation", "classification", "detection", "Regression")
TASKS = {"T2B_organ_b": "segmentation", "T1_planes": "classification",
         "T4_box": "detection", "T5_points": "Regression"}


def _close(got, ref, rel=2e-5):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1.0), err


@pytest.fixture
def narrow_vit_b():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        mp.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        yield


@pytest.mark.parametrize("mapping", [None, [1, 0, 1, 7]])
def test_spm_encoder_matches_jax(mapping):
    kw = dict(ENC_KW, vit_layer_mapping=mapping)
    jenc = jvit.ViTMultiScaleEncoder(**kw)
    x = np.random.RandomState(5).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), x)["params"]
    assert {"spm", "vit_proj0", "interaction3"} <= set(shapes)
    assert "offset_proj" in shapes["interaction0"]["cross_attn"]
    params = random_like_tree(shapes, seed=13)
    ref = jenc.apply({"params": params}, x)

    port = pvit.ViTMultiScaleEncoder(**kw)
    load_jax_params(port, params)
    assert port.out_channels == (32,) * 4
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape[1:]) for g in got] == [
        (16, 16, 32), (8, 8, 32), (4, 4, 32), (2, 2, 32)]
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.fixture(scope="module")
def spm_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        mp.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        jcfg = make_tiny_config(**OVERRIDES)
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
        jax_out = {}
        for task_id, ttype in TASKS.items():
            gidx = reg[task_id].global_index
            jax_out[task_id] = jax.jit(lambda p, x, i: jmodel.apply(
                {"params": p}, x, ttype, i))(params, x, jnp.int32(gidx))
    load_jax_params(model, params)
    return dict(reg=reg, model=model, x=x, jax_out=jax_out)


@pytest.mark.parametrize("task_id", list(TASKS))
def test_spm_model_outputs_match_jax(spm_pair, task_id):
    ttype = TASKS[task_id]
    enc = spm_pair["model"].encoder
    assert enc.adapter_type == "spm_interaction" and enc.backbone.rope
    assert not enc.backbone.block0.use_flash(21)
    jout = spm_pair["jax_out"][task_id]
    with torch.no_grad():
        out = spm_pair["model"](
            torch.from_numpy(spm_pair["x"]), ttype,
            torch.tensor(spm_pair["reg"][task_id].global_index))
    if ttype == "detection":
        assert set(out) == set(jout)
        for k in jout:
            _close(out[k], jout[k])
    else:
        _close(out, jout)


@pytest.fixture(scope="module")
def train_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        mp.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        return train_step_pair(TYPES, overrides=OVERRIDES, size=SIZE)


@pytest.mark.parametrize("ttype", TYPES)
def test_spm_freeze_dino_train_step_matches_jax(train_pair, ttype):
    r = train_pair[ttype]
    # every head reads the stride-32 level (cls and reg read it alone)
    for leaf in ("encoder.backbone.block0.qkv.kernel",
                 "encoder.interaction3.cross_attn.offset_proj.kernel",
                 "encoder.interaction3.cross_attn.offset_proj.bias",
                 "encoder.vit_proj3.kernel",
                 "encoder.spm.stem0.Conv_0.kernel"):
        assert np.abs(r["grads"][leaf]).max() > 0, leaf
    check_train_step(r)


def test_patch14_resize_encoder_antialiased_downsample_matches_jax(
        narrow_vit_b):
    """A patch-14 DINOv3 'resize' encoder at 224²: the 16² map goes to
    14² (stride 16) and 7² (stride 32) through the antialiased resize."""
    from fmc_uia_tpu_torch.models.encoders.vit import build_vit_encoder

    jcfg = make_tiny_config(data={"image_size": 224}, model={"encoder": {
        "name": "dinov3", "timm_name": "vit_small_patch14_dinov3",
        "pretrained": None, "out_indices": [0, 1],
        "adapter": {"type": "resize", "channels": 32}}})
    jenc = jvit.build_vit_encoder("dinov3", jcfg)
    assert jenc.patch_size == 14
    x = np.random.RandomState(7).standard_normal((1, 224, 224, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), x)["params"]
    params = random_like_tree(shapes, seed=15)
    ref = jenc.apply({"params": params}, x)

    port = build_vit_encoder("dinov3", Config(config_dict=jcfg.config))
    assert port.backbone.patch_size == 14
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape[1:3]) for g in got] == [(56, 56), (28, 28),
                                                  (14, 14), (7, 7)]
    for g, r in zip(got, ref):
        _close(g, r)


def _port_shapes(tree, prefix=""):
    """{port name: port-layout shape} of a JAX tree of shapes."""
    from fmc_uia_tpu_torch.utils.convert import _KERNEL_PERM

    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if hasattr(v, "items"):
            out.update(_port_shapes(v, name + "."))
        else:
            s = tuple(v.shape)
            if k == "kernel":
                s = tuple(s[i] for i in _KERNEL_PERM[len(s)])
            out[name] = s
    return out


def test_dinov3_spm_config_dict_equals_yaml():
    from fmc_uia_tpu.config import Config as JaxConfig
    from fmc_uia_tpu_torch.flagship import dinov3_spm_config_dict
    from fmc_uia_tpu_torch.models.encoders.vit import build_vit_encoder

    with open(os.path.join(ROOT, "configs",
                           "vit_large_patch16_dinov3.yaml")) as f:
        want = yaml.safe_load(f)
    d = dinov3_spm_config_dict()
    assert d == want  # no override
    cfg = Config(config_dict=d)
    assert cfg.image_size == 224 and cfg.mixed_precision
    assert cfg.get("data.batch_size") == 64
    assert not cfg.get("data.fused_preprocess", False)
    assert len(cfg.get_task_configs()) == 27

    # the full-size encoder: the same parameter names and shapes as the
    # JAX tree (the port's built on the meta device: no weights)
    with torch.device("meta"):
        enc = build_vit_encoder("dinov3", cfg)
    assert enc.backbone.embed_dim == 1024 and enc.backbone.depth == 24
    assert enc.backbone.patch_size == 16 and enc.backbone.num_prefix == 5
    assert enc.backbone.out_indices == (5, 11, 17, 23)
    assert not enc.backbone.block0.use_flash(14 * 14 + 5)
    attn = [m for m in enc.modules()
            if isinstance(m, DeformableCrossAttention2D)]
    assert len(attn) == 4 and {(m.num_heads, m.num_points, m.offset_range)
                               for m in attn} == {(8, 4, 0.25)}
    jenc = jvit.build_vit_encoder("dinov3", JaxConfig(config_dict=d))
    x = jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)
    tree = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), x)["params"]
    got = {n: tuple(p.shape) for n, p in enc.named_parameters()}
    assert got == _port_shapes(tree)
