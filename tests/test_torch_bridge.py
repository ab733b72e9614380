"""The weight bridge (``fmc_uia_tpu_torch.utils.convert``) on a
flagship-structured JAX tree: the flagship config (27 tasks: seg/cls/det/
reg banks of 12/9/3/3, separate det FPN, TaskFiLM, scan_stages [0, 1, 3])
with swin_micro, so that scanned and unrolled stages both occur."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.config import Config as JaxConfig
from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.flagship import flagship_config_dict
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.utils.convert import (
    jax_leaves_to_port,
    load_jax_params,
)
from torch_port_utils import random_like_tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def trees():
    d = flagship_config_dict()
    d["model"]["encoder"]["name"] = "swin_micro"
    d["data"]["image_size"] = 64
    jcfg = JaxConfig(config_dict=d)
    jmodel = jax_build_model(jcfg, JaxRegistry.from_config(jcfg))
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                            method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=3)
    model = build_model(Config(config_dict=d), dtype=torch.float32,
                        device="cpu")
    return params, model


def test_bank_axes_and_stage_forms(trees):
    params, _ = trees
    enc = params["encoder"]
    assert "stage0_scan" in enc and "stage1_scan" in enc
    assert "stage3_scan" in enc and "stage2_block1" in enc
    heads = {k: v for k, v in params.items() if k.startswith("head_banks_")}
    lead = {k: next(iter(_flat(v).values())).shape[0]
            for k, v in heads.items()}
    assert lead == {"head_banks_segmentation": 12,
                    "head_banks_classification": 9,
                    "head_banks_detection": 3,
                    "head_banks_Regression": 3}
    assert "fpn_det" in params and params["film"]["gammas"].shape[0] == 27


def test_every_leaf_maps_to_one_port_param(trees):
    params, model = trees
    leaves = jax_leaves_to_port(params)
    ports = dict(model.named_parameters())
    assert set(leaves) == set(ports)
    for name, p in ports.items():
        assert tuple(leaves[name].shape) == tuple(p.shape), name
    # each JAX leaf is consumed whole: scanned leaves split into n_pairs
    # blocks, everything else maps one to one
    n_jax = sum(v.shape[0] if "_scan/" in k else 1
                for k, v in _flat(params).items())
    assert n_jax == len(ports)

    load_jax_params(model, params)
    enc = params["encoder"]
    got = model.encoder.stage0_block1.attn.qkv.kernel.detach().numpy()
    np.testing.assert_array_equal(
        got, enc["stage0_scan"]["block1"]["attn"]["qkv"]["kernel"][0].T)
    got = model.encoder.stage2_block1.mlp_fc1.kernel.detach().numpy()
    np.testing.assert_array_equal(got,
                                  enc["stage2_block1"]["mlp_fc1"]["kernel"].T)
    hb = params["head_banks_segmentation"]["pre_0"]["kernel"]  # T,kh,kw,I,O
    got = model.head_banks_segmentation.pre_0.kernel.detach().numpy()
    np.testing.assert_array_equal(got, hb.transpose(0, 4, 3, 1, 2))
    gn = params["fpn_seg"]["GroupNorm_6"]["scale"]
    np.testing.assert_array_equal(
        model.fpn_seg.GroupNorm_6.scale.detach().numpy(), gn)


def test_missing_or_extra_leaf_raises(trees):
    params, model = trees
    missing = {k: v for k, v in params.items() if k != "film"}
    with pytest.raises(ValueError, match="without a JAX leaf"):
        load_jax_params(model, missing)
    extra = dict(params)
    extra["fpn_cls"] = params["fpn_seg"]
    with pytest.raises(ValueError, match="without a port param"):
        load_jax_params(model, extra)
    bad = dict(params)
    bad["film"] = {"gammas": params["film"]["gammas"][:5],
                   "betas": params["film"]["betas"]}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad)
