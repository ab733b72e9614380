"""A whole train step of the DINOv3 preset with ``freeze_dino`` (narrow:
64 wide, 2 heads, depth 2, patch 8 at 32², global attention 'on'), port
against the JAX package, f32, for the four task types, with the same
seeded numpy weights bridged into both (torch_port_utils.train_step_pair;
augmentation, dropout and drop path off).

* The loss and the grad norm within 1e-5 relative, and every gradient
  leaf within 1e-4 of its largest magnitude -- the frozen backbone and
  ``rope_periods`` included: JAX clips ``grads["model"]`` before the
  frozen labels zero their updates, so their grads count in the norm.
* The update: the port's ``GroupedOptimizer`` on the port's grads against
  the JAX package's optax chain (``build_optimizer``) on the JAX grads,
  from the same weights: every trained element's step within 1e-3 of one
  step's size (lr x its group multiplier; a first Adam step is about
  +-lr x mult per element, so this holds the sign and size of each
  element's step), beyond what the two sides' grad difference moves a
  step at that grad (where |g| is near Adam's eps); every frozen leaf
  (the backbone, ``rope_periods``) unchanged on both sides, bit for bit.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from fmc_uia_tpu.models.encoders import vit as jvit
from fmc_uia_tpu.train import build_optimizer as jax_build_optimizer
from fmc_uia_tpu_torch.models.encoders import vit as pvit
from fmc_uia_tpu_torch.train import build_optimizer, label_params
from fmc_uia_tpu_torch.utils.convert import (
    jax_leaves_to_port,
    load_jax_params,
)
from torch_port_utils import check_train_step, train_step_pair

NARROW = dict(embed_dim=64, depth=2, num_heads=2)
SIZE = 32
LR = 1e-3  # the tiny config's learning rate: the step's lr at scale 1
EPS = 1e-8  # Adam's eps, both sides
OVERRIDES = {
    "data": {"image_size": SIZE,
             "augmentation": {"train": {"random_brightness_contrast": 0.0,
                                        "gauss_noise": 0.0}}},
    "model": {
        "encoder": {"name": "dinov3", "timm_name": "vit_base_patch8_dinov3",
                    "pretrained": None, "freeze_dino": True,
                    "out_indices": [0, 1], "flash_attention": "on",
                    "adapter": {"type": "resize", "channels": 32}},
        "decoder": {"dropout": 0.0},
        "heads": {"classification": {"dropout": 0.0},
                  "regression": {"hidden_dims": [16, 8], "dropout": 0.0}}},
}
TYPES = ("segmentation", "classification", "detection", "Regression")


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        mp.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
        return train_step_pair(TYPES, overrides=OVERRIDES, size=SIZE)


@pytest.mark.parametrize("ttype", TYPES)
def test_train_step_matches_jax(pair, ttype):
    r = pair[ttype]
    assert "encoder.backbone.rope_periods" in r["grads"]
    assert np.abs(r["grads"]["encoder.backbone.block0.qkv.kernel"]).max() > 0
    check_train_step(r)


@pytest.mark.parametrize("ttype", TYPES)
def test_freeze_dino_update_matches_jax(pair, ttype):
    r = pair[ttype]
    params, model, cfg = r["params"], r["model"], r["cfg"]
    # the JAX step's update, from its (clipped) grads
    tx = jax_build_optimizer(r["jcfg"], {"model": params})
    upd, _ = tx.update({"model": r["jgrads_tree"]},
                       tx.init({"model": params}), {"model": params})
    jnew = jax_leaves_to_port(optax.apply_updates(
        params, jax.tree_util.tree_map(lambda u: -LR * u, upd["model"])))
    old = jax_leaves_to_port(params)
    # the port's optimizer on the port's grads
    load_jax_params(model, params)
    opt = build_optimizer(cfg, model)
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(r["grads"][n].copy())
    opt.step(LR)
    new = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    load_jax_params(model, params)  # the fixture's model, as it was

    labels = label_params(model, freeze_backbone=True)
    frozen = sorted(n for n, lab in labels.items() if lab == "frozen")
    assert "encoder.backbone.rope_periods" in frozen
    assert all(n.startswith("encoder.backbone.") for n in frozen)
    assert labels["encoder.adapter.proj0.kernel"] == "encoder"
    bad = []
    for n in new:
        if n in frozen:
            assert np.array_equal(new[n], old[n]), n
            assert np.array_equal(jnew[n], old[n]), n
            continue
        mult = 0.1 if labels[n] == "encoder" else 1.0
        err = np.abs((new[n] - old[n]) - (jnew[n] - old[n]))
        # a first Adam step is g / (|g| + eps) per element, whose slope,
        # eps / (|g| + eps)^2, falls with |g|: a grad near zero carries the
        # two sides' grad difference into its step, at most at the slope
        # of the smaller |g| (of 0 where the two signs differ)
        gp, gj = r["grads"][n], r["jgrads"][n]
        gmin = np.where(np.sign(gp) == np.sign(gj),
                        np.minimum(np.abs(gp), np.abs(gj)), 0.0)
        slack = np.abs(gp - gj) * EPS / (gmin + EPS) ** 2
        excess = float((err / (LR * mult) - slack).max())
        if not excess <= 1e-3:
            bad.append((n, excess))
    assert not bad, bad[:5]
