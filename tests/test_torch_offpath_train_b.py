"""One train step per task type with the options of
``flagship.ablation_b_config_dict`` at a tiny width (``ABLATION_B_OVERRIDES``:
swin_nano 64²; the baseline cls, grid det and reg heads, the UNet-like
seg head, embedding FiLM, a multiplicative task prompt on every type, the
grid and L1 losses), the port against the JAX package's own step on the
same bridged weights (``torch_port_utils.train_step_pair``), then one
Adam update from those grads against optax (``check_optimizer_update``:
``build_optimizer`` of this config is Adam, no weight decay).

Tolerances: ``check_train_step``'s (the losses and grad norm within 1e-5
relative, every grad leaf within 1e-4 of its largest magnitude) and
``check_optimizer_update``'s (params within 1e-6 of the leaf's largest
magnitude). One JAX step compile per type.
"""

import pytest

from torch_port_utils import (
    ABLATION_B_OVERRIDES,
    check_optimizer_update,
    check_train_step,
    train_step_pair,
)

TYPES = ("segmentation", "classification", "detection", "Regression")


@pytest.fixture(scope="module")
def pair():
    return train_step_pair(TYPES, overrides=ABLATION_B_OVERRIDES)


@pytest.mark.parametrize("ttype", TYPES)
def test_train_step_matches_jax(pair, ttype):
    r = pair[ttype]
    heads = {"segmentation": "UNetLikeSegHeadBank",
             "classification": "BaselineClsHeadBank",
             "detection": "BaselineGridDetectionHeadBank",
             "Regression": "BaselineRegHeadBank"}
    bank = getattr(r["model"], f"head_banks_{ttype}")
    assert type(bank).__name__ == heads[ttype]
    assert r["model"].task_prompt.inject_mode == "mul"
    check_train_step(r)


@pytest.mark.parametrize("ttype", ["segmentation", "detection"])
def test_adam_update_matches_optax(pair, ttype):
    from fmc_uia_tpu_torch.train import build_optimizer

    r = pair[ttype]
    assert build_optimizer(r["cfg"], r["model"]).kind == "Adam"
    check_optimizer_update(r)
