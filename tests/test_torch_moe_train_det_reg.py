"""One MoE train step per task type, the port against the JAX package, f32
(detection and regression here; segmentation and classification, and the
tolerances, in test_torch_moe_train.py), and one step of the baseline
preset's separate reg FPN.
"""

import pytest

from torch_port_utils import (
    MOE_OVERRIDES,
    SEPARATE_FPN_OVERRIDES,
    check_moe_logs,
    check_moe_train_step,
    check_optimizer_update,
    constant_unread_blocks,
    train_step_pair,
)

TYPES = ("detection", "Regression")


@pytest.fixture(scope="module")
def pair():
    return train_step_pair(TYPES, overrides=MOE_OVERRIDES)


@pytest.mark.parametrize("ttype", TYPES)
def test_moe_train_step_matches_jax(pair, ttype):
    r = pair[ttype]
    assert any(n.startswith("moe_stage") for n in r["grads"])
    check_moe_train_step(r, constant_unread_blocks(r, ttype))
    check_moe_logs(r)


@pytest.mark.parametrize("ttype", TYPES)
def test_moe_optimizer_update_matches_optax(pair, ttype):
    check_optimizer_update(pair[ttype])


def test_separate_reg_fpn_train_step_matches_jax():
    r = train_step_pair(("Regression",), seed=6,
                        overrides=SEPARATE_FPN_OVERRIDES)["Regression"]
    assert r["model"].decoder_alias["Regression"] == "fpn_reg"
    check_moe_train_step(r, constant_unread_blocks(r, "Regression"))
    check_moe_logs(r)
