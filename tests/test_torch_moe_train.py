"""One MoE train step per task type, the port against the JAX package, f32
(segmentation and classification here; detection and regression in
test_torch_moe_train_det_reg.py: one JAX compile of a step takes ~20 s on
the CPU), and one step of the baseline preset's separate cls FPN.

The model is tests/test_torch_train.py's swin_micro 64² with the dense MoE
on encoder stages 2 and 3 (4 experts, top-2, a task embedding, balance
weight 0.05; torch_port_utils.MOE_OVERRIDES); augmentation, dropout and
drop path off. Tolerances (torch_port_utils): the losses and the grad
norm within 1e-5 relative; every gradient leaf within 1e-4 of its largest
magnitude, the MoE routers' within 1e-3 (their grads cancel;
``check_moe_train_step`` says why), and the router of a block whose exact
grad is zero within 1e-8 of zero; ``moe_aux`` within 1e-5 relative,
``moe_importance`` within 1e-6, ``moe_load`` equal (``check_moe_logs``);
one grouped-AdamW update from the same grads, every leaf within 1e-6 of
its largest magnitude (``check_optimizer_update``). The separate-FPN
weights come from seed 6, where the step is well conditioned: at the
default seed 5 a 1e-7 relative perturbation of the weights moves the
port's own stage-3 router grads by 65 % (an input at a ReLU's kink).
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

TYPES = ("segmentation", "classification")


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


def test_separate_cls_fpn_train_step_matches_jax():
    r = train_step_pair(("classification",), seed=6,
                        overrides=SEPARATE_FPN_OVERRIDES)["classification"]
    assert r["model"].decoder_alias["classification"] == "fpn_cls"
    check_moe_train_step(r, constant_unread_blocks(r, "classification"))
    check_moe_logs(r)
