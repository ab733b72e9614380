"""A whole train step of the port against the JAX package's on the CPU
(``torch_port_utils.train_step_pair``, f32, augmentation, dropout and drop
path off) with the unfused Swin attention: swin_micro 64², window 8,
every stage unfused (``fused_block: false``; ``softmax_bf16`` and
``ln_bf16`` on) for each task type, and ``fused_stages`` [0, 1] (stages
2-3 unfused; the JAX fused stages in interpret mode) for segmentation.
Tolerances: ``check_train_step``'s (the losses and the grad norm within
1e-5 relative, every leaf within 1e-4 of its largest magnitude).
"""

import pytest

from torch_port_utils import (
    check_train_step,
    encoder_overrides,
    train_step_pair,
)

TYPES = ("segmentation", "classification", "detection", "Regression")


@pytest.fixture(scope="module")
def step_pair():
    return train_step_pair(TYPES, overrides=encoder_overrides(
        name="swin_micro", window_size=8, fused_block=False, fused_mlp=True,
        scan_stages=[0, 1, 3], ln_bf16=True, softmax_bf16=True))


@pytest.mark.parametrize("ttype", TYPES)
def test_unfused_train_step_matches_jax(step_pair, ttype):
    check_train_step(step_pair[ttype])


def test_fused_stages_01_train_step_matches_jax():
    r = train_step_pair(("segmentation",), overrides=encoder_overrides(
        name="swin_micro", window_size=8, fused_block=True,
        fused_mlp=True, fused_stages=[0, 1], scan_stages=[0, 1, 3],
        ln_bf16=True))
    check_train_step(r["segmentation"])
