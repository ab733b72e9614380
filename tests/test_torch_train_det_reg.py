"""A whole train step of the port against the JAX package's, f32, for the
detection and regression task types (see test_torch_train.py, which holds
segmentation and classification, for the setup and the tolerances: the
loss and grad norm within 1e-5 relative, every gradient leaf within 1e-4
of its largest magnitude).
"""

import pytest

from torch_port_utils import check_train_step, train_step_pair

TYPES = ("detection", "Regression")


@pytest.fixture(scope="module")
def pair():
    return train_step_pair(TYPES)


@pytest.mark.parametrize("ttype", TYPES)
def test_train_step_matches_jax(pair, ttype):
    check_train_step(pair[ttype])
