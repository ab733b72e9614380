"""The off-main-path losses of the port against the JAX package: smooth
L1, binary focal, GIoU, the grid detection loss, the L1 and SmoothL1
regression losses on masked columns, and ``build_loss_fn``'s grid, L1 and
SmoothL1 branches.

Tolerances: each loss within 1e-6 relative of the JAX value and its
gradient within 1e-5 of the gradient's largest magnitude (the same f32
arithmetic; sums may run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu import losses as JL
from fmc_uia_tpu_torch import losses as PL


def _loss_and_grad(jfn, pfn, arrays):
    """(JAX loss, grad of the first input), (port loss, its grad)."""
    jloss, jgrad = jax.value_and_grad(jfn)(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    ts[0].requires_grad_(True)
    ploss = pfn(*ts)
    ploss.backward()
    return float(jloss), np.asarray(jgrad), float(ploss.detach()), \
        ts[0].grad.numpy()


def _check(jl, jg, pl, pg):
    assert abs(pl - jl) <= 1e-6 * max(abs(jl), 1e-6), (pl, jl)
    top = max(float(np.abs(jg).max()), 1e-12)
    assert float(np.abs(pg - jg).max()) <= 1e-5 * top


def _boxes(rng, n, invalid=()):
    x1 = rng.uniform(0.0, 0.6, (n, 1))
    y1 = rng.uniform(0.0, 0.6, (n, 1))
    b = np.concatenate([x1, y1, x1 + rng.uniform(0.05, 0.4, (n, 1)),
                        y1 + rng.uniform(0.05, 0.4, (n, 1))], 1)
    b = b.astype(np.float32)
    b[list(invalid)] = -1.0
    return b


@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_smooth_l1_matches_jax(beta):
    x = np.linspace(-3, 3, 61, dtype=np.float32).reshape(1, -1)
    _check(*_loss_and_grad(lambda v: jnp.sum(JL.smooth_l1(v, beta) ** 2),
                           lambda v: (PL.smooth_l1(v, beta) ** 2).sum(),
                           [x]))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_focal_loss_matches_jax(reduction):
    rng = np.random.RandomState(2)
    logits = (3 * rng.standard_normal((4, 7))).astype(np.float32)
    targets = rng.randint(0, 2, (4, 7)).astype(np.float32)
    _check(*_loss_and_grad(
        lambda x, t: JL.focal_loss(x, t, reduction=reduction),
        lambda x, t: PL.focal_loss(x, t, reduction=reduction),
        [logits, targets]))
    none = PL.focal_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                         reduction="none")
    ref = JL.focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                        reduction="none")
    np.testing.assert_allclose(none.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_giou_loss_matches_jax():
    rng = np.random.RandomState(3)
    preds = _boxes(rng, 6)
    preds[2] = preds[2][[2, 3, 0, 1]]  # a box with x2 < x1: zero area
    targets = _boxes(rng, 6)
    targets[4] = preds[4] + 1.0  # disjoint: the enclosing-box term
    _check(*_loss_and_grad(JL.giou_loss, PL.giou_loss, [preds, targets]))


@pytest.mark.parametrize("case", ["mixed", "no_positive", "all_positive"])
def test_detection_grid_loss_matches_jax(case):
    rng = np.random.RandomState(4)
    pred = rng.standard_normal((6, 5)).astype(np.float32)
    pred[:, :4] = 1.0 / (1.0 + np.exp(-pred[:, :4]))
    obj = {"mixed": [1, 0, 1, 1, 0, 1], "no_positive": [0] * 6,
           "all_positive": [1] * 6}[case]
    tgt = np.concatenate([_boxes(rng, 6), np.float32(obj)[:, None]], 1)
    tgt = tgt.astype(np.float32)
    r = _loss_and_grad(
        lambda p, t: JL.detection_grid_loss(p, t, 2.5, 0.75),
        lambda p, t: PL.detection_grid_loss(p, t, 2.5, 0.75),
        [pred, tgt])
    _check(*r)
    if case == "no_positive":  # the box term is 0: no grad on the boxes
        assert np.abs(r[3][:, :4]).max() == 0.0


@pytest.mark.parametrize("name", ["l1_loss", "smooth_l1_loss", "mse_loss"])
@pytest.mark.parametrize("ncols", [None, 2, 6, 0])
def test_regression_losses_on_masked_columns(name, ncols):
    rng = np.random.RandomState(5)
    pred = (2 * rng.standard_normal((3, 6))).astype(np.float32)
    target = rng.rand(3, 6).astype(np.float32)
    nv = None if ncols is None else np.int32(ncols)
    jfn, pfn = getattr(JL, name), getattr(PL, name)
    _check(*_loss_and_grad(
        lambda p, t: jfn(p, t, num_valid_cols=nv),
        lambda p, t: pfn(p, t, num_valid_cols=(
            None if nv is None else torch.tensor(int(nv)))),
        [pred, target]))


@pytest.mark.parametrize("loss_type", ["L1Loss", "SmoothL1Loss", "MSELoss"])
def test_build_loss_fn_regression_branches(loss_type):
    rng = np.random.RandomState(6)
    pred = rng.rand(4, 8).astype(np.float32)
    target = rng.rand(4, 8).astype(np.float32)
    cfg = {"type": loss_type}
    jfn = JL.build_loss_fn("Regression", cfg)
    pfn = PL.build_loss_fn("Regression", cfg)
    assert pfn.__name__ == jfn.__name__
    _check(*_loss_and_grad(
        lambda p, t: jfn(p, t, num_valid_cols=np.int32(6)),
        lambda p, t: pfn(p, t, num_valid_cols=torch.tensor(6)),
        [pred, target]))


@pytest.mark.parametrize("cfg", [
    {"type": "Detection"},
    {"type": "Detection", "classification_weight": 0.5,
     "box_regression_weight": 3.0},
])
def test_build_loss_fn_grid_branch(cfg):
    rng = np.random.RandomState(7)
    pred = rng.standard_normal((5, 5)).astype(np.float32)
    tgt = np.concatenate([_boxes(rng, 5),
                          np.float32([1, 0, 1, 0, 1])[:, None]], 1)
    tgt = tgt.astype(np.float32)
    _check(*_loss_and_grad(JL.build_loss_fn("detection", cfg),
                           PL.build_loss_fn("detection", cfg), [pred, tgt]))
    # the CenterNet branch stays the CenterNet loss
    assert PL.build_loss_fn("detection", {"type": "CenterNet"}) is not None
