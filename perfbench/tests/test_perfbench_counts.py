"""The operation and byte counts against hand counts at small shapes."""

import pytest

from perfbench import counts
from perfbench.reference.config import Config
from perfbench.reference.tasks import TaskRegistry
from perfbench.tests.tiny import tiny


def test_k1f_hand_count():
    # B=1, a 8x8 grid, C=32, 2 heads, window 8 (one window, N=64), no mask
    ops, nbytes = counts.k1f(1, 8, 8, 32, 2, 8, False)
    T, N, C = 64, 64, 32
    # qkv 2*T*C*3C, proj 2*T*C*C, scores and .v 2 * 2*T*N*C
    assert ops == 2 * T * C * 3 * C + 2 * T * C * C + 4 * T * N * C
    # x in and y out (bf16), 4 C^2 + 6 C f32 weights, the [H, N, N] table
    assert nbytes == 2 * T * C * 2 + 4 * (4 * C * C + 6 * C) + 4 * 2 * N * N
    _, masked = counts.k1f(1, 8, 8, 32, 2, 8, True)
    assert masked - nbytes == 4 * 1 * N * N


def test_k2_hand_count():
    ops, nbytes = counts.k2f(2, 4, 4, 64)
    T, C = 32, 64
    assert ops == 2 * T * C * 4 * C * 2  # fc1 and fc2 of ratio 4
    assert nbytes == 2 * T * C * 2 + 4 * (8 * C * C + 7 * C)
    ops_b, _ = counts.k2b(2, 4, 4, 64)
    assert ops_b == 40 * T * C * C


def test_k4_hand_count():
    ops, nbytes, exps = counts.k4f(1, 2, 16, 8)
    assert ops == 2 * (2 * 1 * 2 * 16 * 16 * 8)  # q k^T and p v
    assert exps == 2 * 16 * 16
    assert nbytes == 4 * (2 * 16 * 8) * 2 + 4 * 2 * 16
    ops_b, _, _ = counts.k4b(1, 2, 16, 8)
    assert ops_b == 5 * (2 * 2 * 16 * 16 * 8)


def test_bound_takes_the_larger():
    p = counts.PEAKS
    assert counts.bound_s(p["bf16_flops"], 0.0) == pytest.approx(1.0)
    assert counts.bound_s(0.0, p["hbm_bytes_per_s"]) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 1.0, p["sfu_exp_per_s"]) == pytest.approx(1.0)


def test_launches_explained_by_stages():
    bench, cell, cfg, _, _ = tiny("swin_b512.train")
    c = Config(config_dict=cfg["config"])
    st = counts.swin_stages(c)
    assert [s["depth"] for s in st] == [2, 2, 2, 2]
    # every block: K1; the first two stages: a gate at C <= 64
    all_k1 = counts.explained_bound_s("K1f", c, {2: 3}, 3 * 8)
    assert all_k1 == pytest.approx(3 * sum(
        b for _, b in counts.kernel_launch_bounds("K1f", c, 2)))
    two = counts.explained_bound_s("K2f", c, {2: 3}, 3 * 4)
    assert two == pytest.approx(3 * sum(
        b for s, b in counts.kernel_launch_bounds("K2f", c, 2) if s < 2))
    assert counts.explained_bound_s("K2f", c, {2: 3}, 7) is None
    assert counts.explained_bound_s("K4f", c, {2: 3}, 12) is None


def test_model_flops_forward_and_backward():
    bench, cell, cfg, _, _ = tiny("swin_b512.train")
    c = Config(config_dict=cfg["config"])
    reg = TaskRegistry.from_config(c)
    fwd = counts.model_flops(c, reg, "classification", train=False)
    both = counts.model_flops(c, reg, "classification", train=True)
    assert fwd > 0
    # the backward: the input grads and the weight grads of each product,
    # about twice the forward's
    assert 2.5 * fwd < both < 3.5 * fwd
    seg = counts.model_flops(c, reg, "segmentation", train=False)
    assert seg > fwd  # the FPN and the seg head on top
