"""The frozen reference against the program's plain CPU path at a small
width, and whole CPU runs of the cells with a fault planted under the
timed path: ``correct`` has to come out false."""

import copy

import numpy as np
import pytest
import torch

from perfbench import cells, compare
from perfbench.serve_cell import ServeCell
from perfbench.tests.tiny import tiny
from perfbench.train_cell import TrainCell

SEED = 2 ** 31 + 12345


def _f32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["config"]["device"]["mixed_precision"] = False
    return cfg


def _run(cell_name, fault=None, seconds=1.0, f32=False):
    bench, cell, cfg, traffic, limits = tiny(cell_name)
    return cells.run_cell(bench, cell, _f32(cfg) if f32 else cfg, traffic,
                          limits, seed=SEED, seconds=seconds, trace=False,
                          t_start=0.0, log=lambda m: None, device="cpu",
                          fault=fault)


def test_reference_follows_the_train_step_in_f32():
    """In f32 the reference's steps are the program's plain CPU steps up
    to rounding: the same augmentation, dropout and drop path draws, the
    same losses, clip and AdamW."""
    bench, cell, cfg, traffic, _ = tiny("swin_b512.train")
    tc = TrainCell(cell, _f32(cfg), traffic, SEED, device="cpu")
    tc.setup()
    tc.free()
    n = compare.train_numbers(tc.program, tc.reference())
    assert n["loss_gap_max"] < 1e-5
    assert n["grad_gap"] < 1e-4
    assert n["update_gap"] < 1e-3
    assert n["counted"] > 100


def test_reference_forward_matches_the_predictor_in_f32():
    """The reference's eval forward against the served answers of the
    program's StreamingPredictor in f32: every number at rounding."""
    bench, cell, cfg, traffic, _ = tiny("swin_b512.serve")
    sc = ServeCell(cell, _f32(cfg), traffic, SEED, device="cpu")
    sc.setup()
    w = sc.window(1.0)
    sc.free()
    picks = sc.sample(w["answers"])
    assert len(picks) >= 4
    got = sc.reference(picks, w["answers"])
    assert set(got) == {"class_gap", "coord_err"}
    assert all(v < 1e-4 for v in got.values()), got


def test_train_run_on_the_cpu_completes():
    r = _run("swin_b512.train")
    assert set(r) == {"correct", "attempted", "failed", "metrics",
                      "device", "breakdown", "checks"}
    assert r["device"]["platform"] == "cpu"
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"grad_gap", "update_gap",
                                "nonfinite_losses"}


def test_f32_train_run_is_correct():
    assert _run("swin_b512.train", f32=True)["correct"]


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_train_fault_is_not_correct(fault):
    r = _run("swin_b512.train", fault=fault)
    assert r["correct"] is False


@pytest.mark.parametrize("fault", ["K1b_dw", "K2b_dw"])
def test_kernel_fault_is_not_correct(fault):
    """One kernel's weight grad scaled by 1.1 fails the gradient's worst
    leaf, where the same run without the fault is correct (f32)."""
    r = _run("swin_b512.train", fault=fault, f32=True)
    assert r["correct"] is False
    assert r["checks"]["grad_gap"]["value"] > r["checks"]["grad_gap"][
        "limit"]
    assert _run("swin_b512.train", f32=True)["correct"]


def test_kernel_fault_is_undone():
    """A kernel fault patches a class for the whole process: freeing the
    cell undoes it."""
    from fmc_uia_tpu_torch.ops import swin_block as sb

    before = sb._MlpBranchFn.__dict__["backward"]
    undo = compare.plant("K2b_dw", None)
    assert sb._MlpBranchFn.__dict__["backward"] is not before
    undo()
    assert sb._MlpBranchFn.__dict__["backward"] is before


def test_f32_serve_run_is_correct():
    r = _run("swin_b512.serve", f32=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0


def test_serve_fault_is_not_correct():
    r = _run("swin_b512.serve", fault="altered_answer")
    assert r["correct"] is False


def test_serving_numbers_on_planted_answers():
    """The serving numbers on hand-made outputs: a served class below the
    best by d reads d; a class out of range, a peak off the best and a
    point off by e read what they say."""
    seg = torch.zeros(1, 2, 2, 2)
    seg[0, 0, 0] = torch.tensor([1.0, 0.25])  # class 0 best by 0.75
    got = compare.serve_gaps(seg, [torch.ones(2, 2, dtype=torch.int32)],
                             "segmentation", 2)
    assert got == {"class_gap": pytest.approx(0.75)}
    got = compare.serve_gaps(seg, [torch.full((2, 2), 2)], "segmentation",
                             2)
    assert got["class_gap"] == float("inf")
    reg = torch.zeros(1, 8)
    got = compare.serve_gaps(reg, [torch.full((8,), 0.1)], "Regression", 4)
    assert got == {"coord_err": pytest.approx(0.1)}
    hm = torch.full((1, 4, 4, 1), -5.0)
    hm[0, 1, 2, 0] = 3.0
    hm[0, 3, 0, 0] = 2.5
    det = {"heatmap": hm, "size": torch.ones(1, 4, 4, 2),
           "offset": torch.zeros(1, 4, 4, 2)}
    box = compare.decode(det, "detection", 1)[0]
    got = compare.serve_gaps(det, [box], "detection", 1)
    assert got == {"class_gap": 0.0, "coord_err": 0.0}
    # the box of the second peak, 0.5 below the first, read a little off
    other = torch.tensor([-0.5, 2.5, 0.5, 3.5]).clamp(0, 4) / 4 + 0.01
    got = compare.serve_gaps(det, [other], "detection", 1)
    assert got["class_gap"] == pytest.approx(0.5)
    assert got["coord_err"] == pytest.approx(0.01, abs=1e-6)


def test_control_rounds_to_float8():
    from perfbench.reference.step import round_fp8

    t = torch.linspace(-3.0, 3.0, 101, requires_grad=True)
    q = round_fp8(t)
    assert len(torch.unique(q.detach())) < 101
    assert float((q - t).abs().max()) <= 3.0 / 16
    q.sum().backward()
    assert torch.equal(t.grad, torch.ones(101))  # straight through
    assert np.isfinite(q.detach().numpy()).all()
