"""The port's metrics, evaluation and fit loop against the JAX package's,
and its checkpoint/resume.

Tolerances: each metric within 1e-6 of the JAX metric on the same seeded
inputs (f32 sums in another order); ``evaluate`` within 1e-4 per task and
metric on bridged weights over the same batches (two f32 forwards of a
tiny Swin; a seg pixel or class whose top two logits sit within the
forwards' difference could flip, which this seed does not meet); a
resumed run bitwise equal to the unbroken one (same arithmetic on the same
data in the same order).
"""

import copy
import json
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from fmc_uia_tpu import metrics as JM
from fmc_uia_tpu.config import Config as JaxConfig
from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch import checkpoint as ckpt_lib
from fmc_uia_tpu_torch import metrics as PM
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.pipeline import build_data_engines
from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset
from fmc_uia_tpu_torch.fit import _PreemptionGuard, fit
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from helpers import TINY_CONFIG
from torch_port_utils import TRAIN_OVERRIDES, random_like_tree


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("masked", [False, True])
def test_dice_matches_jax(masked):
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 3, (4, 9, 9)).astype(np.int32)
    logits = rng.standard_normal((4, 9, 9, 4)).astype(np.float32)
    ncls = 3 if masked else None
    valid = np.array([1, 1, 0, 1], bool) if masked else None
    ref = JM.dice_coefficient(jnp.asarray(labels), jnp.asarray(logits),
                              None if ncls is None else jnp.int32(ncls),
                              None if valid is None else jnp.asarray(valid))
    got = PM.dice_coefficient(_t(labels), _t(logits), ncls,
                              None if valid is None else _t(valid))
    assert abs(float(got) - float(ref)) <= 1e-6


@pytest.mark.parametrize("cols,masked", [(None, False), (6, False),
                                         (4, True), (None, True)])
def test_mae_matches_jax(cols, masked):
    rng = np.random.RandomState(1)
    labels = rng.rand(5, 8).astype(np.float32)
    preds = rng.rand(5, 8).astype(np.float32)
    valid = np.array([1, 0, 1, 1, 0], bool) if masked else None
    ref = JM.mae_pixels(jnp.asarray(labels), jnp.asarray(preds),
                        num_valid_cols=cols,
                        sample_mask=None if valid is None else
                        jnp.asarray(valid))
    got = PM.mae_pixels(_t(labels), _t(preds), num_valid_cols=cols,
                        sample_mask=None if valid is None else _t(valid))
    assert abs(float(got) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref)))


def test_iou_and_host_metrics_match_jax():
    rng = np.random.RandomState(2)
    a = np.sort(rng.rand(16, 2, 2), axis=1).transpose(0, 2, 1).reshape(16, 4)
    b = np.sort(rng.rand(16, 2, 2), axis=1).transpose(0, 2, 1).reshape(16, 4)
    a, b = a.astype(np.float32), b.astype(np.float32)
    ref = np.asarray(JM.batch_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(PM.batch_iou(_t(a), _t(b)).numpy(), ref,
                               rtol=0, atol=1e-6)
    for seed in range(4):
        r = np.random.RandomState(seed)
        y, p = r.randint(0, 4, 30), r.randint(0, 3 + seed % 2, 30)
        assert PM.accuracy_score_host(y, p) == JM.accuracy_score_host(y, p)
        assert abs(PM.macro_f1_host(y, p) - JM.macro_f1_host(y, p)) <= 1e-12


def test_average_score_matches_jax():
    rows = [{"Task ID": "a", "Task Name": "classification", "Accuracy": 0.5,
             "F1-Score": 0.25},
            {"Task ID": "b", "Task Name": "segmentation", "Dice": 0.7},
            {"Task ID": "c", "Task Name": "detection", "IoU": 0.3},
            {"Task ID": "d", "Task Name": "Regression", "MAE (pixels)": 20.0},
            {"Task ID": "e", "Task Name": "Regression",
             "MAE (pixels)": 130.0}]
    ref = JM.average_validation_score(pd.DataFrame(rows))
    assert abs(PM.average_validation_score(rows) - ref) <= 1e-12
    assert PM.average_validation_score([]) == JM.average_validation_score(
        pd.DataFrame())


# ---------------------------------------------------------------------------
# evaluate on bridged weights
# ---------------------------------------------------------------------------
def _tiny_dict(root, out, **data):
    d = copy.deepcopy(TINY_CONFIG)
    for k, v in TRAIN_OVERRIDES["model"].items():
        d["model"].setdefault(k, {}).update(v)
    d["model"]["encoder"] = dict(TRAIN_OVERRIDES["model"]["encoder"])
    d["data"].update(root_path=root, batch_size=4, image_size=64,
                     num_workers=2, **data)
    d["experiment"].update(output_dir=out, save_checkpoints=True,
                           checkpoint_freq=1)
    return d


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fitdata"))
    generate_synthetic_dataset(root, samples_per_task=8, seed=0)
    return root


def test_evaluate_matches_jax(data_root, tmp_path):
    cfg = Config(config_dict=_tiny_dict(data_root, str(tmp_path)))
    _, val_engine, reg = build_data_engines(cfg)
    jcfg = JaxConfig(config_dict=copy.deepcopy(cfg.config))
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=5)
    model = build_model(cfg, reg, device="cpu")
    load_jax_params(model, params)
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    got = PM.evaluate(model, val_engine, reg, mean, std, device="cpu")
    ref = JM.evaluate(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                      val_engine, jreg, mean, std)
    assert len(got) == len(ref) == len(reg)
    for row, (_, rrow) in zip(got, ref.iterrows()):
        assert row["Task ID"] == rrow["Task ID"]
        assert row["Task Name"] == rrow["Task Name"]
        for k, v in row.items():
            if k not in ("Task ID", "Task Name"):
                assert abs(v - rrow[k]) <= 1e-4, (row["Task ID"], k, v,
                                                  rrow[k])
    assert abs(PM.average_validation_score(got)
               - JM.average_validation_score(ref)) <= 1e-4


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------
def test_fit_end_to_end_through_the_cli(data_root, tmp_path, monkeypatch):
    """Two epochs x 4 steps, K3's plain version in the train prep, through
    ``python -m fmc_uia_tpu_torch`` with a config file."""
    from fmc_uia_tpu_torch.__main__ import main

    d = _tiny_dict(data_root, str(tmp_path / "out"), fused_preprocess=True)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(d))
    monkeypatch.setattr(sys, "argv", ["fmc_uia_tpu_torch", "--config",
                                      str(path), "--device", "cpu"])
    main()
    (exp,) = [p for p in (tmp_path / "out").iterdir() if p.is_dir()]
    for f in ["training_history.json", "train_losses.csv",
              "training_summary.csv", "val_metrics.csv", "config.yaml",
              "final_summary.json", "final_summary.txt",
              "best_model_summary.txt", "best_model.pt",
              "checkpoint_epoch_2.pt"]:
        assert (exp / f).exists(), f
    hist = json.loads((exp / "training_history.json").read_text())
    assert [e["epoch"] for e in hist] == [1, 2]
    assert all(np.isfinite(v["mean"]) for e in hist
               for v in e["train_losses"].values())
    snap = yaml.safe_load((exp / "config.yaml").read_text())
    assert snap["runtime"]["tasks_from_dataset"]
    assert len(snap["tasks"]) == 6
    loss = pd.read_csv(exp / "train_losses.csv")
    assert list(loss.columns) == ["epoch", "task_id", "mean", "std", "min",
                                  "max", "count"]
    val = pd.read_csv(exp / "val_metrics.csv")
    assert list(val.columns) == ["epoch", "task_id", "task_name", "metric",
                                 "value"]
    assert "Group mean primary metrics" in (
        exp / "best_model_summary.txt").read_text()
    found = ckpt_lib.latest_checkpoint(tmp_path / "out")
    assert found is not None and found[1]["epoch"] == 2


def test_fit_result(data_root, tmp_path):
    d = _tiny_dict(data_root, str(tmp_path / "out"), fused_preprocess=True)
    d["training"]["profile"] = {"enabled": True, "start_step": 1,
                                "stop_step": 3}
    result = fit(config=Config(config_dict=d), device="cpu")
    trace = os.path.join(result["experiment_dir"], "profile",
                         "trace_1_3.json")
    assert json.load(open(trace))["traceEvents"]
    assert result["best_epoch"] >= 1 and 0.0 <= result["best_score"] <= 1.0
    assert "segmentation" in result["best_eval_on_train"]
    assert [e["steps"] for e in result["epoch_stats"]] == [4, 4]
    # 6 train rows per task: the sampler's wraparound fills each batch of 4
    assert all(e["images"] == 4 * e["batches"] == 16
               for e in result["epoch_stats"])
    assert result["eval_batches"] > 0


def test_preemption_guard_sigterm_sets_flag():
    g = _PreemptionGuard(True)
    try:
        assert not g.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested
    finally:
        g.close()


def test_preemption_checkpoints_and_resumes(data_root, tmp_path,
                                            monkeypatch):
    """SIGTERM mid-epoch writes a checkpoint of the interrupted epoch and
    returns; --resume picks it up in the same experiment dir."""
    import fmc_uia_tpu_torch.fit as fit_mod

    d = _tiny_dict(data_root, str(tmp_path / "out"), fused_preprocess=True)
    d["experiment"]["checkpoint_freq"] = 50  # only preemption saves

    class FakeGuard:
        def __init__(self, enabled=True):
            self.checks = 0

        @property
        def requested(self):
            self.checks += 1
            return self.checks > 3

        def close(self):
            pass

    monkeypatch.setattr(fit_mod, "_PreemptionGuard", FakeGuard)
    result = fit(config=Config(config_dict=copy.deepcopy(d)), device="cpu")
    assert result["preempted"] is True
    found = ckpt_lib.latest_checkpoint(d["experiment"]["output_dir"])
    assert found is not None and found[1]["epoch"] == 0
    monkeypatch.undo()
    before = sorted(p for p in (tmp_path / "out").iterdir() if p.is_dir())
    result2 = fit(config=Config(config_dict=copy.deepcopy(d)), resume=True,
                  device="cpu")
    assert "preempted" not in result2 and result2["best_epoch"] >= 1
    after = sorted(p for p in (tmp_path / "out").iterdir() if p.is_dir())
    assert after == before
    hist = json.load(open(after[0] / "training_history.json"))
    assert [e["epoch"] for e in hist] == [1, 2]
    assert (after[0] / "best_model.pt").exists()


@pytest.mark.parametrize("adaptive", [False, True])
def test_resume_is_bitwise_the_unbroken_run(data_root, tmp_path, adaptive):
    """Two epochs unbroken == one epoch, then --resume to two: every
    parameter, optimizer moment, adaptive log-var and the generator state
    equal."""
    unbroken = _tiny_dict(data_root, str(tmp_path / "a"),
                          fused_preprocess=True)
    unbroken["training"]["adaptive_loss"].update(enabled=adaptive,
                                                 warmup_epochs=1)
    ra = fit(config=Config(config_dict=copy.deepcopy(unbroken)),
             device="cpu")
    first = copy.deepcopy(unbroken)
    first["experiment"]["output_dir"] = str(tmp_path / "b")
    first["training"]["num_epochs"] = 1
    fit(config=Config(config_dict=copy.deepcopy(first)), device="cpu")
    first["training"]["num_epochs"] = 2
    rb = fit(config=Config(config_dict=first), resume=True, device="cpu")
    a = torch.load(os.path.join(ra["experiment_dir"],
                                "checkpoint_epoch_2.pt"), weights_only=True)
    b = torch.load(os.path.join(rb["experiment_dir"],
                                "checkpoint_epoch_2.pt"), weights_only=True)
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for key in ("mu", "nu"):
        for ga, gb in zip(a["optimizer"][key], b["optimizer"][key]):
            assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 8
    assert torch.equal(a["generator"], b["generator"])
    assert (a["adaptive"] is None) == (not adaptive)
    for k in (a["adaptive"] or {}):
        assert torch.equal(a["adaptive"][k], b["adaptive"][k]), k
    assert a["scheduler"] == b["scheduler"]
    ha = json.load(open(os.path.join(ra["experiment_dir"],
                                     "training_history.json")))
    hb = json.load(open(os.path.join(rb["experiment_dir"],
                                     "training_history.json")))
    assert [e["train_losses"] for e in ha] == [e["train_losses"] for e in hb]


def test_fit_refusals(data_root, tmp_path):
    d = _tiny_dict(data_root, str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit(config=Config(config_dict=d), device="cpu", mesh=object())
    # a missing pretrained checkpoint raises FileNotFoundError, as in the
    # JAX package (the loading itself: tests/test_torch_pretrained.py)
    d["model"]["encoder"]["pretrained"] = "/nonexistent/encoder.pth"
    with pytest.raises(FileNotFoundError, match="encoder.pth"):
        fit(config=Config(config_dict=d), device="cpu")


def test_adaptive_snapshot_and_schedule_state_match_jax():
    """The logged adaptive weights and sigmas equal the JAX package's; a
    plateau schedule's state survives a round trip."""
    from fmc_uia_tpu import losses as JL
    from fmc_uia_tpu_torch.tasks import TaskRegistry
    from fmc_uia_tpu_torch.train import LRScheduler, Trainer
    from helpers import make_tiny_config

    cfg = Config(config_dict=make_tiny_config(
        model={"encoder": {"name": "swin_nano", "window_size": 8}},
        training={"adaptive_loss": {"enabled": True},
                  "scheduler": {"type": "ReduceLROnPlateau",
                                "patience": 1}}).config)
    model = build_model(cfg, TaskRegistry.from_config(cfg), device="cpu")
    tr = Trainer(cfg, model, device="cpu")
    lv = {"segmentation": 0.7, "classification": -2.5, "detection": 4.0,
          "Regression": 0.0}
    with torch.no_grad():
        for k, v in lv.items():
            tr.adaptive[k].fill_(v)
    snap = tr.adaptive_snapshot()
    jlv = {k: jnp.float32(v) for k, v in lv.items()}
    for key, fn in (("weights", JL.adaptive_weights),
                    ("sigmas", JL.adaptive_sigmas)):
        ref = fn(jlv)
        for k in lv:
            assert abs(snap[key][k] - float(ref[k])) <= 1e-6 * abs(
                float(ref[k])), (key, k)
    a = LRScheduler(cfg)
    for score in (0.5, 0.4, 0.3, 0.6):
        a.step(score)
    b = LRScheduler(cfg)
    b.load_state_dict(a.state_dict())
    for score in (0.2, 0.1, 0.7):
        a.step(score)
        b.step(score)
        assert a.current_lr() == b.current_lr()
    assert a.current_scale() < 1.0
