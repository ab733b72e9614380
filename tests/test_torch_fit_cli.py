"""The port's fit through its CLI, and preemption: a SIGTERM mid-epoch
checkpoints and ``--resume`` continues (moved here from
tests/test_torch_fit.py, unchanged, so that the two longest fits run on
another worker than the rest of that file).
"""

import copy
import json
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

from fmc_uia_tpu_torch import checkpoint as ckpt_lib
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset
from fmc_uia_tpu_torch.fit import fit
from helpers import TINY_CONFIG
from torch_port_utils import TRAIN_OVERRIDES


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
