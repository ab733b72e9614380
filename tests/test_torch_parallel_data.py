"""The data path and ``fit`` on 2 gloo ranks on the CPU, against the
port's single process: each rank decodes only its rows of every global
batch (the padded final eval chunk split after padding), the sharded
device-cache banks (about half of each bank a rank) assemble each rank's
rows bitwise; a 2-rank ``fit`` gives the 1-process history and
validation tables, rank 0 alone writes the files, and a checkpoint
resumes across world sizes (2 ranks -> 1 process and 1 -> 2)."""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.pipeline import build_data_engines
from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset
from fmc_uia_tpu_torch.fit import fit
from fmc_uia_tpu_torch.parallel import run_local
from helpers import TINY_CONFIG
from test_torch_parallel_workers import run_jobs
from torch_port_utils import TRAIN_OVERRIDES

DEADLINE = 300


def _dict(root, out, epochs=2, mesh=True):
    d = copy.deepcopy(TINY_CONFIG)
    for k, v in TRAIN_OVERRIDES["model"].items():
        d["model"].setdefault(k, {}).update(v)
    d["model"]["encoder"] = dict(TRAIN_OVERRIDES["model"]["encoder"])
    d["data"].update(root_path=root, batch_size=4, image_size=64,
                     num_workers=2)
    d["training"]["num_epochs"] = epochs
    d["experiment"].update(output_dir=out, save_checkpoints=True,
                           checkpoint_freq=1)
    if mesh:
        d["parallel"] = {"mesh": {"data": -1}}
    return d


def _history(exp_dir):
    with open(os.path.join(exp_dir, "training_history.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pdata"))
    generate_synthetic_dataset(root, samples_per_task=8, seed=0)
    out = {k: str(tmp_path_factory.mktemp(k)) for k in
           ("one", "one3", "two", "pre")}
    one = fit(config=Config(config_dict=_dict(root, out["one"],
                                              mesh=False)), device="cpu")
    one3 = fit(config=Config(config_dict=_dict(root, out["one3"], 3,
                                               mesh=False)), device="cpu")
    # a copy of the 1-process run for 2 ranks to resume
    out["one_r"] = out["one"] + "_resumed"
    shutil.copytree(out["one"], out["one_r"])
    jobs = [("data", dict(cfg_dict=_dict(root, out["one"], mesh=False))),
            ("fit", dict(cfg_dict=_dict(root, out["two"]))),
            ("fit", dict(cfg_dict=_dict(root, out["one_r"], 3),
                         resume=True)),
            ("fit", dict(cfg_dict=_dict(root, out["pre"]),
                         sigterm_after=3)),
            ("fit", dict(cfg_dict=_dict(root, out["pre"]), resume=True))]
    res = run_local(run_jobs, 2, args=(jobs,), timeout_s=DEADLINE)
    # the 2-rank checkpoint (epoch 2) resumed by one process, in a copy
    out["two_r"] = out["two"] + "_resumed"
    shutil.copytree(out["two"], out["two_r"])
    two_to_one = fit(config=Config(config_dict=_dict(
        root, out["two_r"], 3, mesh=False)), device="cpu", resume=True)
    return dict(root=root, out=out, one=one, one3=one3, res=res,
                two_to_one=two_to_one)


def _single_batches(cfg_dict, cached):
    d = copy.deepcopy(cfg_dict)
    d["data"]["device_cache"] = cached
    train, val, _ = build_data_engines(Config(config_dict=d), device="cpu")
    got = {"train": list(train), "val": list(val)}
    train.close()
    val.close()
    return got


@pytest.mark.parametrize("cached", [False, True])
def test_each_rank_gets_its_rows_bitwise(runs, cached):
    """Every train and val batch of each rank is its slice of the single
    process's batch (image, label and valid mask bitwise; the padded eval
    chunks split after padding)."""
    want = _single_batches(_dict(runs["root"], runs["out"]["one"],
                                 mesh=False), cached)
    key = "cache" if cached else "host"
    for rank in (0, 1):
        got = runs["res"][rank][0][key]
        for split in ("train", "val"):
            assert len(got[split]) == len(want[split])
            for g, w in zip(got[split], want[split]):
                n = len(w["image"])
                assert g["rows"] == (rank * n // 2, (rank + 1) * n // 2, n)
                assert g["task_id"] == w["task_id"]
                sl = slice(*g["rows"][:2])
                for k in ("image", "label", "valid"):
                    np.testing.assert_array_equal(
                        g[k], np.asarray(w[k])[sl], err_msg=k)
    # the padded rows (the end of each short task) land on rank 1
    assert any(not v["valid"].all() for v in runs["res"][1][0][key]["val"])


def test_ranks_decode_only_their_rows(runs):
    """Streaming: each rank decodes half of the rows a pass of the engines
    reads (its slices); the sharded cache decodes each staged row once
    over both ranks, and each rank's banks hold half the rows (rounded
    up, padded alike)."""
    want = _single_batches(_dict(runs["root"], runs["out"]["one"],
                                 mesh=False), False)
    n = sum(len(b["image"]) for b in want["train"] + want["val"])
    host = [runs["res"][r][0]["host"]["decoded"] for r in (0, 1)]
    assert len(host[0]) == len(host[1]) == n // 2
    cache = [runs["res"][r][0]["cache"] for r in (0, 1)]
    staged = sorted(cache[0]["decoded"] + cache[1]["decoded"])
    assert len(staged) == len(set(staged))
    for t, rows in cache[0]["bank_rows"].items():
        assert rows == cache[1]["bank_rows"][t]
    total = sum(cache[0]["bank_rows"].values())
    assert total * 2 >= len(staged) >= total


def test_two_rank_fit_matches_one_process(runs):
    """The history's per-task train losses and validation rows of a
    2-rank fit equal the 1-process fit's (1e-4 relative: the ranks'
    forwards on half batches round apart in f32)."""
    one = _history(runs["one"]["experiment_dir"])
    two = _history(runs["res"][0][1]["experiment_dir"])
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        assert set(a["train_losses"]) == set(b["train_losses"])
        for t, v in a["train_losses"].items():
            got, v = b["train_losses"][t]["mean"], v["mean"]
            assert abs(got - v) <= 1e-4 * abs(v), t
        assert len(a["val_metrics"]) == len(b["val_metrics"])
        for ra, rb in zip(a["val_metrics"], b["val_metrics"]):
            for k, v in ra.items():
                if isinstance(v, float):
                    assert abs(rb[k] - v) <= 1e-4 * max(1.0, abs(v)), k
                else:
                    assert rb[k] == v
    assert runs["res"][0][1]["best_epoch"] == runs["one"]["best_epoch"]


def test_rank_zero_writes_the_files_once(runs):
    """One experiment dir, named to both ranks; its checkpoints load on
    one process (the single-process format)."""
    dirs = os.listdir(runs["out"]["two"])
    assert len(dirs) == 1
    r0, r1 = runs["res"][0][1], runs["res"][1][1]
    assert r0["experiment_dir"] == r1["experiment_dir"]
    files = set(os.listdir(r0["experiment_dir"]))
    assert {"best_model.pt", "checkpoint_epoch_2.pt",
            "training_history.json", "val_metrics.csv"} <= files


def test_resume_across_world_sizes(runs):
    """A 2-rank checkpoint resumed by one process, and a 1-process
    checkpoint resumed by 2 ranks, each continue to the epoch-3 losses of
    an unbroken 1-process run."""
    want = _history(runs["one3"]["experiment_dir"])[2]["train_losses"]
    for exp in (runs["two_to_one"]["experiment_dir"],
                runs["res"][0][2]["experiment_dir"]):
        got = _history(exp)
        assert len(got) == 3
        for t, v in want.items():
            g, v = got[2]["train_losses"][t]["mean"], v["mean"]
            assert abs(g - v) <= 1e-4 * abs(v), t


def test_sigterm_on_one_rank_stops_all_and_resumes(runs):
    """A SIGTERM seen by rank 1 alone stops both ranks at the same batch
    boundary (rank 1 sees it before step 4 of epoch 1; the ranks' vote
    is read one batch later, so both stop after 4 steps: a rank that
    went on would wait in a collective until the run's deadline); rank 0
    writes one
    checkpoint of the interrupted epoch; resumed on 2 ranks, the run
    continues in the same experiment dir to its last epoch."""
    pre, resumed = runs["res"][0][3], runs["res"][0][4]
    assert pre["preempted"] and runs["res"][1][3]["preempted"]
    path = os.path.join(pre["experiment_dir"], "checkpoint_epoch_0.pt")
    state = torch.load(path, weights_only=True)
    assert state["host_step"] == 4
    assert not resumed["preempted"]
    assert resumed["experiment_dir"] == pre["experiment_dir"]
    assert len(os.listdir(runs["out"]["pre"])) == 1
    got = _history(resumed["experiment_dir"])
    assert [e["epoch"] for e in got] == [1, 2]
    assert os.path.exists(os.path.join(resumed["experiment_dir"],
                                       "best_model.pt"))
