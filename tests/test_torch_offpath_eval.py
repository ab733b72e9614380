"""Evaluation, export and serving with a deep-supervision seg head and a
grid det head (the options of ``flagship.ablation_a_config_dict`` at a
tiny width, ``ABLATION_A_OVERRIDES``), the port against the JAX package
on the same bridged weights over one synthetic dataset: ``evaluate``
(seg scored on the main output, det boxes decoded from the grid map's
objectness argmax), ``export_predictions`` (the same records and masks),
and ``StreamingPredictor`` answering as ``Predictor``. Then ``fit`` with
those options (accumulation over 2 micro-steps, SGD) -> checkpoint ->
``--resume`` -> ``predict``: a 3-step epoch leaves half an accumulation
in the checkpoint, which the resumed run loads (its micro-step count
starts again at 0, as in the JAX package).

A served model (its Swin masks first made under inference mode) then
takes a train step.

Tolerances: ``evaluate`` within 1e-4 per task and metric (two f32
forwards of a tiny Swin, as tests/test_torch_fit.py); the export's class
ids, mask names and masks equal, boxes and points within 1e-4 of the
frame's size (both resize the frames with the port's resize, as
tests/test_torch_export.py); the streamed answers equal to
``Predictor``'s (one forward each, the same batch).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu import metrics as JM
from fmc_uia_tpu.config import Config as JaxConfig
from fmc_uia_tpu.export import export_predictions as jax_export
from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch import checkpoint as ckpt_lib
from fmc_uia_tpu_torch import metrics as PM
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.dataset import _resize_image
from fmc_uia_tpu_torch.data.image_io import read_mask
from fmc_uia_tpu_torch.data.pipeline import build_data_engines
from fmc_uia_tpu_torch.data.synthetic import (
    DEFAULT_TASKS,
    generate_synthetic_dataset,
)
from fmc_uia_tpu_torch.export import Predictor, export_predictions
from fmc_uia_tpu_torch.fit import fit
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.predict import main as predict_main
from fmc_uia_tpu_torch.serving import StreamingPredictor
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.train import Trainer
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from helpers import make_tiny_config
from torch_port_utils import ABLATION_A_OVERRIDES, random_like_tree

FRAME = (96, 112)  # (h, w)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("offpath_eval"))
    generate_synthetic_dataset(root, samples_per_task=6, image_hw=FRAME,
                               seed=2)
    d = make_tiny_config(**ABLATION_A_OVERRIDES).config
    d["tasks"] = copy.deepcopy(DEFAULT_TASKS)
    d["data"].update(root_path=root, batch_size=4, num_workers=0)
    jcfg = JaxConfig(config_dict=copy.deepcopy(d))
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=6)
    cfg = Config(config_dict=copy.deepcopy(d))
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu")
    load_jax_params(model, params)
    assert type(model.head_banks_segmentation).__name__ == (
        "DeepSupervisionSegHeadBank")
    assert type(model.head_banks_detection).__name__ == (
        "GridDetectionHeadBank")
    return dict(root=root, cfg=cfg, reg=reg, model=model, jcfg=jcfg,
                jreg=jreg, jmodel=jmodel,
                jparams=jax.tree_util.tree_map(jnp.asarray, params),
                mean=cfg.get("data.augmentation.normalize.mean"),
                std=cfg.get("data.augmentation.normalize.std"))


def test_evaluate_matches_jax(setup):
    s = setup
    _, val_engine, reg = build_data_engines(s["cfg"])
    got = PM.evaluate(s["model"], val_engine, reg, s["mean"], s["std"],
                      device="cpu")
    ref = JM.evaluate(s["jmodel"], s["jparams"], val_engine, s["jreg"],
                      s["mean"], s["std"])
    assert len(got) == len(ref) == len(reg)
    names = set()
    for row, (_, rrow) in zip(got, ref.iterrows()):
        assert row["Task ID"] == rrow["Task ID"]
        names.add(row["Task Name"])
        for k, v in row.items():
            if k not in ("Task ID", "Task Name"):
                assert abs(v - rrow[k]) <= 1e-4, (row["Task ID"], k, v,
                                                  rrow[k])
    assert {"segmentation", "detection"} <= names


def _load(out_dir, task_id):
    with open(os.path.join(out_dir, f"{task_id}.json")) as f:
        return json.load(f)


def test_export_predictions_matches_jax(setup, tmp_path, monkeypatch):
    import fmc_uia_tpu.export as jax_export_mod

    s = setup
    monkeypatch.setattr(jax_export_mod, "_resize_image", _resize_image)
    ref_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_export(s["jmodel"], s["jparams"], s["root"], ref_dir, s["jreg"],
               s["mean"], s["std"], 64, batch_size=4)
    export_predictions(s["model"], s["root"], got_dir, s["reg"], s["mean"],
                       s["std"], 64, batch_size=4, device="cpu")
    h, w = FRAME
    for spec in s["reg"]:
        ref, got = _load(ref_dir, spec.task_id), _load(got_dir, spec.task_id)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.keys() == r.keys() and g["image"] == r["image"]
            if spec.task_name == "classification":
                assert g["class"] == r["class"]
            elif spec.task_name == "detection":
                for k, size in (("x_min", w), ("y_min", h), ("x_max", w),
                                ("y_max", h)):
                    assert abs(g[k] - r[k]) <= 1e-4 * size, (k, g, r)
            elif spec.task_name == "Regression":
                for (gx, gy), (rx, ry) in zip(g["points"], r["points"]):
                    assert abs(gx - rx) <= 1e-4 * w
                    assert abs(gy - ry) <= 1e-4 * h
            else:
                assert g["mask"] == r["mask"]
                np.testing.assert_array_equal(
                    read_mask(os.path.join(got_dir, "masks", g["mask"])),
                    read_mask(os.path.join(ref_dir, "masks", r["mask"])))


def test_streaming_answers_as_predictor(setup):
    s = setup
    pred = Predictor(s["model"], s["reg"], s["mean"], s["std"], 64,
                     device="cpu")
    imgs = np.random.RandomState(3).randint(
        0, 256, (4, 64, 64, 3)).astype(np.uint8)
    tids = [t["task_id"] for t in DEFAULT_TASKS]
    svc = StreamingPredictor(s["model"], s["reg"], s["mean"], s["std"], 64,
                             max_batch=4, autoscale=False, device="cpu")
    try:
        for tid in tids:
            want = pred.predict_images(imgs, tid)
            futs = [svc.submit(im, tid) for im in imgs]
            got = np.stack([f.result(timeout=120) for f in futs])
            np.testing.assert_array_equal(got, want)
            if s["reg"][tid].task_name == "segmentation":
                assert want.shape == (4, 64, 64)  # main, at full size
            if s["reg"][tid].task_name == "detection":
                assert want.shape == (4, 4)
    finally:
        svc.close()


def test_fit_resume_predict_with_accumulation(setup, tmp_path):
    d = copy.deepcopy(setup["cfg"].config)
    d["data"]["fused_preprocess"] = True
    d["experiment"].update(output_dir=str(tmp_path / "out"),
                           save_checkpoints=True, checkpoint_freq=1)
    d["training"].update(num_epochs=1, steps_per_epoch=3)
    d["validation"]["enabled"] = False  # the resumed run validates
    fit(config=Config(config_dict=copy.deepcopy(d)), device="cpu")
    path, meta = ckpt_lib.latest_checkpoint(tmp_path / "out")
    state = torch.load(path, weights_only=True)
    assert meta["epoch"] == 1 and state["optimizer"]["kind"] == "SGD"
    assert state["optimizer"]["count"] == 1  # 3 micro-steps, 1 update
    assert any(a.abs().max() > 0 for a in state["grad_accum"])
    d["training"]["num_epochs"] = 2
    d["validation"]["enabled"] = True
    r = fit(config=Config(config_dict=d), resume=True, device="cpu")
    assert r["best_epoch"] >= 1
    state = torch.load(os.path.join(r["experiment_dir"],
                                    "checkpoint_epoch_2.pt"),
                       weights_only=True)
    # the resumed epoch's micro-steps 1, 2 (update), 3
    assert state["optimizer"]["count"] == 2
    out = str(tmp_path / "preds")
    predict_main(["--checkpoint", r["experiment_dir"], "--data",
                  setup["root"], "--out", out, "--device", "cpu"])
    for spec in setup["reg"]:
        recs = _load(out, spec.task_id)
        assert len(recs) > 0
        if spec.task_name == "detection":
            assert all(0 <= recs[0][k] <= FRAME[1] for k in ("x_min",
                                                            "x_max"))


def test_served_model_trains(setup):
    """The masks a forward caches under ``Predictor``'s inference mode are
    normal tensors: the same model then trains (autograd refused to save
    an inference tensor for backward before)."""
    s = setup
    model = build_model(s["cfg"], s["reg"], device="cpu", init=False)
    model.load_state_dict(s["model"].state_dict())
    pred = Predictor(model, s["reg"], s["mean"], s["std"], 64, device="cpu")
    imgs = np.zeros((2, 64, 64, 3), np.uint8)
    pred.predict_images(imgs, "T2A_syn_organ")
    trainer = Trainer(s["cfg"], model, s["reg"], device="cpu")
    rng = np.random.RandomState(0)
    batch = {"image": rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
             "label": rng.randint(0, 2, (2, 64, 64)).astype(np.int32),
             "task_id": "T2A_syn_organ", "task_type": "segmentation",
             "task_index": s["reg"]["T2A_syn_organ"].global_index}
    logs = trainer.compute_grads(batch)
    assert np.isfinite(float(logs["total_loss"]))
