"""The port's challenge-format export, predict CLI and MoE statistics files
against the JAX package's.

``export_predictions``: the MoE model of tests/test_torch_moe.py
(swin_micro 64² with the dense MoE, f32), the same seeded numpy weights
bridged into both packages, over a synthetic dataset of 112x96 frames
(non-square: the masks are resized back to each frame) with one unreadable
image; batch 4 over 6 frames a task, so the last chunk is short (the JAX
package pads it, the port does not). Both packages get the same resized
frames: the JAX export's bilinear resize (cv2, 11-bit fixed point) is
swapped for the port's (f32, within 1 of cv2's: tests/test_torch_data.py),
so that the comparison holds the export and the model, not the resize; the
masks go back to each frame's size by each package's own nearest resize
(the port's is cv2's to the bit). Tolerances: the records' image names,
mask names and class ids equal; boxes and points within 1e-4 of the
frame's size (f32 decode of outputs within 2e-5 of each other, times the
size); masks equal per pixel except where the JAX model's two best logits
at the pixel's source are within 1e-5 (the count of such pixels is
asserted to cover every difference).

``predict``: ``python -m fmc_uia_tpu_torch.predict`` on the experiment dir
of a CPU ``fit`` of that model writes the same files, byte for byte, as an
in-process ``export_predictions`` with the loaded ``best_model.pt``. The
same fit's ``moe_stats.csv`` holds both epochs and equals, byte for byte,
what the JAX package's logger writes from the same history.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.config import Config as JaxConfig
from fmc_uia_tpu.export import export_predictions as jax_export
from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.ops.image import normalize_images as jax_normalize
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu.utils.logger import TrainingLogger as JaxLogger
from fmc_uia_tpu_torch import checkpoint as ckpt_lib
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.dataset import _resize_image
from fmc_uia_tpu_torch.data.image_io import read_image, read_mask, resize_nearest
from fmc_uia_tpu_torch.data.synthetic import (
    DEFAULT_TASKS,
    generate_synthetic_dataset,
)
from fmc_uia_tpu_torch.export import export_predictions
from fmc_uia_tpu_torch.fit import fit
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.predict import main as predict_main
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from helpers import make_tiny_config
from torch_port_utils import MOE_OVERRIDES, random_like_tree

FRAME = (96, 112)   # (h, w)
PER_TASK = 6
BATCH = 4
NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("exportdata"))
    generate_synthetic_dataset(root, samples_per_task=PER_TASK,
                               image_hw=FRAME, seed=1)
    # one unreadable frame: both packages skip it
    with open(os.path.join(root, "images", "T1_syn_planes_0002.png"),
              "wb") as f:
        f.write(b"not a png")
    return root


def _cfg_dict():
    d = make_tiny_config(**MOE_OVERRIDES).config
    d["tasks"] = copy.deepcopy(DEFAULT_TASKS)
    return d


def _load(out_dir, task_id):
    with open(os.path.join(out_dir, f"{task_id}.json")) as f:
        return json.load(f)


def test_export_predictions_matches_jax(data_root, tmp_path, monkeypatch):
    import fmc_uia_tpu.export as jax_export_mod

    monkeypatch.setattr(jax_export_mod, "_resize_image", _resize_image)
    jcfg = JaxConfig(config_dict=_cfg_dict())
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=3)
    cfg = Config(config_dict=_cfg_dict())
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu")
    load_jax_params(model, params)
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    ref_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jout = jax_export(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                      data_root, ref_dir, jreg, mean, std, 64,
                      batch_size=BATCH)
    gout = export_predictions(model, data_root, got_dir, reg, mean, std, 64,
                              batch_size=BATCH, device="cpu")
    assert list(gout) == list(jout) == sorted(t["task_id"]
                                             for t in DEFAULT_TASKS)
    seg_logits = jax.jit(lambda p, x, i: jmodel.apply(
        {"params": p}, x, "segmentation", i))
    h, w = FRAME
    n_diff = n_tie = 0
    for spec in reg:
        ref, got = _load(ref_dir, spec.task_id), _load(got_dir, spec.task_id)
        n_readable = PER_TASK - (spec.task_id == "T1_syn_planes")
        assert len(got) == len(ref) == n_readable
        for g, r in zip(got, ref):
            assert g.keys() == r.keys() and g["image"] == r["image"]
            if spec.task_name == "classification":
                assert g["class"] == r["class"]
            elif spec.task_name == "detection":
                for k, size in (("x_min", w), ("y_min", h), ("x_max", w),
                                ("y_max", h)):
                    assert abs(g[k] - r[k]) <= 1e-4 * size, (k, g, r)
            elif spec.task_name == "Regression":
                assert len(g["points"]) == spec.num_classes
                for (gx, gy), (rx, ry) in zip(g["points"], r["points"]):
                    assert abs(gx - rx) <= 1e-4 * w and abs(gy - ry) <= (
                        1e-4 * h)
            else:
                assert g["mask"] == r["mask"]
                gm = read_mask(os.path.join(got_dir, "masks", g["mask"]))
                rm = read_mask(os.path.join(ref_dir, "masks", r["mask"]))
                assert gm.shape == rm.shape == FRAME
                img = read_image(os.path.join(data_root, "images",
                                              g["image"]))
                x = jax_normalize(jnp.asarray(_resize_image(img, 64)[None]),
                                  mean, std, dtype=jnp.float32)
                logits = np.asarray(seg_logits(
                    params, x, jnp.int32(spec.global_index)))[
                        0, ..., :spec.num_classes]
                top2 = np.sort(logits, axis=-1)[..., -2:]
                tie = resize_nearest(
                    ((top2[..., 1] - top2[..., 0]) <= NEAR_TIE).astype(
                        np.uint8), h, w).astype(bool)
                diff = gm != rm
                assert not (diff & ~tie).any(), (g["mask"], int(diff.sum()))
                n_diff += int(diff.sum())
                n_tie += int(tie.sum())
    assert n_diff <= n_tie
    assert sorted(os.listdir(os.path.join(got_dir, "masks"))) == sorted(
        os.listdir(os.path.join(ref_dir, "masks")))


@pytest.fixture(scope="module")
def fitted(data_root, tmp_path_factory):
    """A CPU fit of the MoE model: 2 epochs x 4 steps, K3's plain version
    in the train prep."""
    out = str(tmp_path_factory.mktemp("fitout"))
    d = make_tiny_config(**MOE_OVERRIDES).config
    d["data"].update(root_path=data_root, batch_size=4, image_size=64,
                     num_workers=2, fused_preprocess=True)
    d["experiment"].update(output_dir=out, save_checkpoints=False)
    result = fit(config=Config(config_dict=d), device="cpu")
    return result["experiment_dir"]


def test_fit_with_moe_writes_moe_stats_as_jax(fitted, tmp_path):
    with open(os.path.join(fitted, "training_history.json")) as f:
        hist = json.load(f)
    assert [e["epoch"] for e in hist] == [1, 2]
    for e in hist:
        stats = e["moe_stats"]
        assert set(stats) == {"by_task_id", "by_task_name"}
        for rec in stats["by_task_name"].values():
            assert abs(sum(rec["importance"]) - 1.0) <= 1e-5
            assert abs(sum(rec["load"]) - 2.0) <= 1e-5
            assert np.isfinite(rec["aux_loss"])
    with open(os.path.join(fitted, "moe_stats.csv")) as f:
        got = f.read()
    lines = got.splitlines()
    assert lines[0] == "epoch,scope,key,task_name,expert,importance,load"
    assert {ln.split(",")[0] for ln in lines[1:]} == {"1", "2"}
    jlog = JaxLogger(str(tmp_path), "jax")
    jlog.history = hist
    jlog._rewrite_files()
    with open(os.path.join(jlog.get_experiment_dir(), "moe_stats.csv")) as f:
        assert got == f.read()


def test_predict_cli_writes_what_export_predictions_writes(
        fitted, data_root, tmp_path):
    cli_dir, ref_dir = str(tmp_path / "cli"), str(tmp_path / "ref")
    outputs = predict_main(["--checkpoint", fitted, "--data", data_root,
                            "--out", cli_dir, "--device", "cpu",
                            "--batch-size", str(BATCH)])
    assert len(outputs) == len(DEFAULT_TASKS)
    with open(os.path.join(fitted, "config.yaml")) as f:
        cfg = Config(config_dict=json.load(f))
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu")
    model.load_state_dict(ckpt_lib.load_best_params(fitted, "cpu"))
    export_predictions(model, data_root, ref_dir, reg,
                       cfg.get("data.augmentation.normalize.mean"),
                       cfg.get("data.augmentation.normalize.std"),
                       cfg.image_size, batch_size=BATCH, device="cpu")
    for sub in ("", "masks"):
        names = sorted(f for f in os.listdir(os.path.join(ref_dir, sub))
                       if f != "masks")
        assert names == sorted(f for f in os.listdir(
            os.path.join(cli_dir, sub)) if f != "masks")
        for name in names:
            with open(os.path.join(ref_dir, sub, name), "rb") as a, open(
                    os.path.join(cli_dir, sub, name), "rb") as b:
                assert a.read() == b.read(), name
    masks = os.listdir(os.path.join(cli_dir, "masks"))
    assert len(masks) == 2 * PER_TASK
    assert all(read_mask(os.path.join(cli_dir, "masks", m)).shape == FRAME
               for m in masks)


def test_predict_refuses_missing_cuda(fitted, data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_main(["--checkpoint", fitted, "--data", data_root,
                      "--out", str(tmp_path)])
