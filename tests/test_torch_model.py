"""The port's MultiTaskModel and Predictor against the JAX package's, f32,
for the 4 task types, with the same seeded numpy weights bridged into
both (swin_micro, window 8, fused attention and MLP branches; the JAX
kernels in interpret mode).

The JAX side of the Predictor comparison is the JAX Predictor's own chain
(export.py:83-116): ``normalize_images`` -> ``MultiTaskModel.apply`` ->
``masked_argmax`` / ``decode_centernet``, one jitted apply per task type
shared with the raw-output test.

Tolerances: raw outputs within 2e-5 of their largest magnitude (f32 through
the encoder, FPN and head, summed in another order). Decoded outputs: seg
masks and cls ids equal except at near ties, pixels whose two best logits
are within 1e-4 of each other (their count is asserted to be tiny and
reported); det boxes and reg points within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.metrics import masked_argmax as jax_masked_argmax
from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.ops.centernet import decode_centernet as jax_decode_centernet
from fmc_uia_tpu.ops.image import normalize_images as jax_normalize
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.export import Predictor
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.models.layers import resize_to, upsample_2x
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from helpers import make_tiny_config
from torch_port_utils import random_like_tree

OVERRIDES = {"model": {"encoder": {
    "name": "swin_micro", "window_size": 8, "fused_block": True,
    "fused_mlp": True, "scan_stages": [0, 1, 3], "ln_bf16": True}}}
# one task of each type: task_id -> task type
TASKS = {"T2B_organ_b": "segmentation", "T1_planes": "classification",
         "T4_box": "detection", "T5_points": "Regression"}
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = make_tiny_config(**OVERRIDES)
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                            method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=0)
    cfg = Config(config_dict=jcfg.config)
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu")
    assert model.dtype == torch.float32
    load_jax_params(model, params)
    images = np.random.RandomState(1).randint(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    x = np.array(jax_normalize(jnp.asarray(images), mean, std))
    jax_out = {}
    for task_id, ttype in TASKS.items():
        gidx = reg[task_id].global_index
        jax_out[task_id] = jax.jit(lambda p, x, i: jmodel.apply(
            {"params": p}, x, ttype, i))(params, x, jnp.int32(gidx))
    return dict(reg=reg, model=model, images=images, x=x, mean=mean,
                std=std, jax_out=jax_out)


def _close(got, ref, rel=2e-5):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1.0), err


@pytest.mark.parametrize("task_id", list(TASKS))
def test_model_outputs_match_jax(pair, task_id):
    ttype = TASKS[task_id]
    jout = pair["jax_out"][task_id]
    with torch.no_grad():
        out = pair["model"](torch.from_numpy(pair["x"]), ttype,
                            torch.tensor(pair["reg"][task_id].global_index))
    if ttype == "detection":
        assert set(out) == set(jout) == {"heatmap", "size", "offset"}
        for k in jout:
            _close(out[k], jout[k])
    else:
        _close(out, jout)


def test_predictor_matches_jax(pair):
    pred = Predictor(pair["model"], pair["reg"], pair["mean"], pair["std"],
                     64, device="cpu")
    near_ties = 0
    for task_id, ttype in TASKS.items():
        spec = pair["reg"][task_id]
        raw = pair["jax_out"][task_id]
        got = pred.predict_images(pair["images"], task_id)
        if ttype in ("segmentation", "classification"):
            ref = np.asarray(jax_masked_argmax(raw, spec.num_classes))
            logits = np.asarray(raw)[..., :spec.num_classes]
            top2 = np.sort(logits, axis=-1)[..., -2:]
            tie = (top2[..., 1] - top2[..., 0]) <= NEAR_TIE
            near_ties += int(tie.sum())
            assert got.shape == ref.shape, (task_id, got.shape, ref.shape)
            diff = got != ref
            assert not (diff & ~tie).any(), (task_id, int(diff.sum()))
        else:
            if ttype == "detection":
                ref = jax_decode_centernet(raw["heatmap"], raw["size"],
                                           raw["offset"])
            else:
                ref = raw
            ref = np.asarray(ref, np.float32)
            assert got.shape == ref.shape, (task_id, got.shape, ref.shape)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # near ties: a handful of the 2 x 64 x 64 seg pixels at most
    assert near_ties <= 8, near_ties


@pytest.mark.parametrize("shape,size", [((2, 5, 7, 3), (10, 14)),
                                        ((1, 4, 4, 2), (16, 16)),
                                        ((1, 6, 3, 2), (9, 5))])
def test_bilinear_matches_jax_image_resize(shape, size):
    """F.interpolate(bilinear, align_corners=False) == jax.image.resize
    'bilinear' on upsampling, edges included."""
    x = np.random.RandomState(0).standard_normal(shape).astype(np.float32)
    ref = jax.image.resize(x, (shape[0], *size, shape[3]), "bilinear")
    got = resize_to(torch.from_numpy(x), *size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    if size == (2 * shape[1], 2 * shape[2]):
        up = upsample_2x(torch.from_numpy(x), method="bilinear")
        np.testing.assert_allclose(up.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    near = upsample_2x(torch.from_numpy(x))
    np.testing.assert_array_equal(
        near.numpy(), np.repeat(np.repeat(x, 2, axis=1), 2, axis=2))
