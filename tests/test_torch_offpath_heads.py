"""The off-main-path head banks of the port against the JAX package's,
module by module, with the same seeded numpy weights bridged into both:
``UNetLikeSegHeadBank``, ``DeepSupervisionSegHeadBank`` (the ``(main,
[aux...])`` tuple), ``BaselineClsHeadBank``, ``GridDetectionHeadBank``,
``BaselineGridDetectionHeadBank`` and ``BaselineRegHeadBank``; the
``build_head_banks`` dispatch; and ``decode_grid_detection`` with planted
ties.

Tolerances: forward outputs within 1e-5 of their largest magnitude (f32
convs, GroupNorms and resizes summed in another order); decoded boxes
exact (the argmax picks the same cell, the first maximum in row-major
order, and the box is read from it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models import heads as JH
from fmc_uia_tpu.ops.centernet import decode_grid_detection as jax_decode
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import heads as PH
from fmc_uia_tpu_torch.ops.centernet import (
    decode_detection,
    decode_grid_detection,
)
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from helpers import make_tiny_config
from torch_port_utils import random_like_tree

T, CIN = 3, 32  # banks, input channels
# the class's name in both packages, and the kwargs both take
CASES = {
    "unet_up4": ("UNetLikeSegHeadBank", dict(num_classes=3, mid_channels=16,
                                             upsampling=4, num_blocks=2)),
    "unet_up1_blocks3": ("UNetLikeSegHeadBank",
                         dict(num_classes=2, mid_channels=16, upsampling=1,
                              num_blocks=3)),
    "unet_up2_mid_default": ("UNetLikeSegHeadBank",
                             dict(num_classes=2, upsampling=2,
                                  num_blocks=1)),
    "deep_sup": ("DeepSupervisionSegHeadBank",
                 dict(num_classes=3, num_aux_outputs=3, upsampling=4)),
    "deep_sup_up1": ("DeepSupervisionSegHeadBank",
                     dict(num_classes=2, num_aux_outputs=2, upsampling=1)),
    "baseline_cls": ("BaselineClsHeadBank", dict(num_classes=4,
                                                 dropout=0.3)),
    "grid": ("GridDetectionHeadBank", dict(num_classes=1, mid_channels=16)),
    "grid_anchors2": ("GridDetectionHeadBank",
                      dict(num_classes=2, mid_channels=16, num_anchors=2)),
    "baseline_grid": ("BaselineGridDetectionHeadBank",
                      dict(num_classes=1, mid_channels=16)),
    "baseline_reg": ("BaselineRegHeadBank", dict(num_points=3)),
}


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err


@pytest.mark.parametrize("case", list(CASES))
def test_head_bank_matches_jax(case):
    cls_name, kw = CASES[case]
    jmod = getattr(JH, cls_name)(num_banks=T, **kw)
    pmod = getattr(PH, cls_name)(T, CIN, **kw)
    x = np.random.RandomState(1).standard_normal(
        (2, 8, 8, CIN)).astype(np.float32)
    idx = jnp.int32(1)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), idx))["params"]
    params = random_like_tree(shapes, seed=2)
    load_jax_params(pmod, params)
    ref = jmod.apply({"params": params}, jnp.asarray(x), idx)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), torch.tensor(1))
    if isinstance(ref, tuple):  # deep supervision: (main, [aux...])
        assert isinstance(got, tuple) and len(got[1]) == len(ref[1])
        assert got[0].shape[1] == 8 * kw["upsampling"]
        _close(got[0], ref[0])
        for a, b in zip(got[1], ref[1]):
            _close(a, b)
    else:
        _close(got, ref)
    if cls_name.endswith("GridDetectionHeadBank"):  # sigmoid box channels
        box = got[..., :4].numpy()
        assert box.min() >= 0.0 and box.max() <= 1.0


DISPATCH = [
    ({"segmentation": {"use_deep_supervision": True}},
     {"segmentation": "DeepSupervisionSegHeadBank"}),
    ({"segmentation": {"type": "unet_like"}},
     {"segmentation": "UNetLikeSegHeadBank"}),
    ({"use_baseline": True},
     {"classification": "BaselineClsHeadBank",
      "detection": "BaselineGridDetectionHeadBank",
      "Regression": "BaselineRegHeadBank"}),
    ({"detection": {"type": "grid"}, "classification": {"type": "baseline"},
      "regression": {"type": "baseline"}},
     {"detection": "GridDetectionHeadBank",
      "classification": "BaselineClsHeadBank",
      "Regression": "BaselineRegHeadBank"}),
    ({"detection": {"type": "baseline"}},
     {"detection": "BaselineGridDetectionHeadBank"}),
]


@pytest.mark.parametrize("heads,want", DISPATCH)
def test_build_head_banks_dispatch(heads, want):
    jcfg = make_tiny_config(model={"heads": heads})
    jbanks = JH.build_head_banks(jcfg, JaxRegistry.from_config(jcfg))
    cfg = Config(config_dict=jcfg.config)
    reg = TaskRegistry.from_config(cfg)
    pbanks = PH.build_head_banks(cfg, reg, {t: CIN for t in
                                            reg.present_types()})
    assert set(pbanks) == set(jbanks)
    for t in jbanks:
        assert type(pbanks[t]).__name__ == type(jbanks[t]).__name__, t
    for t, name in want.items():
        assert type(pbanks[t]).__name__ == name


def _planted_ties(seed, B=4, H=16, W=16):
    """A grid map whose objectness has ties at its maximum: values on a
    coarse grid (bf16-like), the maximum planted at 2-3 cells of each
    image, the first in row-major order at a random place."""
    rng = np.random.RandomState(seed)
    out = rng.rand(B, H, W, 5).astype(np.float32)
    obj = np.round(rng.standard_normal((B, H, W)) * 4) / 4
    for b in range(B):
        cells = rng.choice(H * W, 3 - b % 2, replace=False)
        obj[b].flat[cells] = obj[b].max() + 0.25
    out[..., 4] = obj
    # bf16-rounded, then f32: the decode's input in the port's eval
    return torch.from_numpy(out).bfloat16().float().numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_grid_detection_ties(seed):
    out = _planted_ties(seed)
    ref = np.asarray(jax_decode(jnp.asarray(out)))
    got = decode_grid_detection(torch.from_numpy(out)).numpy()
    np.testing.assert_array_equal(got, ref)
    B, H, W, _ = out.shape
    for b in range(B):
        flat = out[b, ..., 4].reshape(-1)
        first = int(np.flatnonzero(flat == flat.max())[0])
        assert (flat == flat.max()).sum() >= 2  # a tie was planted
        np.testing.assert_array_equal(got[b], out[b, first // W,
                                                  first % W, :4])
    # decode_detection takes a grid map as it is
    np.testing.assert_array_equal(
        decode_detection(torch.from_numpy(out)).numpy(), ref)


@pytest.mark.parametrize("which,want", [
    ("a", dict(seg="DeepSupervisionSegHeadBank", det="GridDetectionHeadBank",
               cls="ClsHeadBank", reg="RegHeadBank", film="TaskEmbeddingFiLM",
               multi=True, prompt="add", opt="SGD", accum=2,
               reg_loss="smooth_l1_loss")),
    ("b", dict(seg="UNetLikeSegHeadBank",
               det="BaselineGridDetectionHeadBank",
               cls="BaselineClsHeadBank", reg="BaselineRegHeadBank",
               film="TaskEmbeddingFiLM", multi=False, prompt="mul",
               opt="Adam", accum=1, reg_loss="l1_loss")),
])
def test_ablation_dicts_build_at_full_width(which, want):
    """``flagship.ablation_{a,b}_config_dict`` build on the CPU (the
    flagship's swin_b 512², 27 tasks; weights left at their placeholders)
    with the options they name, and so does their Trainer."""
    from fmc_uia_tpu_torch import flagship
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.train import Trainer

    cfg = Config(config_dict=getattr(flagship,
                                     f"ablation_{which}_config_dict")())
    assert cfg.image_size == 512 and len(cfg.get_task_configs()) == 27
    model = build_model(cfg, device="cpu", init=False)
    assert tuple(model.encoder.out_channels) == (128, 256, 512, 1024)
    names = {t: type(getattr(model, f"head_banks_{t}")).__name__
             for t in ("segmentation", "detection", "classification",
                       "Regression")}
    assert names == {"segmentation": want["seg"], "detection": want["det"],
                     "classification": want["cls"],
                     "Regression": want["reg"]}
    assert type(model.film).__name__ == want["film"]
    assert (model.multi_film is not None) == want["multi"]
    assert model.task_prompt.inject_mode == want["prompt"]
    trainer = Trainer(cfg, model, device="cpu")
    assert trainer.optimizer.kind == want["opt"]
    assert trainer.accum_steps == want["accum"]
    assert trainer.loss_fns["Regression"].__name__ == want["reg_loss"]
    assert trainer.loss_fns["detection"].__name__ == "grid_loss"
