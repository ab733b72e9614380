"""The train step's building blocks in the port against the JAX package:
CenterNet targets, the losses and their gradients, the photometric
augmentation and flips, dropout and drop path, and the LR schedule.

Tolerances: targets, flips, forced-parameter augmentation, dropout and
drop-path scaling are the same f32 (or bf16) arithmetic, so equal or
within 2 f32 ulps of their magnitude (an exp or a fused multiply-add may
round the last bit differently); the gaussian radius within 4 ulps of the
box's h + w (its third root cancels); losses within 1e-6 relative and their
gradients within 1e-5 of the largest magnitude; LR sequences within 1e-12
relative. The random parts (apply rates, keep rates) are held to their
probability within 4 standard deviations of a binomial count.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu import losses as JL
from fmc_uia_tpu.ops import centernet as JC
from fmc_uia_tpu.ops import image as JI
from fmc_uia_tpu.train import LRScheduler as JaxLRScheduler
from fmc_uia_tpu_torch import losses as PL
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models.encoders.swin import build_swin
from fmc_uia_tpu_torch.models.layers import (
    apply_drop_path,
    apply_dropout,
    drop_path_keep,
    drop_path_scale,
    dropout,
)
from fmc_uia_tpu_torch.ops import centernet as PC
from fmc_uia_tpu_torch.ops import image as PI
from fmc_uia_tpu_torch.train import LRScheduler
from helpers import make_tiny_config


def _close(got, ref, ulps=2):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    tol = ulps * np.spacing(np.maximum(np.abs(ref), np.float32(1e-30)))
    assert (np.abs(got - ref) <= tol).all(), float(np.abs(got - ref).max())


def _within_4_sigma(count, n, p):
    sd = math.sqrt(n * p * (1 - p))
    assert abs(count - n * p) <= 4 * sd, (count, n * p, sd)


# ---------------------------------------------------------------------------
# CenterNet targets
# ---------------------------------------------------------------------------
BOXES = np.array([
    [0.1, 0.2, 0.4, 0.5],       # ordinary
    [-1.0, -1.0, -1.0, -1.0],   # invalid sentinel
    [0.0, 0.0, 1.0, 1.0],       # the whole image
    [0.9, 0.95, 1.0, 1.0],      # at the bottom-right edge
    [0.0, 0.0, 0.02, 0.03],     # tiny, at the top-left edge
    [0.33, 0.61, 0.34, 0.99],   # thin
], np.float32)


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_centernet_targets_match_jax(hw):
    H, W = hw
    ref = JC.make_centernet_targets(jnp.asarray(BOXES), H, W)
    got = PC.make_centernet_targets(torch.from_numpy(BOXES), H, W)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k].numpy(), ref[k])
    assert float(got["mask"][1].sum()) == 0.0  # the sentinel has no center
    assert float(got["heatmap"][1].abs().sum()) == 0.0


def test_gaussian_radius_matches_jax():
    rng = np.random.RandomState(0)
    h = rng.uniform(0.1, 64, 200).astype(np.float32)
    w = rng.uniform(0.1, 64, 200).astype(np.float32)
    ref = np.asarray(JC.gaussian_radius(jnp.asarray(h), jnp.asarray(w)))
    got = PC.gaussian_radius(torch.from_numpy(h), torch.from_numpy(w))
    # r3 = (b3 + sqrt(...)) / 2 cancels: 4 ulps of the box's h + w
    tol = 4 * np.spacing(h + w)
    assert (np.abs(got.numpy() - ref) <= tol).all()


# ---------------------------------------------------------------------------
# losses and their gradients
# ---------------------------------------------------------------------------
def _loss_and_grad(jfn, pfn, arrays, grad_argnums=(0,)):
    """(JAX loss, JAX grads), (port loss, port grads) of the same inputs."""
    jloss, jgrads = jax.value_and_grad(jfn, argnums=grad_argnums)(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in grad_argnums:
        ts[i].requires_grad_(True)
    ploss = pfn(*ts)
    ploss.backward()
    return (float(jloss), [np.asarray(g) for g in jgrads],
            float(ploss.detach()), [ts[i].grad.numpy() for i in grad_argnums])


def _check_loss(jl, jg, pl, pg):
    assert abs(pl - jl) <= 1e-6 * max(abs(jl), 1e-6), (pl, jl)
    for a, b in zip(pg, jg):
        top = max(float(np.abs(b).max()), 1e-12)
        assert float(np.abs(a - b).max()) <= 1e-5 * top


@pytest.mark.parametrize("nvalid", [2, 3, 4])
def test_dice_loss_matches_jax(nvalid):
    rng = np.random.RandomState(nvalid)
    logits = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    # class 1 absent from the targets: its dice term is dropped
    targets = rng.choice([0, 2], (2, 8, 8)).astype(np.int64)
    n = np.int32(nvalid)
    r = _loss_and_grad(
        lambda x, t: JL.dice_loss_multiclass(x, t, num_valid_classes=n),
        lambda x, t: PL.dice_loss_multiclass(x, t, num_valid_classes=n),
        [logits, targets])
    _check_loss(*r)


@pytest.mark.parametrize("shape", [(5, 6), (2, 4, 4, 6)])
def test_cross_entropy_matches_jax(shape):
    rng = np.random.RandomState(1)
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    targets = rng.randint(0, 3, shape[:-1]).astype(np.int64)
    n = np.int32(3)  # classes 3..5 are padding
    r = _loss_and_grad(
        lambda x, t: JL.cross_entropy_loss(x, t, num_valid_classes=n),
        lambda x, t: PL.cross_entropy_loss(x, t, num_valid_classes=n),
        [logits, targets])
    _check_loss(*r)
    # the padded classes get no gradient
    assert np.abs(r[3][0][..., 3:]).max() == 0.0


@pytest.mark.parametrize("valid", [True, False])
def test_centernet_loss_matches_jax(valid):
    rng = np.random.RandomState(2)
    B, H, W = 3, 16, 16
    boxes = BOXES[[0, 2, 3]] if valid else -np.ones((B, 4), np.float32)
    jt = JC.make_centernet_targets(jnp.asarray(boxes), H, W)
    pt = PC.make_centernet_targets(torch.from_numpy(boxes), H, W)
    hm = rng.standard_normal((B, H, W, 1)).astype(np.float32) * 3
    size = np.abs(rng.standard_normal((B, H, W, 2))).astype(np.float32) * 4
    off = rng.rand(B, H, W, 2).astype(np.float32)
    r = _loss_and_grad(
        lambda h, s, o: JL.centernet_loss(
            {"heatmap": h, "size": s, "offset": o}, jt),
        lambda h, s, o: PL.centernet_loss(
            {"heatmap": h, "size": s, "offset": o}, pt),
        [hm, size, off], grad_argnums=(0, 1, 2))
    _check_loss(*r)
    if not valid:  # num_pos == 0: the negatives' sum alone, no size term
        assert np.abs(r[3][1]).max() == 0.0


def test_mse_masked_columns_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.rand(4, 8).astype(np.float32)
    target = rng.rand(4, 8).astype(np.float32)
    target[:, 6:] = 0.0  # padded columns
    n = np.int32(6)
    r = _loss_and_grad(
        lambda p, t: JL.mse_loss(p, t, num_valid_cols=n),
        lambda p, t: PL.mse_loss(p, t, num_valid_cols=n), [pred, target])
    _check_loss(*r)
    assert np.abs(r[3][0][:, 6:]).max() == 0.0


def test_adaptive_weighting_matches_jax():
    lv = np.float32(-1.3)
    loss = np.float32(2.5)

    def jfn(v, x):
        return JL.adaptive_weighted_loss({"segmentation": v},
                                         {"segmentation": x})[0]

    def pfn(v, x):
        return PL.adaptive_weighted_loss({"segmentation": v},
                                         {"segmentation": x})[0]

    r = _loss_and_grad(jfn, pfn, [lv, loss], grad_argnums=(0, 1))
    _check_loss(*r)
    w_ref = JL.adaptive_weights({"t": jnp.asarray(lv)})["t"]
    w = PL.adaptive_weights({"t": torch.tensor(lv)})["t"]
    _close(w.numpy(), w_ref)


def test_unported_losses_raise():
    """The grid detection loss and the L1 / SmoothL1 regression losses,
    refused before queue 1 item 7, now build."""
    assert PL.build_loss_fn("detection", {"type": "Detection"}).__name__ \
        == "grid_loss"
    assert PL.build_loss_fn("Regression", {"type": "SmoothL1Loss"}) is (
        PL.smooth_l1_loss)
    assert PL.build_loss_fn("Regression", {"type": "L1Loss"}) is PL.l1_loss


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------
def _images(rng, B=3, S=8):
    return rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8)


def test_augment_p0_is_normalize_exactly():
    rng = np.random.RandomState(4)
    img = _images(rng)
    mean, std = [0.33, 0.33, 0.33], [0.18, 0.18, 0.18]
    ref = JI.augment_and_normalize(jax.random.PRNGKey(0), jnp.asarray(img),
                                   mean, std, brightness_contrast_p=0.0,
                                   gauss_noise_p=0.0)
    got = PI.augment_and_normalize(torch.from_numpy(img), mean, std,
                                   brightness_contrast_p=0.0,
                                   gauss_noise_p=0.0,
                                   generator=torch.Generator())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_brightness_contrast_forced_params_match_jax():
    rng = np.random.RandomState(5)
    img = _images(rng)
    key = jax.random.PRNGKey(7)
    # the parameters random_brightness_contrast draws from this key
    _, k_alpha, k_beta = jax.random.split(key, 3)
    alpha = 1.0 + jax.random.uniform(k_alpha, (3,), minval=-0.2, maxval=0.2)
    beta = jax.random.uniform(k_beta, (3,), minval=-0.2, maxval=0.2) * 255.0
    ref = JI.random_brightness_contrast(key, jnp.asarray(img), p=1.0)
    got = PI.brightness_contrast(torch.from_numpy(img),
                                 torch.from_numpy(np.array(alpha)),
                                 torch.from_numpy(np.array(beta)))
    _close(got.numpy(), ref)


def test_gauss_noise_forced_params_match_jax():
    rng = np.random.RandomState(6)
    img = _images(rng)
    key = jax.random.PRNGKey(8)
    _, k_var, k_noise = jax.random.split(key, 3)
    sigma = jnp.sqrt(jax.random.uniform(k_var, (3,), minval=10.0,
                                        maxval=50.0))
    noise = jax.random.normal(k_noise, img.shape, jnp.float32)
    ref = JI.random_gauss_noise(key, jnp.asarray(img), p=1.0)
    got = PI.gauss_noise(torch.from_numpy(img),
                         torch.from_numpy(np.array(sigma)),
                         torch.from_numpy(np.array(noise)))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("which,p", [("bc", 0.2), ("noise", 0.1)])
def test_augment_apply_rate(which, p):
    """The share of images changed is p, within 4 sigma; the changes stay
    inside the parameter ranges."""
    n = 20000
    img = torch.full((n, 1, 1, 1), 128, dtype=torch.uint8)
    g = torch.Generator().manual_seed(0)
    if which == "bc":
        out = PI.random_brightness_contrast(img, p=p, generator=g)
        changed = out.flatten() != 128.0
        # alpha in [0.8, 1.2], beta in [-51, 51]: 128 a + b in [51.4, 204.6]
        assert float(out.min()) >= 51.4 - 1e-3
        assert float(out.max()) <= 204.6 + 1e-3
    else:
        out = PI.random_gauss_noise(img, p=p, generator=g)
        changed = out.flatten() != 128.0
        d = (out.flatten()[changed] - 128.0).abs()
        assert float(d.max()) <= 6 * math.sqrt(50.0)
    _within_4_sigma(int(changed.sum()), n, p)


@pytest.mark.parametrize("ttype", ["segmentation", "detection",
                                   "Regression", "classification"])
def test_flips_match_jax(ttype):
    rng = np.random.RandomState(7)
    img = _images(rng, B=3, S=6)
    if ttype == "segmentation":
        lab = rng.randint(0, 3, (3, 6, 6)).astype(np.int32)
    elif ttype == "detection":
        lab = BOXES[:3].copy()  # includes the invalid sentinel
    elif ttype == "Regression":
        lab = rng.rand(3, 6).astype(np.float32)
    else:
        lab = rng.randint(0, 3, (3,)).astype(np.int32)
    for hp, vp in ((1.0, 0.0), (0.0, 1.0), (1.0, 1.0), (0.0, 0.0)):
        ri, rl = JI.random_flips(jax.random.PRNGKey(0), jnp.asarray(img),
                                 jnp.asarray(lab), ttype, horizontal_p=hp,
                                 vertical_p=vp)
        gi, gl = PI.random_flips(torch.from_numpy(img), torch.from_numpy(lab),
                                 ttype, hp, vp, generator=torch.Generator())
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))


def test_fused_preprocess_raises():
    """data.fused_preprocess no longer raises: the train prep is K3, which
    on a CPU tensor runs its plain version (the same draws through
    augment_normalize_reference give the same output), inside the
    normalized range; the eval prep stays normalize_images."""
    from fmc_uia_tpu_torch.ops import preprocess as PP

    cfg = Config(config_dict=make_tiny_config(data={
        "fused_preprocess": True, "augmentation": {"train": {
            "random_brightness_contrast": 1.0, "gauss_noise": 1.0}}}).config)
    train_prep, eval_prep = PI.input_prep_fns(cfg, torch.bfloat16)
    img = torch.from_numpy(_images(np.random.RandomState(9), B=4, S=16))
    got = train_prep(img, generator=torch.Generator().manual_seed(9))
    sc, seeds = PP.draw_params(4, "cpu", torch.Generator().manual_seed(9),
                               1.0, 1.0)
    mean = cfg.get("data.augmentation.normalize.mean")
    std = cfg.get("data.augmentation.normalize.std")
    want = PP.augment_normalize_reference(img, sc, seeds, mean, std,
                                          torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    lo, hi = (np.array([0.0, 255.0]) - 255 * mean[0]) / (255 * std[0])
    assert float(got.min()) >= lo - 0.02 and float(got.max()) <= hi + 0.02
    assert not torch.equal(got, eval_prep(img))  # p = 1: every image moved
    np.testing.assert_array_equal(
        eval_prep(img).float().numpy(),
        PI.normalize_images(img, mean, std, torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# dropout and drop path
# ---------------------------------------------------------------------------
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_forced_mask_matches_flax(dt, rate):
    """flax nn.Dropout with a given mask: select(mask, x / keep, 0), the
    Python-float keep taken in x's dtype."""
    jdt, tdt = DT[dt]
    rng = np.random.RandomState(8)
    x = rng.standard_normal((4, 5, 5, 6)).astype(np.float32)
    mask = rng.rand(4, 1, 1, 6) < 1 - rate  # channel mask, as the FPN's
    xj = jnp.asarray(x, jdt)
    ref = jax.lax.select(jnp.broadcast_to(jnp.asarray(mask), x.shape),
                         xj / (1.0 - rate), jnp.zeros_like(xj))
    got = apply_dropout(torch.from_numpy(x).to(tdt), torch.from_numpy(mask),
                        rate)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dt", list(DT))
def test_drop_path_forced_mask_matches_jax(dt):
    """The kernels' dp factor where(mask, 1/keep, 0).astype(dtype), and the
    unfused half's where(mask, y / keep.astype(dtype), 0)."""
    jdt, tdt = DT[dt]
    rate = 0.0869565217  # a rate of linspace(0, 0.1, 24)
    mask = np.array([True, False, True, True])
    keep = 1.0 - jnp.asarray(rate, jnp.float32)
    ref = jnp.where(jnp.asarray(mask), 1.0 / keep, 0.0).astype(jdt)
    got = drop_path_scale(torch.from_numpy(mask), rate, tdt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert float(drop_path_keep(rate)) == float(keep)
    y = np.random.RandomState(9).standard_normal((4, 3, 3, 5)).astype(
        np.float32)
    yj = jnp.asarray(y, jdt)
    ref_y = jnp.where(jnp.asarray(mask)[:, None, None, None],
                      yj / keep.astype(jdt), 0.0).astype(jdt)
    got_y = apply_drop_path(torch.from_numpy(y).to(tdt),
                            torch.from_numpy(mask), rate)
    np.testing.assert_array_equal(got_y.float().numpy(),
                                  np.asarray(ref_y.astype(jnp.float32)))


def test_dropout_keep_rate_and_broadcast():
    g = torch.Generator().manual_seed(1)
    x = torch.ones(200, 4, 4, 50)
    y = dropout(x, 0.3, True, g, broadcast_dims=(1, 2))
    # one draw per (sample, channel), broadcast over H and W
    assert bool((y == y[:, :1, :1, :]).all())
    kept = int((y[:, 0, 0, :] != 0).sum())
    _within_4_sigma(kept, 200 * 50, 0.7)
    assert bool(torch.allclose(y[y != 0], torch.tensor(1 / 0.7)))
    assert torch.equal(dropout(x, 0.3, False, g), x)  # eval: identity


def test_swin_drop_path_rates_and_keep_rate():
    cfg = Config(config_dict=make_tiny_config(model={"encoder": {
        "name": "swin_micro", "window_size": 8,
        "drop_path_rate": 0.2}}).config)
    enc = build_swin("swin_micro", cfg)
    rates = [enc.get_submodule(f"stage{s}_block{b}").drop_path
             for s in range(4) for b in range(2)]
    # the JAX encoder's per-block rates (swin.py:563)
    np.testing.assert_array_equal(rates, np.linspace(0, 0.2, 8))
    blk = enc.stage3_block1
    g = torch.Generator().manual_seed(2)
    x = torch.zeros(4000, 1, 1, 1)
    dp = blk._dp(x, True, g)
    keep = float(drop_path_keep(0.2))
    _within_4_sigma(int((dp > 0).sum()), 4000, keep)
    assert set(dp.unique().tolist()) <= {0.0, float(np.float32(1) /
                                                    np.float32(keep))}
    assert blk._dp(x, False, g) is None


# ---------------------------------------------------------------------------
# LR schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sched", [
    {"type": "CosineAnnealingLR", "T_max": 7, "eta_min": 1e-6},
    {"type": "StepLR", "step_size": 3, "gamma": 0.5},
    {"type": "ReduceLROnPlateau", "mode": "max", "factor": 0.5,
     "patience": 1},
    {"type": "None"},
])
def test_lr_scheduler_matches_jax(sched):
    cfg = make_tiny_config(training={"scheduler": sched})
    ref = JaxLRScheduler(cfg)
    got = LRScheduler(Config(config_dict=cfg.config))
    scores = np.random.RandomState(10).rand(12)
    for s in scores:
        assert abs(got.current_lr() - ref.current_lr()) <= (
            1e-12 * ref.current_lr())
        ref.step(float(s))
        got.step(float(s))
    assert abs(got.current_lr() - ref.current_lr()) <= (
        1e-12 * ref.current_lr())


def test_trainer_unported_options_raise():
    """A mesh that is not a DeviceMesh raises a TypeError, the MoE's
    ragged dispatch without an expert-parallel mesh JAX's ValueError, and
    warm-compile raises; accumulation and burst mode (queue 1 item 7)
    run; every parameter carries a zeroed grad from the start."""
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.train import Trainer
    from torch_port_utils import train_batch_np

    enc = {"encoder": {"name": "swin_nano", "window_size": 8}}
    cfg = Config(config_dict=make_tiny_config(model=enc).config)
    model = build_model(cfg, device="cpu")
    accum = Config(config_dict=make_tiny_config(
        model=enc, training={"accumulation_steps": 2}).config)
    t_acc = Trainer(accum, build_model(accum, device="cpu"), device="cpu")
    batch = train_batch_np(np.random.RandomState(0), "classification",
                           t_acc.registry)
    t_acc.train_batch(batch, 0)
    assert t_acc.optimizer.count == 0 and t_acc._micro_step == 1
    t_acc.train_batch(batch, 0)
    assert t_acc.optimizer.count == 1
    ragged = Config(config_dict=make_tiny_config(model=dict(
        enc, moe={"enabled": True, "dispatch": "ragged"})).config)
    t_rag = Trainer(ragged, build_model(ragged, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="needs ep_mesh"):
        t_rag.train_batch(batch, 0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, model, device="cpu", mesh=object())
    trainer = Trainer(cfg, model, device="cpu")
    assert all(torch.equal(p.grad, torch.zeros_like(p))
               for p in model.parameters())
    out = trainer.train_burst(batch, 2)
    assert out["losses"].shape == (2,) and trainer.optimizer.count == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.warm_compile({})