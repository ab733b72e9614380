"""Data parallel, ZeRO-1 and accumulation on 2 gloo ranks on the CPU
(``fmc_uia_tpu_torch.parallel.run_local``), held against the JAX
package's single-device step and the port's single process.

The batch losses are global under a mesh (each numerator and denominator
summed over the ranks before the division, the backward passing the
gradient through) and the grads are summed: so 2 ranks give the JAX step
at ``check_train_step``'s tolerances, and a DDP-style mean of per-rank
losses would not (``test_global_losses_match_jax_and_ddp_mean_does_not``).
"""

import copy

import numpy as np
import pytest
import torch

from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.parallel import run_local
from fmc_uia_tpu_torch.train import Trainer
from fmc_uia_tpu_torch.utils.convert import jax_leaves_to_port
from test_torch_parallel_workers import load_port_params, run_jobs
from torch_port_utils import (
    MOE_OVERRIDES,
    check_moe_train_step,
    check_train_step,
    train_batch_np,
    train_step_pair,
)

TYPES = ["segmentation", "classification", "detection", "Regression"]
DEADLINE = 300  # seconds for the whole 2-rank run of this file


def _aug_dict(base):
    """``base`` with augmentation, flips, drop path and dropout on."""
    d = copy.deepcopy(base)
    aug = d["data"]["augmentation"]["train"]
    aug.update(random_brightness_contrast=1.0, gauss_noise=0.5,
               horizontal_flip=0.5, vertical_flip=0.5)
    d["data"]["fused_preprocess"] = True
    d["model"]["encoder"]["drop_path_rate"] = 0.3
    d["model"]["decoder"]["dropout"] = 0.2
    d["model"]["heads"]["classification"]["dropout"] = 0.3
    return d


def _batches(reg, B, seed=4):
    """Each type's batch from a fresh RandomState(seed), as
    ``train_step_pair`` draws them."""
    return {t: train_batch_np(np.random.RandomState(seed), t, reg, B=B)
            for t in TYPES}


def _single(cfg_dict, params, batches, train=False):
    """The port's single process: grads per batch, or the model state
    after ``train_batch`` on each batch."""
    model = build_model(Config(config_dict=copy.deepcopy(cfg_dict)),
                        device="cpu")
    load_port_params(model, params)
    t = Trainer(Config(config_dict=copy.deepcopy(cfg_dict)), model,
                device="cpu", seed=0)
    if train:
        for b in batches:
            t.train_batch(b, 0)
        return {k: v.numpy().copy() for k, v in t.model_state().items()}
    out = {}
    for key, b in batches.items():
        t.compute_grads(b)
        out[key] = {n: p.grad.numpy().copy()
                    for n, p in model.named_parameters()}
    return out


def _loss_arrays():
    rng = np.random.RandomState(7)
    B, H, C = 4, 8, 3
    heat = np.clip(rng.rand(B, H, H, 1), 0, 0.99).astype(np.float32)
    heat[0, 2, 3, 0] = heat[1, 5, 5, 0] = heat[1, 1, 6, 0] = 1.0  # 3 / 0
    mask = np.zeros((B, H, H, 1), np.float32)
    mask[0, 2, 3] = mask[1, 5, 5] = mask[1, 1, 6] = 1.0
    return {
        "logits": rng.standard_normal((B, H, H, C)).astype(np.float32),
        # class 2 only in the first half: "present" differs per rank
        "seg": np.concatenate([rng.randint(0, 3, (2, H, H)),
                               rng.randint(0, 2, (2, H, H))]).astype(
                                   np.int64),
        "ncls": 3,
        "pred_heatmap": rng.standard_normal((B, H, H, 1)).astype(np.float32),
        "pred_size": rng.rand(B, H, H, 2).astype(np.float32),
        "pred_offset": rng.rand(B, H, H, 2).astype(np.float32),
        "tgt_heatmap": heat, "tgt_mask": mask,
        "tgt_size": rng.rand(B, H, H, 2).astype(np.float32) * mask,
        "tgt_offset": rng.rand(B, H, H, 2).astype(np.float32) * mask,
    }


@pytest.fixture(scope="module")
def runs():
    pair = train_step_pair(TYPES)
    moe = train_step_pair(["segmentation"], overrides=MOE_OVERRIDES)
    cfg = pair["segmentation"]["jcfg"].config
    mcfg = moe["segmentation"]["jcfg"].config
    params = jax_leaves_to_port(pair["segmentation"]["params"])
    mparams = jax_leaves_to_port(moe["segmentation"]["params"])
    reg = pair["segmentation"]["model"].registry
    b2 = _batches(reg, 2)
    aug_cfg = _aug_dict(cfg)
    b4 = _batches(reg, 4, seed=11)
    steps2 = [b4["segmentation"], b4["classification"]]
    # SGD for the port-only step comparisons: an update linear in the
    # grads keeps their f32 summation-order gaps (Adam divides them by
    # sqrt(nu), which makes a gap of a near-zero grad one of ~lr)
    sgd_cfg = copy.deepcopy(cfg)
    sgd_cfg["training"]["optimizer"].update(type="SGD", momentum=0.9)
    acc_cfg = copy.deepcopy(sgd_cfg)
    acc_cfg["training"]["accumulation_steps"] = 2
    dp = {"data": 2}
    jobs = [
        ("grads", dict(cfg_dict=cfg, params=params, batches=b2,
                       mesh_spec=dp)),
        ("grads", dict(cfg_dict=mcfg, params=mparams,
                       batches={"segmentation": b2["segmentation"]},
                       mesh_spec=dp)),
        ("loss", dict(arrays=_loss_arrays())),
        ("train", dict(cfg_dict=cfg, params=params, batches=steps2,
                       mesh_spec=dp)),
        ("train", dict(cfg_dict=cfg, params=params, batches=steps2,
                       mesh_spec=dp, parallel={"zero_optimizer": True})),
        ("train", dict(cfg_dict=acc_cfg, params=params,
                       batches=steps2 * 2, mesh_spec=dp)),
        ("grads", dict(cfg_dict=aug_cfg, params=params, batches=b4,
                       mesh_spec=dp)),
        ("train", dict(cfg_dict=sgd_cfg, params=params, batches=steps2,
                       mesh_spec=dp)),
    ]
    res = run_local(run_jobs, 2, args=(jobs,), timeout_s=DEADLINE)
    return dict(pair=pair, moe=moe, res=res, cfg=cfg, params=params,
                aug_cfg=aug_cfg, b4=b4, acc_cfg=acc_cfg, sgd_cfg=sgd_cfg,
                steps2=steps2)


def _with(r, logs, grads):
    r = dict(r)
    r["logs"] = {k: (float(v) if np.ndim(v) == 0 else v)
                 for k, v in logs.items()}
    r["grads"] = grads
    return r


@pytest.mark.parametrize("ttype", TYPES)
def test_dp_step_matches_jax(runs, ttype):
    """Two ranks, one row each: the summed grads and the global loss are
    the JAX single-device step's."""
    got = runs["res"][0][0]["steps"][ttype]
    check_train_step(_with(runs["pair"][ttype], got["logs"], got["grads"]))


def test_dp_moe_step_matches_jax(runs):
    """The MoE step: importance, load and the balance loss over the global
    batch; grads as the JAX step's."""
    got = runs["res"][0][1]["steps"]["segmentation"]
    r = _with(runs["moe"]["segmentation"], got["logs"], got["grads"])
    check_moe_train_step(r)


def test_dp_ranks_hold_the_same_loss(runs):
    for job in (0, 1):
        for key, step in runs["res"][0][job]["steps"].items():
            other = runs["res"][1][job]["steps"][key]
            for k, v in step["logs"].items():
                np.testing.assert_array_equal(v, other["logs"][k])


def test_global_losses_match_jax_and_ddp_mean_does_not(runs):
    """Dice (batch+spatial sums, present classes), cross entropy and
    CenterNet (num_pos, the masked sums) under the batch scope equal the
    JAX losses of the whole batch, and the global Dice's grad w.r.t. each
    rank's logits is the JAX grad (not twice it); the mean of the per-rank
    losses (what DDP averages) misses Dice and CenterNet."""
    import jax
    import jax.numpy as jnp

    from fmc_uia_tpu import losses as JL

    a = _loss_arrays()
    logits = jnp.asarray(a["logits"])

    def jdice(x):
        return JL.dice_loss_multiclass(x, jnp.asarray(a["seg"]),
                                       num_valid_classes=jnp.int32(3))

    want = {
        "dice": float(jdice(logits)),
        "ce": float(JL.cross_entropy_loss(logits, jnp.asarray(a["seg"]))),
        "det": float(JL.centernet_loss(
            {k: jnp.asarray(a["pred_" + k]) for k in
             ("heatmap", "size", "offset")},
            {k: jnp.asarray(a["tgt_" + k]) for k in
             ("heatmap", "size", "offset", "mask")})),
    }
    jgrad = np.asarray(jax.grad(jdice)(logits))
    res = [r[2] for r in runs["res"]]
    for k, v in want.items():
        for r in res:
            assert abs(r["global"][k] - v) <= 1e-5 * abs(v), (k, r, v)
    for k in ("dice", "det"):
        assert abs(res[0]["ddp_mean"][k] - want[k]) > 1e-3 * abs(want[k]), k
    got = np.concatenate([r["dice_grad"] for r in res])
    np.testing.assert_allclose(got, jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())


def _close_states(got, ref, rel):
    assert set(got) == set(ref)
    for n, v in ref.items():
        err = float(np.abs(got[n] - v).max())
        assert err <= rel * max(float(np.abs(v).max()), 1e-30), (n, err)


def test_zero_equals_dp(runs):
    """ZeRO-1 (moments of each rank's slice; reduce-scatter, update,
    all-gather) gives DP's parameters after 2 steps, within 1e-6 of each
    leaf's max, on both ranks; its whole optimizer state is DP's."""
    dp, zero = runs["res"][0][3], runs["res"][0][4]
    assert zero["count"] == dp["count"] == 2
    assert zero["zero_fraction"] > 0.5 and dp["zero_fraction"] == 0.0
    for r in (0, 1):
        _close_states(runs["res"][r][4]["state"], dp["state"], 1e-6)
    for key in dp["opt"]:
        for ga, gb in zip(zero["opt"][key], dp["opt"][key]):
            for x, y in zip(ga, gb):
                assert x.shape == y.shape
                assert np.abs(x - y).max() <= 1e-6 * max(
                    np.abs(y).max(), 1e-30)


def test_dp_train_steps_equal_single_process(runs):
    """Two SGD steps on 2 ranks: one process's parameters."""
    want = _single(runs["sgd_cfg"], runs["params"], runs["steps2"],
                   train=True)
    _close_states(runs["res"][0][7]["state"], want, 1e-6)


def test_accumulation_under_mesh_equals_single_process(runs):
    """accumulation_steps 2 on 2 ranks: the micro-grads summed locally,
    reduced once at the update; 4 micro-steps = 2 updates, as one
    process."""
    got = runs["res"][0][5]
    assert got["count"] == 2
    want = _single(runs["acc_cfg"], runs["params"], runs["steps2"] * 2,
                   train=True)
    _close_states(got["state"], want, 1e-6)


@pytest.mark.parametrize("ttype", TYPES)
def test_dp_with_augmentation_equals_single_process(runs, ttype):
    """Augmentation (K3's draws), flips, drop path and dropout on: each
    rank draws the global batch's per-row values from the shared
    generator and keeps its rows, so 2 ranks give one process's grads
    within 1e-4 of each leaf's max, the JAX comparisons' rule (the batch's
    sums split in two halves round differently in f32: up to 1.7e-5 of a
    leaf's max here, where drop path leaves some leaves' grads small; a
    wrong draw moves a leaf by its own size)."""
    want = _single(runs["aug_cfg"], runs["params"], runs["b4"])[ttype]
    _close_states(runs["res"][0][6]["steps"][ttype]["grads"], want, 1e-4)



def test_one_rank_mesh_is_the_plain_trainer_bitwise(runs):
    """A mesh of one rank (gloo, in this process) runs the plain step
    bitwise: the losses' sums are skipped where a rank holds the whole
    batch, the clip is the plain one, and the grads' all-reduce over one
    rank copies them."""
    import torch.distributed as dist

    from fmc_uia_tpu_torch.parallel import make_mesh

    out = {}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(axes=("data",), shape=(1,))
        for kind in ("plain", "mesh"):
            cfg = Config(config_dict=copy.deepcopy(runs["aug_cfg"]))
            model = build_model(cfg, device="cpu")
            load_port_params(model, runs["params"])
            t = Trainer(cfg, model, device="cpu", seed=0,
                        mesh=mesh if kind == "mesh" else None)
            logs = [t.train_batch(b, 0) for b in runs["b4"].values()]
            out[kind] = ([float(v["total_loss"]) for v in logs],
                         {n: p.detach().clone()
                          for n, p in model.named_parameters()})
    finally:
        dist.destroy_process_group()
    assert out["mesh"][0] == out["plain"][0]
    for n, p in out["plain"][1].items():
        assert torch.equal(out["mesh"][1][n], p), n
