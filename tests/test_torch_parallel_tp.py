"""Tensor parallelism on 2 and on 2 x 2 gloo ranks on the CPU: the step's
loss and (gathered) grads equal the port's single process; the sharded
leaves are the ones ``make_param_specs`` names and each rank holds their
shards only. swin_micro with the unfused MLP (every stage runs Megatron
column -> row), and the dense MoE with its experts split over the model
axis."""

import copy

import numpy as np
import pytest

from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.parallel import make_param_specs, run_local
from fmc_uia_tpu_torch.train import Trainer
from helpers import make_tiny_config
from test_torch_parallel_workers import (
    check_step,
    load_port_params,
    run_jobs,
)
from torch_port_utils import (
    MOE_OVERRIDES,
    TRAIN_OVERRIDES,
    train_batch_np,
)

TYPES = ["segmentation", "classification", "detection", "Regression"]
TP = {"tp_min_dim": 16}
DEADLINE = 300


def _dict(overrides):
    d = make_tiny_config(**copy.deepcopy(overrides)).config
    d["model"]["encoder"]["fused_mlp"] = False
    return d


def _params(d, seed):
    model = build_model(Config(config_dict=copy.deepcopy(d)), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rng = np.random.RandomState(seed)
    return {n: (rng.standard_normal(s) * (0.1 if len(s) < 2 else
                                          1.0 / np.sqrt(np.prod(s[1:]))))
            .astype(np.float32) for n, s in shapes.items()}, model


def _batches(reg, types, B):
    return {t: train_batch_np(np.random.RandomState(4), t, reg, B=B)
            for t in types}


def _single(d, params, batches):
    cfg = Config(config_dict=copy.deepcopy(d))
    model = build_model(cfg, device="cpu")
    load_port_params(model, params)
    t = Trainer(cfg, model, device="cpu", seed=0)
    out = {}
    for key, b in batches.items():
        logs = t.compute_grads(b)
        out[key] = {"logs": {k: v.detach().numpy().copy()
                             for k, v in logs.items()},
                    "grads": {n: p.grad.numpy().copy()
                              for n, p in model.named_parameters()}}
    return out


@pytest.fixture(scope="module")
def cases():
    d = _dict(TRAIN_OVERRIDES)
    md = _dict(MOE_OVERRIDES)
    md["model"]["moe"]["expert_hidden"] = 16
    params, model = _params(d, 3)
    mparams, mmodel = _params(md, 5)
    b = _batches(model.registry, TYPES, 4)
    mb = _batches(mmodel.registry, ["segmentation", "detection"], 4)
    jobs2 = [("grads", dict(cfg_dict=d, params=params, batches=b,
                            mesh_spec={"data": 1, "model": 2},
                            parallel=TP)),
             ("grads", dict(cfg_dict=md, params=mparams, batches=mb,
                            mesh_spec={"model": 2}, parallel=TP))]
    jobs4 = [("grads", dict(cfg_dict=d, params=params, batches=b,
                            mesh_spec={"data": 2, "model": 2},
                            parallel=dict(TP, zero_optimizer=True)))]
    return dict(
        d=d, md=md, model=model, mmodel=mmodel, params=params,
        ref=_single(d, params, b), mref=_single(md, mparams, mb),
        r2=run_local(run_jobs, 2, args=(jobs2,), timeout_s=DEADLINE),
        r4=run_local(run_jobs, 4, args=(jobs4,), timeout_s=DEADLINE))


@pytest.mark.parametrize("ttype", TYPES)
def test_tp_2_ranks_equals_single_process(cases, ttype):
    for rank in (0, 1):
        check_step(cases["r2"][rank][0]["steps"][ttype], cases["ref"][ttype])


@pytest.mark.parametrize("ttype", TYPES)
def test_tp_2x2_ranks_equals_single_process(cases, ttype):
    """{data: 2, model: 2} with ZeRO-1 on the data axis."""
    for rank in range(4):
        check_step(cases["r4"][rank][0]["steps"][ttype], cases["ref"][ttype])


@pytest.mark.parametrize("ttype", ["segmentation", "detection"])
def test_tp_moe_expert_split_equals_single_process(cases, ttype):
    """The dense MoE under tensor parallelism: each rank runs its experts
    (expert_in sharded by experts), one all-reduce sums them."""
    for rank in (0, 1):
        check_step(cases["r2"][rank][1]["steps"][ttype], cases["mref"][ttype])


def test_tp_shards_what_make_param_specs_names(cases):
    """The sharded leaves and their port dims are make_param_specs' (dim 0
    of a column-parallel Dense kernel, dim 1 of a row-parallel one), the
    MLP pairs among them; each rank's parameter bytes are the whole
    model's less the shards it does not hold; ZeRO shards the 2 x 2 run's
    moments over the data axis."""
    specs = make_param_specs(cases["model"], min_shard_dim=16)
    want = {n: [d for d, a in enumerate(s) if a == "model"][0]
            for n, s in specs.items() if s}
    got = cases["r2"][0][0]
    assert got["tp_dims"] == want
    assert want["encoder.stage2_block0.mlp_fc1.kernel"] == 0
    assert want["encoder.stage2_block0.mlp_fc2.kernel"] == 1
    assert want["encoder.stage0_block0.attn.qkv.kernel"] == 0
    params = dict(cases["model"].named_parameters())
    whole = sum(p.numel() * 4 for p in params.values())
    held = whole - sum(params[n].numel() * 4 // 2 for n in want)
    for r in cases["r2"] + cases["r4"]:
        assert r[0]["param_bytes"] == held
    assert cases["r4"][0][0]["zero_dims"]
    assert not cases["r2"][0][0]["zero_dims"]
