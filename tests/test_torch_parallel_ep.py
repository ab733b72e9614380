"""Ragged expert parallelism on 2 and 4 gloo ranks on the CPU:
``ragged_moe_apply`` against the JAX package's on a mesh of as many
devices (conftest gives JAX 8 CPU devices) — the output and its grads,
at zero-drop capacity (equal to the dense reference) and with capacity
drops (the same tokens dropped); ``MoEConvBlock`` with ``dispatch:
ragged`` against its dense dispatch, and one Trainer step on a
``{model: 2}`` mesh against the single process; a used mesh Trainer
leaves no mesh or batch scope installed."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from fmc_uia_tpu.parallel.expert import dense_moe_reference as jdense
from fmc_uia_tpu.parallel.expert import ragged_moe_apply as jragged
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.parallel import run_local
from fmc_uia_tpu_torch.train import Trainer
from helpers import make_tiny_config
from test_torch_parallel_workers import (
    check_step,
    load_port_params,
    run_jobs,
)
from torch_port_utils import MOE_OVERRIDES, train_batch_np

CASES = [(2, 4.0), (2, 0.5), (1, 1.0)]  # (top_k, capacity factor)
DEADLINE = 240


def _arrays(seed=0, B=8, E=8, F=8):
    rng = np.random.RandomState(seed)
    logits = rng.standard_normal((B, E)) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return {"x": rng.standard_normal((B, 4, 4, F)).astype(np.float32),
            "probs": probs.astype(np.float32),
            "w": (rng.standard_normal((E, F, F)) / np.sqrt(F)).astype(
                np.float32),
            "b": (0.1 * rng.standard_normal((E, F))).astype(np.float32),
            "cot": rng.standard_normal((B, 4, 4, F)).astype(np.float32)}


def _jax_case(a, D, top_k, cf):
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("model",))

    def expert_fn(p, t):
        return jnp.tanh(t @ p["w"]) + p["b"]

    def f(params, x, probs):
        return jragged(expert_fn, params, x, probs, mesh, axis="model",
                       top_k=top_k, capacity_factor=cf)

    params = {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}
    x, probs = jnp.asarray(a["x"]), jnp.asarray(a["probs"])
    y = f(params, x, probs)
    gp, gx, gprobs = jax.grad(lambda p, xx, pp: jnp.sum(
        f(p, xx, pp) * a["cot"]), argnums=(0, 1, 2))(params, x, probs)
    dense = jdense(expert_fn, params, x, probs, top_k=top_k)
    return {"y": np.asarray(y), "dense": np.asarray(dense),
            "dx": np.asarray(gx), "dprobs": np.asarray(gprobs),
            "dw": np.asarray(gp["w"]), "db": np.asarray(gp["b"])}


def _moe_dict():
    d = make_tiny_config(**copy.deepcopy(MOE_OVERRIDES)).config
    return d


@pytest.fixture(scope="module")
def runs():
    a = _arrays()
    d = _moe_dict()
    model = build_model(Config(config_dict=copy.deepcopy(d)), device="cpu")
    rng = np.random.RandomState(2)
    params = {n: (rng.standard_normal(tuple(p.shape)) * 0.1).astype(
        np.float32) for n, p in model.named_parameters()}
    batch = train_batch_np(np.random.RandomState(4), "segmentation",
                           model.registry, B=4)
    r2 = run_local(run_jobs, 2, args=([
        ("ep", dict(arrays=a, cases=CASES)),
        ("moe_block", dict(cfg_dict=d, params=params, batch=batch))],),
        timeout_s=DEADLINE)
    r4 = run_local(run_jobs, 4, args=([("ep", dict(arrays=a,
                                                   cases=CASES))],),
                   timeout_s=DEADLINE)
    single = Trainer(Config(config_dict=copy.deepcopy(d)), model,
                     device="cpu", seed=0)
    load_port_params(model, params)
    logs = single.compute_grads(batch)
    return dict(a=a, r={2: r2, 4: r4}, single_logs={
        k: v.detach().numpy() for k, v in logs.items()},
        single_grads={n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()})


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_ragged_moe_apply_matches_jax(runs, D, case):
    """Output and grads (expert params, tokens, routing probabilities)
    within 1e-5 of each array's max, on every rank."""
    want = _jax_case(runs["a"], D, *CASES[case])
    for rank_out in runs["r"][D]:
        got = rank_out[0][case]
        for k in ("y", "dx", "dprobs", "dw", "db"):
            # dprobs is ~0 at top-1 (the renormalised gate is 1), f32
            # noise there: held against the token grads' scale
            scale = max(float(np.abs(want[k]).max()),
                        float(np.abs(want["dx"]).max()) if k == "dprobs"
                        else 0.0)
            tol = 1e-5 * scale
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                       err_msg=k)


def test_zero_drop_equals_dense_and_drops_differ(runs):
    for D in (2, 4):
        for case, (top_k, cf) in enumerate(CASES):
            got = runs["r"][D][0][0][case]
            gap = float(np.abs(got["y"] - got["dense"]).max())
            if cf * 2 >= 8 / top_k / 2 and case == 0:
                assert gap <= 1e-5 * float(np.abs(got["dense"]).max())
            if case == 1:  # capacity 1 a source rank: tokens dropped
                assert gap > 1e-2


def test_moe_block_ragged_equals_dense(runs):
    got = runs["r"][2][0][1]
    tol = 1e-5 * float(np.abs(got["y_dense"]).max())
    np.testing.assert_allclose(got["y_rag"], got["y_dense"], rtol=0,
                               atol=tol)


def test_ragged_trainer_step_equals_single_process(runs):
    """One step under {model: 2} with the ragged dispatch: the loss and
    grads of the dense single process (``check_step``, its floor at 1e-2
    of the step's largest leaf: the ragged dispatch runs each expert on
    its slots and sums over slots, the dense one a grouped conv summed
    over experts, so the two round apart by ~1e-4 of a leaf 1/500 the
    size of the largest, as stage 3's norm scale is here)."""
    for rank in (0, 1):
        got = runs["r"][2][rank][1]
        check_step(got, {"logs": runs["single_logs"],
                         "grads": runs["single_grads"]},
                   loss_keys=("total_loss", "raw_loss"), floor=1e-2)


def test_mesh_trainer_leaves_no_scope(runs):
    """After the mesh Trainer's step no mesh and no batch scope are
    installed, and the ragged block raises JAX's error again."""
    got = runs["r"][2][0][1]
    assert got["left"] == [True, True]
    assert got["raised"] and "needs ep_mesh" in got["raised"]
