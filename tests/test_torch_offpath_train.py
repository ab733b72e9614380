"""Gradient accumulation, SGD and the train step with the options of
``flagship.ablation_a_config_dict`` at a tiny width
(``ABLATION_A_OVERRIDES``: swin_nano 64²; a deep-supervision seg head, the
grid det head and its loss, embedding FiLM on the FPN and every encoder
stage, an additive task prompt on seg and det, SmoothL1, SGD with momentum
0.9, ``accumulation_steps`` 2), the port's ``Trainer.train_batch``
against the JAX package's accumulation step (``make_train_step`` with the
config's own optax SGD), micro-step by micro-step over one batch of each
type in turn: seg, cls (update), det, reg (update). After each odd
micro-step the accumulator holds that type's grads / 2 and the params
are bitwise the ones before it; after each even one the update has mixed
two task types' grads and the accumulator is zero. Also the optimizers
alone against optax (SGD's decay after its momentum trace; Adam ignoring
the weight decay), the head/loss mismatch error, and burst mode's refusal
under accumulation.

Tolerances: the losses within 1e-5 relative; the accumulator within 1e-4
of each leaf's largest magnitude (``check_train_step``'s grad rule); the
updated params within 1e-4 of the leaf's largest change plus 2 f32 ulps
of the param (SGD's update is linear in the grads; a change far below the
param's own ulp is lost to its rounding on both sides); the optimizers
alone within 1e-6 of the leaf's largest magnitude over 3 steps. One JAX
step compile per type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from fmc_uia_tpu import losses as jax_losses
from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu.train import TrainState, make_train_step
from fmc_uia_tpu.train import build_optimizer as jax_build_optimizer
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.train import Trainer, build_optimizer
from fmc_uia_tpu_torch.utils.convert import jax_leaves_to_port, load_jax_params
from helpers import make_tiny_config
from torch_port_utils import (
    ABLATION_A_OVERRIDES,
    random_like_tree,
    train_batch_np,
)

ORDER = ("segmentation", "classification", "detection", "Regression")
LR = 1e-3


def _host(tree):
    return jax_leaves_to_port(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def run():
    jcfg = make_tiny_config(**ABLATION_A_OVERRIDES)
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=5)
    loss_fns, loss_weights, _ = jax_losses.build_all_losses(jcfg, jreg)
    jparams = {"model": jax.tree_util.tree_map(jnp.asarray, params)}
    tx = jax_build_optimizer(jcfg, jparams)
    state = TrainState(
        step=jnp.asarray(0, jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        grad_accum=jax.tree_util.tree_map(jnp.zeros_like, jparams))
    cfg = Config(config_dict=jcfg.config)
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu")
    load_jax_params(model, params)
    trainer = Trainer(cfg, model, reg, device="cpu", seed=0)
    names = [n for n, _ in model.named_parameters()]
    steps = []
    for i, ttype in enumerate(ORDER):
        batch = train_batch_np(np.random.RandomState(4 + i), ttype, reg)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        jbefore = _host(state.params["model"])
        step = make_train_step(jmodel, tx, jcfg, jreg, ttype, loss_fns,
                               loss_weights)[0]
        state, jlogs = step(
            state, jnp.asarray(batch["image"]), jnp.asarray(batch["label"]),
            jnp.int32(batch["task_index"]), jnp.float32(LR),
            jnp.float32(1.0), jax.random.PRNGKey(0),
            jnp.asarray((i + 1) % 2 == 0))
        logs = trainer.train_batch(batch, epoch=0)
        steps.append(dict(
            ttype=ttype, jlogs={k: float(v) for k, v in jlogs.items()},
            logs={k: float(v) for k, v in logs.items()},
            jacc=_host(state.grad_accum["model"]),
            acc=dict(zip(names, (a.numpy().copy()
                                 for a in trainer.grad_accum))),
            jbefore=jbefore, jafter=_host(state.params["model"]),
            before={n: t.numpy() for n, t in before.items()},
            after={n: p.detach().numpy().copy()
                   for n, p in model.named_parameters()}))
    return dict(steps=steps, trainer=trainer, model=model)


def _leafwise(got, ref, tol=1e-4):
    assert set(got) == set(ref)
    bad = []
    for name, r in ref.items():
        top = float(np.abs(r).max())
        err = float(np.abs(got[name] - r).max())
        if not err <= tol * top:
            bad.append((name, err, top))
    assert not bad, bad[:5]


def test_the_ablation_a_options_are_built(run):
    model, trainer = run["model"], run["trainer"]
    assert type(model.head_banks_segmentation).__name__ == (
        "DeepSupervisionSegHeadBank")
    assert type(model.head_banks_detection).__name__ == (
        "GridDetectionHeadBank")
    assert model.multi_film is not None and model.task_prompt is not None
    assert trainer.optimizer.kind == "SGD" and trainer.accum_steps == 2


@pytest.mark.parametrize("i", range(len(ORDER)))
def test_micro_step_matches_jax(run, i):
    s = run["steps"][i]
    assert set(s["logs"]) == set(s["jlogs"]) == {
        "total_loss", "raw_loss", "task_weight"}
    for k in ("total_loss", "raw_loss"):
        assert abs(s["logs"][k] - s["jlogs"][k]) <= 1e-5 * abs(
            s["jlogs"][k]), (k, s)
    if i % 2 == 0:
        # an odd micro-step: grads / 2 accumulated, params untouched
        _leafwise(s["acc"], s["jacc"])
        assert any(np.abs(a).max() > 0 for a in s["acc"].values())
        for n, a in s["after"].items():
            np.testing.assert_array_equal(a, s["before"][n], err_msg=n)
    else:
        # an update from two types' grads, accumulator zeroed
        assert all(not a.any() for a in s["acc"].values())
        assert all(not a.any() for a in s["jacc"].values())
        bad = []
        for n, ref in s["jafter"].items():
            change = float(np.abs(ref - s["jbefore"][n]).max())
            err = np.abs(s["after"][n] - ref)
            if not (err <= 1e-4 * change + 2 * np.spacing(np.abs(ref))).all():
                bad.append((n, float(err.max()), change))
        assert not bad, bad[:5]
        # SGD + decay moves every leaf
        assert all(not np.array_equal(s["after"][n], s["before"][n])
                   for n in s["after"])


def test_counts_after_the_run(run):
    trainer = run["trainer"]
    assert trainer.optimizer.count == 2  # updates only
    assert trainer.host_step == 4  # every micro-step
    assert trainer._micro_step == 4
    with pytest.raises(NotImplementedError, match="accumulation"):
        trainer.train_burst({}, 2)


class _Tiny(nn.Module):
    def __init__(self, enc, head):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.w = nn.Parameter(torch.from_numpy(enc.copy()))
        self.head_banks_x = nn.Module()
        self.head_banks_x.w = nn.Parameter(torch.from_numpy(head.copy()))


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_optimizer_matches_optax(opt):
    """Grouped LR (encoder x0.1, heads x1), weight decay 0.05 (SGD adds
    it after the momentum trace; Adam drops it): params after 3 steps."""
    jcfg = make_tiny_config(training={"optimizer": {
        "type": opt, "momentum": 0.8, "weight_decay": 0.05}})
    rng = np.random.RandomState(1)
    enc = rng.standard_normal((8, 5)).astype(np.float32)
    head = rng.standard_normal(6).astype(np.float32)
    jparams = {"model": {"encoder": {"w": jnp.asarray(enc)},
                         "head_banks_x": {"w": jnp.asarray(head)}}}
    tx = jax_build_optimizer(jcfg, jparams)
    opt_state = tx.init(jparams)
    model = _Tiny(enc, head)
    optimizer = build_optimizer(Config(config_dict=jcfg.config), model)
    for lr in (1e-2, 5e-3, 2e-3):
        ge = rng.standard_normal(enc.shape).astype(np.float32)
        gh = rng.standard_normal(head.shape).astype(np.float32)
        jg = {"model": {"encoder": {"w": jnp.asarray(ge)},
                        "head_banks_x": {"w": jnp.asarray(gh)}}}
        upd, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(
            jparams, jax.tree_util.tree_map(lambda u: -lr * u, upd))
        model.encoder.w.grad = torch.from_numpy(ge)
        model.head_banks_x.w.grad = torch.from_numpy(gh)
        optimizer.step(lr)
    for got, ref in ((model.encoder.w, jparams["model"]["encoder"]["w"]),
                     (model.head_banks_x.w,
                      jparams["model"]["head_banks_x"]["w"])):
        ref = np.asarray(ref)
        err = np.abs(got.detach().numpy() - ref)
        assert err.max() <= 1e-6 * np.abs(ref).max(), (opt, err.max())
    state = optimizer.state_dict()
    assert state["kind"] == opt and state["count"] == 3
    assert set(state) == ({"kind", "count", "trace"} if opt == "SGD"
                          else {"kind", "count", "mu", "nu"})


@pytest.mark.parametrize("heads,loss", [
    ({"detection": {"type": "grid"}}, "CenterNet"),
    ({"use_baseline": True}, "CenterNet"),
    ({"detection": {"type": "centernet"}}, "Detection"),
])
def test_detection_head_loss_mismatch_raises(heads, loss):
    cfg = Config(config_dict=make_tiny_config(
        model={"encoder": {"name": "swin_nano", "window_size": 8},
               "heads": heads},
        training={"loss_configs": {"detection": {"type": loss}}}).config)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="head/loss mismatch"):
        Trainer(cfg, model, device="cpu")
