"""The port's train step and optimizer against the JAX package's, f32.

A whole train step on swin_micro 64², window 8, fused attention and MLP
branches (the JAX kernels in interpret mode), with the same seeded numpy
weights bridged into both: segmentation and classification here, detection
and regression in test_torch_train_det_reg.py (one JAX compile of a train
step takes ~20 s on the CPU, so the four types are split over two files).
Augmentation, dropout and drop path are off by config, so both sides are
deterministic. The JAX side is the package's own step
(``train.make_train_step``) with an optax transformation that keeps the
step's gradients (after the clip) as its state instead of updating; the
port side is ``Trainer.compute_grads`` (torch_port_utils.train_step_pair).

Tolerances: the total loss and the grad norm within 1e-5 relative; every
gradient leaf within 1e-4 of its largest magnitude (f32 through the
encoder, FPN, head, loss and their pullbacks, summed in another order).
The weights come from a seed where no ReLU input sits at its kink, so both
sides take the same side of every ReLU (see train_step_pair).
The optimizer: the same grads fed to both sides for 3 steps, params within
1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from fmc_uia_tpu.train import _clip_by_global_norm
from fmc_uia_tpu.train import build_optimizer as jax_build_optimizer
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.train import Trainer, build_optimizer
from helpers import make_tiny_config
from torch_port_utils import TRAIN_OVERRIDES, check_train_step, train_step_pair

TYPES = ("segmentation", "classification")


@pytest.fixture(scope="module")
def pair():
    return train_step_pair(TYPES)


@pytest.mark.parametrize("ttype", TYPES)
def test_train_step_matches_jax(pair, ttype):
    check_train_step(pair[ttype])


class _Tiny(nn.Module):
    def __init__(self, enc, head):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.w = nn.Parameter(torch.from_numpy(enc.copy()))
        self.head_banks_x = nn.Module()
        self.head_banks_x.w = nn.Parameter(torch.from_numpy(head.copy()))


def test_optimizer_matches_optax():
    """Grouped LR (encoder x0.1, heads x1, adaptive log-var at its own
    LR), weight decay and the model-only clip: params after 3 steps."""
    jcfg = make_tiny_config(training={
        "optimizer": {"weight_decay": 0.05},
        "adaptive_loss": {"enabled": True, "learning_rate": 5e-3}})
    rng = np.random.RandomState(0)
    enc = rng.standard_normal((8, 5)).astype(np.float32)
    head = rng.standard_normal(6).astype(np.float32)
    lv = np.float32(-1.0)
    jparams = {"model": {"encoder": {"w": jnp.asarray(enc)},
                         "head_banks_x": {"w": jnp.asarray(head)}},
               "adaptive": {"segmentation": jnp.asarray(lv)}}
    tx = jax_build_optimizer(jcfg, jparams)
    opt_state = tx.init(jparams)

    model = _Tiny(enc, head)
    adaptive = nn.ParameterDict(
        {"segmentation": nn.Parameter(torch.tensor(lv))})
    opt = build_optimizer(Config(config_dict=jcfg.config), model, adaptive)
    for step, lr in enumerate((1e-2, 5e-3, 2e-3)):
        ge = rng.standard_normal(enc.shape).astype(np.float32) * 3
        gh = rng.standard_normal(head.shape).astype(np.float32)
        ga = np.float32(rng.standard_normal())
        jg = {"model": {"encoder": {"w": jnp.asarray(ge)},
                        "head_banks_x": {"w": jnp.asarray(gh)}},
              "adaptive": {"segmentation": jnp.asarray(ga)}}
        clipped, _ = _clip_by_global_norm(jg["model"], 1.0)
        jg = dict(jg, model=clipped)
        upd, opt_state = tx.update(jg, opt_state, jparams)
        upd = jax.tree_util.tree_map(lambda u: -lr * u, upd)
        jparams = optax.apply_updates(jparams, upd)

        model.encoder.w.grad = torch.from_numpy(ge)
        model.head_banks_x.w.grad = torch.from_numpy(gh)
        adaptive["segmentation"].grad = torch.tensor(ga)
        norm = torch.nn.utils.clip_grad_norm_(list(model.parameters()), 1.0)
        assert float(norm) > 1.0  # the clip acts
        opt.step(lr)
    pairs = ((model.encoder.w, jparams["model"]["encoder"]["w"]),
             (model.head_banks_x.w, jparams["model"]["head_banks_x"]["w"]),
             (adaptive["segmentation"], jparams["adaptive"]["segmentation"]))
    for got, ref in pairs:
        ref = np.asarray(ref)
        err = np.abs(got.detach().numpy() - ref)
        assert (err <= 1e-6 * np.abs(ref)).all(), (err.max(), ref)


def test_trainer_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal is for hosts without one")
    cfg = Config(config_dict=make_tiny_config(**TRAIN_OVERRIDES).config)
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, model, reg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, model, reg)  # the default device is the card
