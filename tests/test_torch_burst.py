"""``Trainer.train_burst``: n optimizer steps on one batch, on the
segmentation type with the options of ``flagship.ablation_a_config_dict``
at a tiny width but no accumulation (``ABLATION_A_OVERRIDES`` with
``accumulation_steps`` 1: a deep-supervision head, embedding FiLM on
every stage, an additive prompt, SGD), at n = 3: against the JAX
package's ``Trainer.train_burst`` (one ``lax.scan`` program) on the same
bridged weights, and against 3 ``train_batch`` calls in the port from the
same state.

Tolerances: against JAX, the 3 losses within 1e-5 relative and the params
within 1e-4 of each leaf's largest change plus 2 f32 ulps of the param
(SGD's update is linear in the grads, which ``check_train_step`` holds to
1e-4); against the port's own steps, bitwise (the same operations in the
same order on the CPU).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu.train import Trainer as JaxTrainer
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.train import Trainer
from fmc_uia_tpu_torch.utils.convert import jax_leaves_to_port, load_jax_params
from helpers import make_tiny_config
from torch_port_utils import (
    ABLATION_A_OVERRIDES,
    random_like_tree,
    train_batch_np,
)

N = 3
TTYPE = "segmentation"


def _overrides():
    o = copy.deepcopy(ABLATION_A_OVERRIDES)
    o["training"]["accumulation_steps"] = 1
    return o


@pytest.fixture(scope="module")
def setup():
    jcfg = make_tiny_config(**_overrides())
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=5)
    cfg = Config(config_dict=jcfg.config)
    reg = TaskRegistry.from_config(cfg)
    batch = train_batch_np(np.random.RandomState(4), TTYPE, reg)
    jtrainer = JaxTrainer(jcfg, jmodel, jreg,
                          jax.tree_util.tree_map(jnp.asarray, params),
                          jax.random.PRNGKey(0))
    jout = jtrainer.train_burst(batch, N)
    return dict(cfg=cfg, reg=reg, params=params, batch=batch,
                jlosses=np.asarray(jout["losses"]),
                jlast=float(jout["total_loss"]),
                jafter=jax_leaves_to_port(jax.tree_util.tree_map(
                    np.asarray, jtrainer.state.params["model"])))


def _trainer(s):
    model = build_model(s["cfg"], s["reg"], device="cpu")
    load_jax_params(model, s["params"])
    return model, Trainer(s["cfg"], model, s["reg"], device="cpu", seed=0)


def test_burst_matches_jax(setup):
    s = setup
    model, trainer = _trainer(s)
    assert trainer.optimizer.kind == "SGD"
    out = trainer.train_burst(s["batch"], N)
    losses = out["losses"]
    assert losses.shape == (N,) and out["total_loss"] is not None
    assert float(out["total_loss"]) == float(losses[-1])
    np.testing.assert_allclose(losses.numpy(), s["jlosses"], rtol=1e-5)
    assert abs(float(out["total_loss"]) - s["jlast"]) <= 1e-5 * abs(
        s["jlast"])
    assert len(set(losses.tolist())) == N  # every step moved the params
    before = jax_leaves_to_port(s["params"])
    bad = []
    for n, p in model.named_parameters():
        ref = s["jafter"][n]
        change = float(np.abs(ref - before[n]).max())
        err = np.abs(p.detach().numpy() - ref)
        if not (err <= 1e-4 * change + 2 * np.spacing(np.abs(ref))).all():
            bad.append((n, float(err.max()), change))
    assert not bad, bad[:5]
    assert trainer.optimizer.count == N


def test_burst_equals_train_batch_steps(setup):
    s = setup
    m1, t1 = _trainer(s)
    burst = t1.train_burst(s["batch"], N)["losses"]
    m2, t2 = _trainer(s)
    steps = torch.stack([t2.train_batch(s["batch"], 0)["total_loss"]
                         for _ in range(N)])
    assert torch.equal(burst, steps)
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(t1.generator.get_state(), t2.generator.get_state())
