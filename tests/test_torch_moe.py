"""The port's dense MoE conv block and the MoE model against the JAX
package's, with the same seeded numpy weights bridged into both; the
submit and baseline preset dicts against their YAML files; the dispatch
modes.

Tolerances (f32): the block's output within 1e-5 of its largest magnitude
(three convolutions and a gated sum, f32 sums in another order), the
balance loss within 1e-5 relative, importance within 1e-6 (f32 softmax and
a mean over the batch), load equal (the same top-k, no near tie in these
draws: the 2nd and 3rd probabilities of every row are asserted apart).
bf16 compute: the output within 2 bf16 ulps of its largest magnitude (each
convolution rounds its f32 sums to bf16 once on both sides; a sum in
another order may round one ulp apart, and the gated sum of E experts and
the residual add one rounding each); the router runs in f32 on the pooled
feature rounded to bf16 on both sides, so aux, importance and load keep
the f32 tolerances. The model: raw outputs within 2e-5 of their largest
magnitude, as tests/test_torch_model.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.conditioning import MoEConvBlock as JaxMoE
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.models.conditioning import (
    MoEConvBlock,
    top_k_dispatch,
)
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.utils.convert import (
    jax_leaves_to_port,
    load_jax_params,
)
from helpers import make_tiny_config
from torch_port_utils import (
    MOE_OVERRIDES,
    SEPARATE_FPN_OVERRIDES,
    random_like_tree,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, C, HID, T = 4, 24, 8, 5
# name: (compute dtype, top_k, task embedding, residual, dropout)
BLOCK_CASES = {
    "f32_top2": ("float32", 2, True, True, 0.0),
    "f32_top_all": ("float32", E, True, True, 0.0),
    "f32_top1_plain": ("float32", 1, False, False, 0.0),
    "f32_dropout_eval": ("float32", 2, True, True, 0.5),
    "bf16_top2": ("bfloat16", 2, True, True, 0.0),
    "bf16_top_all_plain": ("bfloat16", E, False, False, 0.0),
}


def _block_pair(case):
    dt, k, emb, res, drop = BLOCK_CASES[case]
    kw = dict(num_experts=E, expert_hidden=HID, router_hidden=16, top_k=k,
              use_task_embedding=emb, task_embedding_dim=6, num_tasks=T,
              use_residual=res, dropout=drop)
    jblock = JaxMoE(dtype=getattr(jnp, dt), **kw)
    rng = np.random.RandomState(7)
    x = rng.standard_normal((6, 5, 7, C)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dt))
    tidx = jnp.int32(3)
    shapes = jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), xj, tidx))["params"]
    params = random_like_tree(shapes, seed=2)
    jout, jaux, jstats = jblock.apply({"params": params}, xj, tidx)
    block = MoEConvBlock(C, dtype=getattr(torch, dt), **kw)
    load_jax_params(block, params)
    xt = torch.from_numpy(x).to(getattr(torch, dt))
    with torch.no_grad():
        out, aux, stats = block(xt, torch.tensor(3))
        probs = block.gate_probs(xt, torch.tensor(3))
    return dict(jout=np.asarray(jout.astype(jnp.float32)), jaux=float(jaux),
                jstats={n: np.asarray(v) for n, v in jstats.items()},
                out=out.float().numpy(), aux=float(aux),
                stats={n: v.numpy() for n, v in stats.items()},
                probs=probs.numpy(), dtype=dt, top_k=k)


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_moe_block_matches_jax(case):
    r = _block_pair(case)
    if r["top_k"] < E:  # the choice is not at a near tie
        srt = np.sort(r["probs"], axis=1)[:, ::-1]
        gap = srt[:, r["top_k"] - 1] - srt[:, r["top_k"]]
        assert gap.min() > 1e-4, gap.min()
    top = float(np.abs(r["jout"]).max())
    err = float(np.abs(r["out"] - r["jout"]).max())
    if r["dtype"] == "float32":
        assert err <= 1e-5 * top, (err, top)
    else:
        assert err <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7), (err, top)
    assert abs(r["aux"] - r["jaux"]) <= 1e-5 * abs(r["jaux"])
    assert np.abs(r["stats"]["importance"]
                  - r["jstats"]["importance"]).max() <= 1e-6
    np.testing.assert_array_equal(r["stats"]["load"], r["jstats"]["load"])
    assert abs(float(r["stats"]["importance"].sum()) - 1.0) <= 1e-5
    assert abs(float(r["stats"]["load"].sum()) - r["top_k"]) <= 1e-6


def test_moe_block_grads_match_jax():
    """Grads of sum(out * w) + 0.05 * aux in f32 (top-2 of 4, task
    embedding, residual) for every parameter and the input, on inputs whose
    samples pick different experts, so that the balance loss has a
    gradient: every leaf within 1e-5 of its largest magnitude (f32 sums in
    another order; the router's sums here are short and do not cancel)."""
    kw = dict(num_experts=E, expert_hidden=HID, router_hidden=16, top_k=2,
              use_task_embedding=True, task_embedding_dim=6, num_tasks=T)
    jblock = JaxMoE(**kw)
    rng = np.random.RandomState(11)
    # a per-sample offset moves each sample's pooled feature, its routing
    x = (rng.standard_normal((6, 5, 7, C))
         + 2.0 * rng.standard_normal((6, 1, 1, C))).astype(np.float32)
    w = rng.standard_normal((6, 5, 7, C)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.int32(3)))["params"]
    params = random_like_tree(shapes, seed=4)

    def jloss(p, xx):
        out, aux, _ = jblock.apply({"params": p}, xx, jnp.int32(3))
        return jnp.sum(out * w) + 0.05 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    _, _, jstats = jblock.apply({"params": params}, jnp.asarray(x),
                                jnp.int32(3))
    load = np.asarray(jstats["load"])
    assert ((load > 0) & (load < 1)).any() and (load == 1).any(), load
    block = MoEConvBlock(C, **kw)
    load_jax_params(block, params)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux, _ = block(xt, torch.tensor(3))
    ((out * torch.from_numpy(w)).sum() + 0.05 * aux).backward()
    ref = jax_leaves_to_port(jax.tree_util.tree_map(np.asarray, jg))
    ref["x"] = np.asarray(jgx)
    got = {n: p.grad.numpy() for n, p in block.named_parameters()}
    got["x"] = xt.grad.numpy()
    assert set(got) == set(ref)
    for name, r in ref.items():
        err = float(np.abs(got[name] - r).max())
        assert err <= 1e-5 * float(np.abs(r).max()), (name, err)


def test_top_k_dispatch_breaks_ties_as_jax():
    """Equal probabilities: the lower expert index wins, as
    jax.lax.top_k decides."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.2, 0.2, 0.1, 0.5]], np.float32)
    for k in (1, 2, 3):
        _, idx = jax.lax.top_k(jnp.asarray(probs), k)
        want = np.asarray(jnp.sum(jax.nn.one_hot(idx, 4), axis=1))
        got = top_k_dispatch(torch.from_numpy(probs), k).numpy()
        np.testing.assert_array_equal(got, want)


def test_moe_dispatch_modes():
    """'auto' resolves as the JAX rule does without an expert-parallel
    mesh (dense); every mode builds the same blocks; 'ragged' without an
    expert-parallel mesh raises JAX's ValueError at the forward, and
    'auto' then runs dense (equal to 'dense')."""
    from fmc_uia_tpu.models.conditioning import pick_dispatch_mode as jpick
    from fmc_uia_tpu_torch.models.conditioning import pick_dispatch_mode

    def cfg(mode):
        d = make_tiny_config(**MOE_OVERRIDES).config
        d["model"]["moe"]["dispatch"] = mode
        return Config(config_dict=d)

    moe = MOE_OVERRIDES["model"]["moe"]
    for E, k in ((moe["num_experts"], moe["top_k"]), (32, 2), (64, 8)):
        assert pick_dispatch_mode(E, k, None, "model") == jpick(
            E, k, None, "model") == "dense"
    models = {m: build_model(cfg(m), device="cpu")
              for m in ("dense", "auto", "ragged")}
    for m in models.values():
        assert m.moe_stages == [2, 3]
        m.load_state_dict(models["dense"].state_dict())
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    tidx = torch.tensor(0)
    with pytest.raises(ValueError, match="needs ep_mesh"):
        models["ragged"](x, "segmentation", tidx)
    torch.testing.assert_close(models["auto"](x, "segmentation", tidx),
                               models["dense"](x, "segmentation", tidx),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["submit", "baseline"])
def test_preset_dict_equals_yaml(name):
    from fmc_uia_tpu_torch import flagship

    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        want = yaml.safe_load(f)
    d = getattr(flagship, f"{name}_config_dict")()
    assert d == want
    cfg = Config(config_dict=d)
    assert cfg.image_size == 224 and cfg.batch_size == 64
    assert cfg.get("model.moe.enabled") is True
    assert len(cfg.get_task_configs()) == 27


# ---------------------------------------------------------------------------
# the MoE model, and the baseline preset's separate cls/reg FPNs
# ---------------------------------------------------------------------------
TASKS = {"T2B_organ_b": "segmentation", "T1_planes": "classification",
         "T4_box": "detection", "T5_points": "Regression"}


def _model_pair(overrides):
    jcfg = make_tiny_config(**overrides)
    d = jcfg.config
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=0)
    cfg = Config(config_dict=d)
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu")
    load_jax_params(model, params)
    x = np.random.RandomState(1).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    return jmodel, params, model, reg, x


@pytest.fixture(scope="module")
def moe_pair():
    return _model_pair(MOE_OVERRIDES)


@pytest.fixture(scope="module")
def separate_pair():
    return _model_pair(SEPARATE_FPN_OVERRIDES)


def _check_forward(pair, task_id, ttype):
    jmodel, params, model, reg, x = pair
    gidx = reg[task_id].global_index
    jout, mut = jmodel.apply({"params": params}, jnp.asarray(x), ttype,
                             jnp.int32(gidx), mutable=["intermediates"])
    with torch.no_grad():
        out, inter = model(torch.from_numpy(x), ttype, torch.tensor(gidx),
                           return_intermediates=True)
    outs = (out if isinstance(out, dict) else {"out": out})
    jouts = (jout if isinstance(jout, dict) else {"out": jout})
    assert set(outs) == set(jouts)
    for k in jouts:
        ref = np.asarray(jouts[k], np.float32)
        err = float(np.abs(outs[k].numpy() - ref).max())
        assert err <= 2e-5 * max(float(np.abs(ref).max()), 1.0), (k, err)
    return inter, mut["intermediates"]


@pytest.mark.parametrize("task_id", list(TASKS))
def test_moe_model_forward_matches_jax(moe_pair, task_id):
    inter, jint = _check_forward(moe_pair, task_id, TASKS[task_id])
    assert len(inter["moe_aux"]) == 2
    for key, tol in (("moe_aux", 1e-5), ("moe_importance", 1e-6),
                     ("moe_load", 0.0)):
        ref = [np.asarray(v, np.float32) for v in jint[key]]
        got = [v.numpy() for v in inter[key]]
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert np.abs(g - r).max() <= tol * max(1.0, np.abs(r).max())


@pytest.mark.parametrize("task_id", ["T1_planes", "T5_points"])
def test_separate_cls_reg_fpns_forward_matches_jax(separate_pair, task_id):
    model = separate_pair[2]
    alias = model.decoder_alias[TASKS[task_id]]
    assert alias in ("fpn_cls", "fpn_reg")
    _check_forward(separate_pair, task_id, TASKS[task_id])
