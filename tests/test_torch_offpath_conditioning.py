"""The port's task conditioning against the JAX package's, with the same
seeded numpy weights bridged into both: ``TaskFiLM`` and
``TaskEmbeddingFiLM`` (with and without the affine beta), ``MultiFiLM``
over four stages of different widths, the task-prompt metadata table and
tokeniser, ``TaskPrompt2D`` in 'add' and 'mul' mode (one channel and
three, an upsample and a shrink), and the whole model with the prompt
scoped to some task types and unscoped.

Tolerances: the metadata table bitwise; module and model outputs within
1e-5 of their largest magnitude (f32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models import conditioning as JC
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.flagship import flagship_config_dict
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.models import conditioning as PC
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.utils.convert import load_jax_params
from helpers import make_tiny_config
from torch_port_utils import random_like_tree

NT = 5  # tasks


def _close(got, ref, rel=1e-5):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err


def _pair(jmod, pmod, args, seed=3):
    """Init the flax module on ``args``, bridge seeded weights into the
    port module; returns the params."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *args))["params"]
    params = random_like_tree(shapes, seed=seed)
    load_jax_params(pmod, params)
    return params


@pytest.mark.parametrize("embedding", [False, True])
@pytest.mark.parametrize("affine", [True, False])
def test_film_matches_jax(embedding, affine):
    C = 24
    if embedding:
        jmod = JC.TaskEmbeddingFiLM(NT, C, embedding_dim=16,
                                    use_affine=affine)
        pmod = PC.TaskEmbeddingFiLM(NT, C, embedding_dim=16,
                                    use_affine=affine)
    else:
        jmod = JC.TaskFiLM(NT, C, use_affine=affine)
        pmod = PC.TaskFiLM(NT, C, use_affine=affine)
    x = np.random.RandomState(0).standard_normal(
        (2, 4, 4, C)).astype(np.float32)
    params = _pair(jmod, pmod, (jnp.asarray(x), jnp.int32(0)))
    for t in range(NT):
        ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.int32(t))
        with torch.no_grad():
            got = pmod(torch.from_numpy(x), torch.tensor(t))
        _close(got, ref)


@pytest.mark.parametrize("embedding", [False, True])
def test_multi_film_matches_jax(embedding):
    chans = (8, 16, 32, 64)
    rng = np.random.RandomState(1)
    feats = [rng.standard_normal((2, 16 >> i, 16 >> i, c)).astype(
        np.float32) for i, c in enumerate(chans)]
    jmod = JC.MultiFiLM(NT, chans, use_embedding=embedding,
                        embedding_dim=8)
    pmod = PC.MultiFiLM(NT, chans, use_embedding=embedding,
                        embedding_dim=8)
    params = _pair(jmod, pmod, ([jnp.asarray(f) for f in feats],
                                jnp.int32(0)))
    assert sorted(params) == [f"stage{i}" for i in range(4)]
    ref = jmod.apply({"params": params}, [jnp.asarray(f) for f in feats],
                     jnp.int32(3))
    with torch.no_grad():
        got = pmod([torch.from_numpy(f) for f in feats], torch.tensor(3))
    for a, b in zip(got, ref):
        _close(a, b)
    with pytest.raises(ValueError, match="stages"):
        pmod([torch.from_numpy(f) for f in feats[:3]], torch.tensor(0))


@pytest.mark.parametrize("tid", ["T2A_fetal_abdomen", "t4b_x", "T10",
                                 "a__B_c", "T5_fetal_femur_T3"])
def test_tokenize_task_id(tid):
    assert PC._tokenize_task_id(tid) == JC._tokenize_task_id(tid)


def test_metadata_table_bitwise():
    tasks = flagship_config_dict()["tasks"] + [
        {"task_id": "T9z_extra_thing", "task_name": "Regression",
         "num_classes": 7}, {"task_id": "odd", "task_name": "Unknown"}]
    ref = JC.build_task_prompt_metadata(tasks)
    got = PC.build_task_prompt_metadata(tasks)
    assert got[0].dtype == ref[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] and got[2] == ref[2]


@pytest.mark.parametrize("mode", ["add", "mul"])
@pytest.mark.parametrize("channels,size", [(1, 64), (3, 64), (1, 16)])
def test_task_prompt_matches_jax(mode, channels, size):
    tasks = flagship_config_dict()["tasks"][:: 4]
    table = JC.build_task_prompt_metadata(tasks)[0]
    kw = dict(out_channels=channels, prompt_size=32, inject_mode=mode,
              init_scale=0.1, use_tanh=True)
    jmod = JC.TaskPrompt2D(metadata_table=table, **kw)
    pmod = PC.TaskPrompt2D(table, **kw)
    x = np.random.RandomState(2).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    params = _pair(jmod, pmod, (jnp.asarray(x), jnp.int32(0)))
    for t in (0, 3, len(tasks) - 1):
        ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.int32(t))
        with torch.no_grad():
            got = pmod(torch.from_numpy(x), torch.tensor(t))
        _close(got, ref)
        assert not np.array_equal(got.numpy(), x)


def test_build_task_prompt_config():
    cfg = Config(config_dict=make_tiny_config(model={"task_prompt": {
        "enabled": True, "inject_mode": "MUL", "channels": 2,
        "prompt_size": 8, "init_scale": 0.5}}).config)
    reg = TaskRegistry.from_config(cfg)
    p = PC.build_task_prompt(cfg, reg.to_task_configs())
    assert (p.inject_mode, p.out_channels, p.prompt_size) == ("mul", 2, 8)
    assert p.prompt_scale.dim() == 0
    assert float(p.prompt_scale.detach()) == 0.5
    bad = Config(config_dict=make_tiny_config(model={"task_prompt": {
        "enabled": True, "inject_mode": "concat"}}).config)
    with pytest.raises(ValueError, match="inject_mode"):
        PC.build_task_prompt(bad, reg.to_task_configs())
    off = Config(config_dict=make_tiny_config().config)
    assert PC.build_task_prompt(off, reg.to_task_configs()) is None


# the whole model: the prompt on the input of the named types only, the
# embedding FiLM on the FPN and on every encoder stage
MODEL_OVERRIDES = {"model": {
    "encoder": {"name": "swin_nano", "window_size": 8},
    "use_film": True,
    "film": {"use_task_embedding": True, "multi_stage": True,
             "embedding_dim": 16},
    "task_prompt": {"enabled": True, "inject_mode": "mul",
                    "apply_to_task_names": ["Segmentation", "regression"]}}}
TASKS = {"T2B_organ_b": "segmentation", "T1_planes": "classification",
         "T4_box": "detection", "T5_points": "Regression"}


@pytest.fixture(scope="module")
def model_pair():
    jcfg = make_tiny_config(**MODEL_OVERRIDES)
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), x0, method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=4)
    params["task_prompt"]["prompt_scale"] = np.float32(0.5)
    cfg = Config(config_dict=jcfg.config)
    model = build_model(cfg, TaskRegistry.from_config(cfg), device="cpu")
    load_jax_params(model, params)
    x = np.random.RandomState(5).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    return jmodel, params, model, x


@pytest.mark.parametrize("task_id", list(TASKS))
def test_model_with_scoped_prompt_matches_jax(model_pair, task_id):
    jmodel, params, model, x = model_pair
    ttype = TASKS[task_id]
    gidx = model.registry[task_id].global_index
    ref = jax.jit(lambda p, x, i: jmodel.apply({"params": p}, x, ttype, i))(
        params, jnp.asarray(x), jnp.int32(gidx))
    with torch.no_grad():
        got = model(torch.from_numpy(x), ttype, torch.tensor(gidx))
        prompt = model.task_prompt
        model.task_prompt = None  # the same model without the prompt
        bare = model(torch.from_numpy(x), ttype, torch.tensor(gidx))
        model.task_prompt = prompt
    if ttype == "detection":
        for k in ref:
            _close(got[k], ref[k])
        got, bare = got["heatmap"], bare["heatmap"]
    else:
        _close(got, ref)
    # 'Segmentation' and 'regression' match their types in lower case
    scoped = ttype.lower() in ("segmentation", "regression")
    assert torch.equal(got, bare) != scoped
