"""The parallel modes' rules, port against the JAX package on the same
trees and mesh shapes: tensor-parallel specs (through the weight bridge's
[out, in] transpose), ZeRO-1 specs and the sharded fraction, the MoE's
capacity and dispatch pick, the mesh a config asks for, the
single-process ``init_distributed`` no-op; and the activation mesh scope
(a mesh Trainer leaves nothing installed)."""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fmc_uia_tpu import parallel as JP
from fmc_uia_tpu.config import Config as JConfig
from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch import parallel as P
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.parallel.distributed import mesh_shape_from_config
from fmc_uia_tpu_torch.parallel.sharding import _KERNEL_PERM
from fmc_uia_tpu_torch.parallel.zero import zero_dims
from fmc_uia_tpu_torch.train import build_optimizer
from helpers import make_tiny_config
from torch_port_utils import MOE_OVERRIDES, TRAIN_OVERRIDES


class _FakeMesh:
    """What the port's rules read of a DeviceMesh: names and sizes."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


def _jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


def _unrolled(overrides):
    d = copy.deepcopy(overrides)
    d["model"]["encoder"] = dict(d["model"]["encoder"], scan_stages=[])
    return d


@pytest.fixture(scope="module", params=["train", "moe"])
def trees(request):
    """(JAX param shapes by '/' path, the port model) of one tiny
    config, the JAX stages unrolled so paths map one to one."""
    over = _unrolled(TRAIN_OVERRIDES if request.param == "train"
                     else MOE_OVERRIDES)
    jcfg = make_tiny_config(**over)
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    x0 = jax.numpy.zeros((1, 64, 64, 3), jax.numpy.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), x0, method=JaxModel.init_all))["params"]
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(Config(config_dict=jcfg.config), device="cpu")
    return shapes, flat, model, jcfg


def _port_spec(path, jspec, ndim):
    """A JAX spec carried into the port's layout (``()``: replicated)."""
    full = list(jspec) + [None] * (ndim - len(jspec))
    if not any(full):
        return ()
    if path.endswith("/kernel") and ndim in _KERNEL_PERM:
        return tuple(full[j] for j in _KERNEL_PERM[ndim])
    return tuple(full)


def test_tp_spec_for_path_matches_jax():
    paths = ["encoder/stage0_block0/attn/qkv/kernel",
             "encoder/stage2_block3/mlp_fc1/kernel",
             "encoder/stage2_block3/mlp_fc2/kernel",
             "encoder/stage1_block0/attn/proj/kernel",
             "encoder/stage1_block0/attn/proj/bias",
             "encoder/stage0_block1/pwconv1/kernel",
             "moe_stage2/expert_in/kernel", "moe_stage2/expert_out/kernel",
             "decoder/lateral0/kernel"]
    for path in paths:
        for ndim in (1, 2, 4):
            want = tuple(JP.tp_spec_for_path(path, ndim))
            assert P.tp_spec_for_path(path, ndim) == want, (path, ndim)


@pytest.mark.parametrize("min_dim", [16, 256])
def test_make_param_specs_matches_jax(trees, min_dim):
    """The same sharded leaves, on the same dimension carried through the
    bridge's re-layout (JAX's last dim of a Dense kernel is the port's dim
    0)."""
    shapes, flat, model, _ = trees
    jspecs = JP.make_param_specs(shapes, min_shard_dim=min_dim)
    jflat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
             for p, v in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: isinstance(
                     x, jax.sharding.PartitionSpec))[0]}
    got = P.make_param_specs(model, min_shard_dim=min_dim)
    assert set(got) == {p.replace("/", ".") for p in jflat}
    n_sharded = 0
    for path, spec in jflat.items():
        want = _port_spec(path, tuple(spec), len(flat[path].shape))
        assert got[path.replace("/", ".")] == want, path
        n_sharded += bool(want)
    assert n_sharded > 0


@pytest.mark.parametrize("axes", [dict(data=2, model=1),
                                  dict(data=4, model=2),
                                  dict(data=2, model=2), dict(data=1)])
def test_zero_spec_for_leaf_matches_jax(trees, axes):
    shapes, flat, model, _ = trees
    jm, pm = _jmesh(**axes), _FakeMesh(**axes)
    params = dict(model.named_parameters())
    for path, leaf in flat.items():
        want = JP.zero_spec_for_leaf(path, np.zeros(leaf.shape, np.int8),
                                     jm)
        got = P.zero_spec_for_leaf(path.replace("/", "."),
                                   params[path.replace("/", ".")].shape, pm)
        assert got == _port_spec(path, tuple(want), len(leaf.shape)), path


def test_zero_sharded_fraction_matches_jax(trees):
    """The share of the optimizer state's bytes ZeRO-1 shards over a data
    axis of 2: the JAX package's placed optax state against the port's
    optimizer cut to rank 0's slices."""
    from fmc_uia_tpu.train import build_optimizer as jax_build_optimizer

    shapes, flat, model, jcfg = trees
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    tx = jax_build_optimizer(jcfg, {"model": params})
    jstate = JP.shard_opt_state(tx.init({"model": params}),
                                _jmesh(data=2))
    want = JP.zero_sharded_fraction(jstate)
    opt = build_optimizer(Config(config_dict=jcfg.config), model)
    dims = zero_dims({n: p.shape for n, p in model.named_parameters()},
                     _FakeMesh(data=2))
    index = {id(p): n for n, p in model.named_parameters()}

    def slice_of(p):
        d = dims.get(index[id(p)])
        return None if d is None else (d, 0, p.shape[d] // 2)

    opt.shard(slice_of)
    got = P.zero_sharded_fraction(opt)
    assert 0.5 < want < 1.0
    assert abs(got - want) <= 1e-3, (got, want)


def test_default_capacity_and_dispatch_pick_match_jax():
    from fmc_uia_tpu.models.conditioning import pick_dispatch_mode as jpick
    from fmc_uia_tpu.parallel.expert import default_capacity as jcap
    from fmc_uia_tpu_torch.models.conditioning import pick_dispatch_mode

    for args in [(4, 8, 2, 2.0), (32, 8, 2, 1.0), (3, 4, 1, 0.5),
                 (64, 32, 2, 2.0), (1, 64, 1, 0.1)]:
        assert P.default_capacity(*args) == jcap(*args)
    for axes in (None, dict(model=1), dict(model=2), dict(data=2, model=4),
                 dict(data=8)):
        for E, k in ((8, 2), (32, 2), (32, 4), (64, 8), (48, 1), (6, 1)):
            jm = None if axes is None else _jmesh(**axes)
            pm = None if axes is None else _FakeMesh(**axes)
            assert pick_dispatch_mode(E, k, pm, "model") == jpick(
                E, k, jm, "model"), (axes, E, k)


@pytest.mark.parametrize("spec", [{"data": -1}, {"data": -1, "model": 2},
                                  {"data": 2, "model": -1},
                                  {"model": 4, "data": 2}])
def test_mesh_from_config_matches_jax(spec):
    """The axis names and sizes ``parallel.mesh`` asks for over 8
    devices (JAX's virtual CPU devices, the port's ranks)."""
    d = copy.deepcopy(make_tiny_config().config)
    d["parallel"] = {"mesh": spec}
    jm = JP.mesh_from_config(JConfig(config_dict=d))
    names, sizes = mesh_shape_from_config(Config(config_dict=d), 8)
    assert names == tuple(jm.axis_names)
    assert sizes == tuple(jm.devices.shape)
    assert P.mesh_from_config(Config(config_dict=make_tiny_config(
    ).config)) is None


def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    cfg = Config(config_dict=make_tiny_config().config)
    assert P.init_distributed(cfg) is False
    assert JP.init_distributed(JConfig(config_dict=cfg.config)) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert P.init_distributed(cfg) is False
    assert not torch.distributed.is_initialized()


def test_activation_mesh_scope_nests_and_restores():
    assert P.activation_mesh() is None
    a, b = _FakeMesh(data=2), _FakeMesh(model=2)
    with P.activation_mesh_scope(a):
        assert P.activation_mesh() is a
        with P.activation_mesh_scope(b):
            assert P.activation_mesh() is b
        assert P.activation_mesh() is a
    assert P.activation_mesh() is None
    x = torch.ones(2, 3)
    assert P.shard_activation(x, "data") is x
    assert P.shard_batch_activation(x) is x
