"""The port's ResNet encoder, its model, train step and ResNet-50
converter against the JAX package's, on the CPU, with the same seeded
numpy weights bridged into both.

- ``resnet_tiny`` (one bottleneck a stage, width 16) at 64², f32: the
  four features within 2e-5 of each one's largest magnitude, the grads of
  the input and of every leaf (one seeded cotangent) within 1e-4; bf16
  compute within 5e-2 (about 12 bf16 ulps: both sides round every conv
  output to bf16 in other orders and the GroupNorms rescale the
  difference; the JAX package's own bf16 output is 1.6-3.8e-2 from its
  f32 one on these weights), and f32 features on both sides (every
  GroupNorm returns f32).
- The model (resnet_tiny, the tiny config's FPN and heads) per task type,
  f32 within 2e-5, bf16 within 1e-1 of the largest output (the rule
  chip_smoke.py holds bf16 against f32 to: the bf16 FPN and heads add
  their roundings; the detection size map came to 5.1e-2).
- A whole train step per type (``check_train_step``: losses and the grad
  norm within 1e-5 relative, every leaf within 1e-4).
- ``convert_resnet50`` bitwise the JAX converter's on a seeded
  torchvision-layout ResNet-50; ``load_pretrained_encoder`` warns with the
  JAX package's ``UserWarning`` and returns its tree; ``--verify`` passes
  on the CPU.
"""

import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.encoders import resnet as jres
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu.utils import convert as jconv
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.models.encoders import resnet as pres
from fmc_uia_tpu_torch.utils import convert as pconv
from fmc_uia_tpu_torch.utils import timm_manifests
from helpers import make_tiny_config
from torch_port_utils import (
    check_encoder_bf16,
    check_encoder_f32,
    check_train_step,
    close_rel,
    encoder_overrides,
    port_shapes,
    random_like_tree,
    train_step_pair,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 5e-2
MODEL_BF16_TOL = 1e-1
TYPES = ("segmentation", "classification", "detection", "Regression")
TASKS = {"segmentation": "T2B_organ_b", "classification": "T1_planes",
         "detection": "T4_box", "Regression": "T5_points"}


def _x(seed=0, size=64, batch=2):
    return np.random.RandomState(seed).rand(batch, size, size, 3).astype(
        np.float32)


def test_resnet_tiny_encoder_f32_and_grads():
    check_encoder_f32(jres.resnet18_like(), pres.resnet18_like(), _x(), 1)


def test_resnet_tiny_encoder_bf16():
    dtypes = check_encoder_bf16(
        jres.ResNetEncoder(stage_sizes=(1, 1, 1, 1), width=16,
                           dtype=jnp.bfloat16),
        pres.ResNetEncoder((1, 1, 1, 1), 16, dtype=torch.bfloat16), _x(), 2,
        BF16_TOL)
    assert dtypes == [torch.float32] * 4


def test_resnet50_param_tree_and_out_channels():
    with torch.device("meta"):  # shapes only, no memory
        enc = pres.resnet50()
    shapes = jax.eval_shape(jres.resnet50().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    want = port_shapes(shapes)
    got = {n: tuple(p.shape) for n, p in enc.named_parameters()}
    assert got == want
    assert 23e6 < sum(int(np.prod(s)) for s in got.values()) < 26e6
    assert enc.out_channels == jres.resnet50().out_channels
    assert enc.out_channels == (256, 512, 1024, 2048)


@pytest.fixture(scope="module")
def model_pair():
    jcfg = make_tiny_config(model={"encoder": {"name": "resnet_tiny"}})
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                            method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=3)
    return dict(jcfg=jcfg, jreg=jreg, params=params,
                x=np.random.RandomState(4).standard_normal(
                    (2, 64, 64, 3)).astype(np.float32))


@pytest.mark.parametrize("ttype", TYPES)
def test_resnet_tiny_model_matches_jax(model_pair, ttype):
    p = model_pair
    jcfg = p["jcfg"]
    cfg = Config(config_dict=jcfg.config)
    gidx = p["jreg"][TASKS[ttype]].global_index
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jmodel = jax_build_model(jcfg, p["jreg"], dtype=jdt)
        ref = jmodel.apply({"params": p["params"]}, p["x"], ttype,
                           jnp.int32(gidx))
        model = build_model(cfg, dtype=tdt, device="cpu", init=False)
        pconv.load_jax_params(model, p["params"])
        with torch.no_grad():
            got = model(torch.from_numpy(p["x"]), ttype, gidx)
        ref = ref if isinstance(ref, dict) else {"out": ref}
        got = got if isinstance(got, dict) else {"out": got}
        assert set(got) == set(ref)
        for k in ref:
            close_rel(
                got[k], np.asarray(jnp.asarray(ref[k], jnp.float32)),
                2e-5 if tdt == torch.float32 else MODEL_BF16_TOL, f"{ttype} {k}")


@pytest.fixture(scope="module")
def step_pair():
    return train_step_pair(TYPES, overrides=encoder_overrides(
        name="resnet_tiny"))


@pytest.mark.parametrize("ttype", TYPES)
def test_resnet_tiny_train_step_matches_jax(step_pair, ttype):
    check_train_step(step_pair[ttype])


def _resnet50_sd(seed=0):
    """A seeded torchvision-layout ResNet-50 state dict (numpy), every key
    of the manifest: N(0, 0.02^2) weights, BN running stats included."""
    rng = np.random.RandomState(seed)
    return {k: (0.02 * rng.standard_normal(s)).astype(np.float32)
            for k, s in timm_manifests.resnet50_manifest().items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_convert_resnet50_bitwise_jax():
    sd = _resnet50_sd()
    got, want = _leaves(pconv.convert_resnet50(sd)), _leaves(
        jconv.convert_resnet50(sd))
    assert set(got) == set(want)
    assert len(got) == len(list(pres.resnet50().parameters()))
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_pretrained_resnet_warns_and_matches_jax(tmp_path):
    sd = _resnet50_sd(1)
    path = str(tmp_path / "resnet50.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    enc = pres.resnet50()
    current = pconv.port_params_as_jax_tree(enc)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = pconv.load_pretrained_encoder("resnet50", path, current)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jconv.load_pretrained_encoder("resnet50", path, current)
    pmsg = [str(w.message) for w in pw if w.category is UserWarning]
    jmsg = [str(w.message) for w in jw if w.category is UserWarning]
    assert pmsg == jmsg and len(pmsg) == 1 and "BatchNorm" in pmsg[0]
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # into the encoder through the bridge: the conv weights are the file's
    with pytest.warns(UserWarning, match="running statistics"):
        pconv.load_pretrained_into(enc, "resnet50", path)
    np.testing.assert_array_equal(
        enc.stem_conv.kernel.detach().numpy(), sd["conv1.weight"])
    np.testing.assert_array_equal(
        enc.stage3_block0.GroupNorm_3.scale.detach().numpy(),
        sd["layer4.0.downsample.1.weight"])


def test_verify_resnet50_on_cpu(tmp_path):
    path = str(tmp_path / "resnet50.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _resnet50_sd(2).items()},
               path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", "fmc_uia_tpu_torch.utils.convert", "--verify",
         path, "--device", "cpu", "--image-size", "64"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "family=resnet50" in out.stdout
    assert "manifest OK" in out.stdout
    assert "RESULT: PASS" in out.stdout
