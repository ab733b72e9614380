"""The port stands alone: importing every module of fmc_uia_tpu_torch
loads no jax, flax or fmc_uia_tpu module, nor pandas, cv2, PIL or yaml
(nor does a rank the parallel launcher spawns);
chip_smoke.py imports none of them; its C++ sources include nothing of
fmc_uia_tpu; entry points asked for CUDA on a host without a GPU raise
(the HTTP front and the DINOv3 SPM preset's build too); every encoder
name builds the JAX package's family or raises its ValueError; the
flagship config dict equals configs/config.yaml with the bench overrides.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch
import yaml

from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.flagship import flagship_config_dict
from helpers import make_tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "fmc_uia_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fmc_uia_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', "
        "'fmc_uia_tpu') or m.startswith(('jax.', 'flax.', 'fmc_uia_tpu.'))]\n"
        "assert not bad, bad\n"
        "host = [m for m in sys.modules if m.split('.')[0] in ('pandas', "
        "'cv2', 'PIL', 'yaml')]\n"
        "assert not host, host\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 37


def test_parallel_children_import_no_jax():
    """The parallel package's modules, imported in children that
    ``run_local`` spawns from this (jax-laden) test process, load no jax,
    flax or fmc_uia_tpu module."""
    from fmc_uia_tpu_torch.parallel import run_local
    from test_torch_parallel_workers import run_jobs

    out = run_local(run_jobs, 2, args=([("isolation", {})],),
                    timeout_s=120)
    for rank in out:
        assert rank[0]["forbidden"] == []
        assert "fmc_uia_tpu_torch.parallel.launch" in rank[0]["modules"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_chip_smoke_and_port_sources_import_no_jax():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "fmc_uia_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        bad = [m for m in _imports(p) if _forbidden(m)]
        assert not bad, (p, bad)


def test_port_csrc_includes_nothing_of_the_jax_package():
    csrc = os.path.join(ROOT, "fmc_uia_tpu_torch", "csrc")
    sources = [f for f in os.listdir(csrc)
               if f.endswith((".cu", ".cuh", ".cpp"))]
    assert "host_image.cpp" in sources and "preprocess_fwd.cu" in sources
    for name in sources:
        for line in open(os.path.join(csrc, name)):
            if line.lstrip().startswith("#include"):
                assert "fmc_uia_tpu/" not in line and "native" not in line, (
                    name, line)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    from fmc_uia_tpu_torch.export import Predictor
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.serving import StreamingPredictor
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    cfg = Config(config_dict=make_tiny_config(model={"encoder": {
        "name": "swin_nano", "window_size": 8}}).config)
    reg = TaskRegistry.from_config(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, reg)
    model = build_model(cfg, reg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, reg, [0.3] * 3, [0.2] * 3, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingPredictor(model, reg, [0.3] * 3, [0.2] * 3, 64)
    from fmc_uia_tpu_torch.fit import fit
    from fmc_uia_tpu_torch.metrics import evaluate

    with pytest.raises(RuntimeError, match="CUDA"):
        fit(config=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(model, [], reg, [0.3] * 3, [0.2] * 3)
    from fmc_uia_tpu_torch import serve
    from fmc_uia_tpu_torch.flagship import dinov3_spm_config_dict

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--checkpoint", "unused"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(Config(config_dict=dinov3_spm_config_dict()))


def test_unported_families_raise():
    """The families the port once refused build and run a forward: the
    tiny config's own encoder, resnet_tiny (queue 1 item 8), the task
    prompt and the grid head (item 7)."""
    from fmc_uia_tpu_torch.models import build_model

    cfg = Config(config_dict=make_tiny_config().config)
    model = build_model(cfg, device="cpu")
    assert type(model.encoder).__name__ == "ResNetEncoder"
    x = torch.zeros(1, 64, 64, 3)
    with torch.no_grad():
        assert tuple(model(x, "segmentation", 0).shape) == (1, 64, 64, 2)
    for over, ttype, shape in (
            ({"task_prompt": {"enabled": True}}, "segmentation",
             (1, 64, 64, 2)),
            ({"heads": {"detection": {"type": "grid"}}}, "detection",
             (1, 16, 16, 5))):
        cfg = Config(config_dict=make_tiny_config(model=dict(
            over, encoder={"name": "swin_nano"})).config)
        model = build_model(cfg, device="cpu")
        gidx = model.registry.of_type(ttype)[0].global_index
        with torch.no_grad():
            assert tuple(model(x, ttype, gidx).shape) == shape


def test_flagship_dict_equals_yaml_with_bench_overrides():
    with open(os.path.join(ROOT, "configs", "config.yaml")) as f:
        want = yaml.safe_load(f)
    # bench.py build_bench (defaults) and bench_serving.py overrides
    want["data"]["image_size"] = 512
    want["data"]["batch_size"] = 24
    want["data"]["fused_preprocess"] = False
    enc = want["model"]["encoder"]
    enc.update(name="swin_b", remat=False, remat_policy="full",
               softmax_bf16=True, ln_bf16=True, scan_stages=[0, 1, 3],
               fused_block=True, fused_mlp=True, window_size=8)
    want["device"]["mixed_precision"] = True
    assert flagship_config_dict() == want
    cfg = Config(config_dict=flagship_config_dict())
    assert cfg.image_size == 512 and cfg.mixed_precision
    assert len(cfg.get_task_configs()) == 27


def test_dino_patch8_dict_equals_yaml_with_overrides():
    from fmc_uia_tpu_torch.flagship import dino_patch8_config_dict

    with open(os.path.join(ROOT, "configs", "Dino_resize_patch8.yaml")) as f:
        want = yaml.safe_load(f)
    want["data"]["batch_size"] = 24  # the flagship's train batch
    want["data"]["fused_preprocess"] = False
    assert dino_patch8_config_dict() == want
    cfg = Config(config_dict=dino_patch8_config_dict())
    assert cfg.image_size == 512 and cfg.mixed_precision
    assert cfg.get("model.encoder.freeze_dino") is True
    assert len(cfg.get_task_configs()) == 27


def test_dino_build_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    from fmc_uia_tpu_torch.flagship import dino_patch8_config_dict
    from fmc_uia_tpu_torch.models import build_model

    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(Config(config_dict=dino_patch8_config_dict()))


# name -> the JAX package's family (its encoder class), or ValueError
DISPATCH = {
    None: "ResNetEncoder",  # no name: the default, resnet50
    "resnet50": "ResNetEncoder", "resnet-50": "ResNetEncoder",
    "resnet101": "ResNetEncoder", "resnet_tiny": "ResNetEncoder",
    "convnext_tiny": "ConvNeXtEncoder", "convnext_nano_test":
    "ConvNeXtEncoder", "timm:convnext_base.fb_in22k": "ConvNeXtEncoder",
    "efficientnet-b0": "EfficientNetEncoder",
    "efficientnet_b4": "EfficientNetEncoder",
    "timm:efficientnet_b3": "EfficientNetEncoder",
    "swin_nano": "SwinEncoder",
    "timm:swin_tiny_patch4_window7_224": "SwinEncoder",
    "timm:resnet50": ValueError, "convnext_t": ValueError,
    "efficientnet-b9": ValueError, "mobilenet_v3": ValueError,
}


@pytest.mark.parametrize("name", list(DISPATCH), ids=str)
def test_unported_encoder_families_raise(name):
    """The dispatch of the JAX package, name by name: the port builds the
    same family with the same param tree (shapes, in the port's layout),
    or raises the JAX package's ValueError where it does (no name: the
    default, resnet50)."""
    import jax
    import jax.numpy as jnp

    from fmc_uia_tpu.config import Config as JaxConfig
    from fmc_uia_tpu.models.encoders import build_encoder as jax_build
    from fmc_uia_tpu_torch.models.encoders import build_encoder
    from torch_port_utils import port_shapes

    class Unnamed:  # a config without model.encoder.name
        def get(self, key, default=None):
            return default

    if name is None:
        jcfg = pcfg = Unnamed()
    else:
        d = make_tiny_config(model={"encoder": {"name": name}}).config
        jcfg, pcfg = JaxConfig(config_dict=d), Config(config_dict=d)
    want = DISPATCH[name]
    if want is ValueError:
        with pytest.raises(ValueError) as jerr:
            jax_build(jcfg)
        with pytest.raises(ValueError) as perr:
            build_encoder(pcfg)
        assert str(perr.value).split(";")[0] == str(jerr.value).split(
            ";")[0]
        return
    jenc = jax_build(jcfg)
    with torch.device("meta"):  # shapes only, no memory
        enc = build_encoder(pcfg)
    assert type(jenc).__name__ == type(enc).__name__ == want
    assert tuple(enc.out_channels) == tuple(jenc.out_channels)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    assert {n: tuple(p.shape) for n, p in enc.named_parameters()} == (
        port_shapes(shapes))


def _swin_cfg(**enc):
    enc = dict({"name": "swin_nano", "window_size": 8}, **enc)
    return Config(config_dict=make_tiny_config(
        model={"encoder": enc}).config)


def _structure(enc):
    return ([(n, tuple(p.shape)) for n, p in enc.named_parameters()],
            [m.fused_mlp for m in enc.modules() if hasattr(m, "fused_mlp")])


def test_fused_stages_leaving_out_a_stage_raises():
    """A ``fused_stages`` list that leaves out a stage (once refused) runs
    that stage's blocks on the unfused attention, with the same param
    tree; ``fused_block: false`` leaves out every stage."""
    from fmc_uia_tpu_torch.models.encoders.swin import build_swin

    base = build_swin("swin_nano", _swin_cfg())
    for over, fused in (({"fused_stages": [0, 1]}, [1, 1, 0, 0]),
                        ({"fused_stages": [1, 2, 3]}, [0, 1, 1, 1]),
                        ({"fused_stages": []}, [0, 0, 0, 0]),
                        ({"fused_block": False}, [0, 0, 0, 0])):
        enc = build_swin("swin_nano", _swin_cfg(**over))
        assert [int(getattr(enc, f"stage{s}_block0").fused_block)
                for s in range(4)] == fused
        assert _structure(enc) == _structure(base)


def test_fused_stages_all_or_none_builds_the_same_encoder():
    from fmc_uia_tpu_torch.models.encoders.swin import build_swin

    base = build_swin("swin_nano", _swin_cfg())
    for stages in (None, [0, 1, 2, 3], [3, 2, 1, 0]):
        enc = build_swin("swin_nano", _swin_cfg(fused_stages=stages))
        assert _structure(enc) == _structure(base)


def test_fused_mlp_max_c_above_256_gates_as_jax(monkeypatch):
    """Above 256 the gate widens as the JAX package's does: swin_b's
    stages 0-2 (C = 128 to 512) run the fused kernels under 512, stage 3
    (C = 1024, whose weights overflow the JAX kernel's budget) runs JAX's
    XLA-branch math under 1024; 384 keeps stage 2 unfused. Below 256
    the gate narrows."""
    from fmc_uia_tpu_torch.models.encoders import swin
    from fmc_uia_tpu_torch.models.encoders.swin import build_swin

    # swin_b's widths at one block a stage
    monkeypatch.setitem(swin._SWIN_VARIANTS, "swin_b", dict(
        swin._SWIN_VARIANTS["swin_b"], depths=(1, 1, 1, 1)))
    for max_c, fused, math in (("512", [1, 1, 1, 0], [0, 0, 0, 0]),
                               ("1024", [1, 1, 1, 0], [0, 0, 0, 1]),
                               ("384", [1, 1, 0, 0], [0, 0, 0, 0])):
        monkeypatch.setenv("FMC_FUSED_MLP_MAX_C", max_c)
        enc = build_swin("swin_b", _swin_cfg())
        blocks = [getattr(enc, f"stage{s}_block0") for s in range(4)]
        assert [int(b.fused_mlp) for b in blocks] == fused, max_c
        assert [int(b.mlp_math) for b in blocks] == math, max_c
    # a width in the JAX kernel's budget that no Swin variant has: K2
    # takes every such width (C at run time)
    blk = swin.SwinBlock(640, 20, 8, shift=0, fused_mlp_max_c=1024)
    assert blk.fused_mlp and not blk.mlp_math
    # the gate only matters where the fused MLP is on, as in the JAX package
    build_swin("swin_nano", _swin_cfg(fused_mlp=False))
    monkeypatch.setenv("FMC_FUSED_MLP_MAX_C", "256")
    assert _structure(build_swin("swin_nano", _swin_cfg())) == _structure(
        build_swin("swin_nano", _swin_cfg(fused_stages=[0, 1, 2, 3])))
    # swin_nano is 32 / 64 / 128 / 256 wide
    for max_c, fused in (("128", [1, 1, 1, 0]), ("64", [1, 1, 0, 0]),
                         ("16", [0, 0, 0, 0])):
        monkeypatch.setenv("FMC_FUSED_MLP_MAX_C", max_c)
        enc = build_swin("swin_nano", _swin_cfg())
        assert [int(getattr(enc, f"stage{s}_block0").fused_mlp)
                for s in range(4)] == fused
