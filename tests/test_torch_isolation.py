"""The port stands alone: importing every module of fmc_uia_tpu_torch
loads no jax, flax or fmc_uia_tpu module; chip_smoke.py imports none of
them; entry points asked for CUDA on a host without a GPU raise; the
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
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 15


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


def test_unported_families_raise():
    from fmc_uia_tpu_torch.models import build_model

    for over in ({"model": {"encoder": {"name": "resnet_tiny"}}},
                 {"model": {"encoder": {"name": "swin_nano"},
                            "moe": {"enabled": True}}},
                 {"model": {"encoder": {"name": "swin_nano"},
                            "heads": {"detection": {"type": "grid"}}}}):
        cfg = Config(config_dict=make_tiny_config(**over).config)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(cfg, device="cpu")


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
