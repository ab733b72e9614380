"""Nothing of the benchmark loads JAX, flax or the JAX package, judged by
each module's top-level name compared whole (``fmc_uia_tpu_torch`` is not
``fmc_uia_tpu``); the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import core

FILES = [os.path.join(d, f) for d, _, fs in os.walk(core.HERE)
         for f in fs if f.endswith(".py")]


def imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("fmc_uia_tpu", True), ("fmc_uia_tpu.train", True),
    ("fmc_uia_tpu_torch", False), ("fmc_uia_tpu_torch.train", False),
    ("jaxtyping", False), ("flaxen", False), ("torch", False)])
def test_top_level_names_compared_whole(name, bad):
    assert (core.forbidden_modules({name: None}) == [name]) == bad


def test_no_source_imports_jax():
    for path in FILES:
        for mod in imports(path):
            top = mod.split(".")[0]
            assert top not in core.FORBIDDEN_TOPLEVEL, (path, mod)
            assert top not in ("chip_smoke", "bench", "bench_serving",
                               "bench_latency"), (path, mod)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(core.HERE, "reference")
    for path in FILES:
        if path.startswith(ref):
            for mod in imports(path):
                assert not mod.startswith("fmc_uia_tpu"), (path, mod)


def test_a_run_loads_no_jax():
    """Every module a run imports, the program's included, in a fresh
    process: no forbidden top-level name in ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.run, perfbench.cells, perfbench.train_cell\n"
        "import perfbench.serve_cell, perfbench.calibrate, perfbench.trace\n"
        "import perfbench.reference.step, perfbench.reference.multitask\n"
        "import fmc_uia_tpu_torch.train, fmc_uia_tpu_torch.serving\n"
        "import fmc_uia_tpu_torch.models\n"
        "from perfbench import core\n"
        "print(core.forbidden_modules())\n" % core.ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=core.ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
