"""On the card only (``cuda`` marker; skipped without one): the control
fails the limits of its cell, and every cell runs to a correct result
from the command the benchmark's checks use."""

import json
import subprocess
import sys

import pytest

from perfbench import compare, core
from perfbench.train_cell import TrainCell

SEEDS = (2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["swin_b512.train"])
def test_control_fails_the_limits(card, cell_name):
    """The reference in float8 in the program's place, at the cell's
    widths and a batch of 4: on every seed one of its numbers is over
    the cell's limit."""
    bench = core.Bench()
    cell = bench.cell(cell_name)
    traffic = dict(bench.traffic(cell), batch=4, warm_rounds=0)
    limits = bench.limits(cell)
    for seed in SEEDS:
        tc = TrainCell(cell, bench.config(cell["config"]), traffic, seed)
        tc.setup()
        tc.free()
        ref = tc.reference()
        low = tc.reference(control=True)
        correct, checks = compare.judge(compare.train_numbers(low, ref),
                                        limits)
        assert not correct, (seed, checks)


@pytest.mark.cuda
def test_every_cell_runs_correct(card):
    bench = core.Bench()
    for w in bench.manifest["workloads"]:
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", w["name"],
             "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"],
            capture_output=True, text=True, timeout=900, cwd=core.ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu"
