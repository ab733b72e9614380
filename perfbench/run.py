"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: the cell, its configuration, traffic and
limits are found by name (``BENCHMARK.json``, ``perfbench/*/<name>.json``).
Set-up (imports, the compile-cache check, weights, the first steps, the
warm-up) counts into ``setup_s``; then the window runs for ``--seconds``;
then the program is freed and the reference decides ``correct``. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and the breakdown. Exit codes: 0 a result; 2 the benchmark's files are
wrong; 3 no card, or fewer than the cell asks for; 4 JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# kernel and compile caches inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
    ROOT, "build", "perfbench", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
    ROOT, "build", "perfbench", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")  # no library of the run loads JAX


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import core

    try:
        bench = core.Bench(ROOT)
        cell = bench.cell(args.workload)
        traffic = bench.traffic(cell)
        config_file = bench.config(cell["config"])
        limits = bench.limits(cell)
    except (core.BenchError, OSError, ValueError) as e:
        log(f"perfbench: {e}")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("perfbench: no CUDA device (torch.cuda.is_available() is "
            "false): no result")
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"perfbench: the cell asks for {cell['chips']} cards, "
            f"{torch.cuda.device_count()} found: no result")
        return 3
    from perfbench import cells

    result = cells.run_cell(bench, cell, config_file, traffic, limits,
                            seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), t_start=T_START,
                            log=log)
    found = core.forbidden_modules()
    if found:
        log(f"perfbench: loaded in this process: {', '.join(found)}: no "
            "result")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(core.result_line(**result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
