"""The readings a cell's limits are set from, on the card: for each seed,
the numbers of a sound run of the program against the reference (the
lower readings), of the control (the reference with its forward in
float8, in the program's place) and of the planted faults (the upper
readings). A training cell needs no window; a serving cell runs a short
one at its own load. One process reads every seed, so the kernels build
once.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--control-seeds 11,12,13] [--faults half_batch] [--seconds 5]

Prints one JSON line per seed and kind, and writes them all to
``chiprun_out/calibrate_<cell>.json`` when that directory exists. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    from perfbench import compare, core

    bench = core.Bench(ROOT)
    cell = bench.cell(args.workload)
    traffic = bench.traffic(cell)
    config_file = bench.config(cell["config"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [f for f in args.faults.split(",") if f]
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    if traffic["kind"] == "train_staged":
        from perfbench.train_cell import TrainCell

        runs = [(s, None) for s in seeds] + [(s, f) for f in faults
                                             for s in controls]
        for seed, fault in runs:
            t0 = time.perf_counter()
            tc = TrainCell(cell, config_file, dict(traffic, warm_rounds=0),
                           seed, fault=fault)
            tc.setup()
            tc.free()
            ref = tc.reference()
            row = {"seed": seed, "kind": fault or "program",
                   **compare.train_numbers(tc.program, ref),
                   "loss": tc.program["loss"], "ref_loss": ref["loss"]}
            if fault is None and seed in controls:
                ctl = tc.reference(control=True)
                emit(dict(row, s=time.perf_counter() - t0))
                cn = compare.train_numbers(ctl, ref)
                row = {"seed": seed, "kind": "control", **cn,
                       "loss": ctl["loss"]}
            emit(dict(row, s=time.perf_counter() - t0))
            torch.cuda.empty_cache()
    else:
        from perfbench.serve_cell import calibrate_serve

        for row in calibrate_serve(bench, cell, config_file, traffic, seeds,
                                   controls, faults, args.seconds):
            emit(row)
    out = os.path.join(ROOT, "chiprun_out")
    if os.path.isdir(out):
        with open(os.path.join(out, f"calibrate_{cell['name']}.json"),
                  "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
