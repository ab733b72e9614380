"""One run of a cell, whatever its traffic: set-up, the window, the
per-layer readers (traced runs), then the comparison with the reference.
The traffic file's ``kind`` picks the driver (``train_staged``:
``train_cell.py``; ``serve_closed_loop``: ``serve_cell.py``)."""

from __future__ import annotations

import math
import subprocess
import time
from types import SimpleNamespace
from typing import Dict

import torch

from perfbench import compare, core


def card_line() -> str:
    """The card's name, power limit and clocks (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def phases_line(imports_s: float, phases: Dict[str, float]) -> str:
    """The set-up's phases for the log: the imports and the card's start
    (from the process's start), then the cell's own."""
    return ", ".join(f"{k} {v:.3f}" for k, v in
                     {"imports": imports_s, **phases}.items())


def device_info(chips: int, peak: int, trace: Dict = None,
                device="cuda") -> Dict:
    if torch.device(device).type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    else:  # the tests' runs: never a device metric
        dev = {"platform": "cpu", "kind": "cpu"}
    dev.update(count=int(chips), memory_peak_bytes=int(peak))
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev


def read_layer(bench, cell: Dict, ctx) -> Dict[str, Dict]:
    """Each per-layer metric of the cell that its reader finds: a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for m in bench.layer(cell["name"]):
        fn, kwargs = core.reader(m, bench)
        v = fn(ctx, **kwargs)
        if v is not None:
            if not math.isfinite(v):
                raise RuntimeError(f"{m['name']} read {v}")
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(bench, cell: Dict, config_file: Dict, traffic: Dict,
             limits: Dict, seed: int, seconds: float, trace: bool,
             t_start: float, log, device="cuda", fault=None) -> Dict:
    """One run; ``device`` and ``fault`` are the tests' (a CPU run of a
    small configuration, a fault planted under the timed path)."""
    kind = traffic["kind"]
    if kind == "train_staged":
        return _train(bench, cell, config_file, traffic, limits, seed,
                      seconds, trace, t_start, log, device, fault)
    if kind == "serve_closed_loop":
        from perfbench.serve_cell import run_serve

        return run_serve(bench, cell, config_file, traffic, limits, seed,
                         seconds, trace, t_start, log, device, fault)
    raise core.BenchError(f"unknown traffic kind {kind!r}")


def _train(bench, cell, config_file, traffic, limits, seed, seconds, trace,
           t_start, log, device, fault) -> Dict:
    from perfbench.train_cell import TrainCell

    imports_s = time.perf_counter() - t_start
    tc = TrainCell(cell, config_file, traffic, seed, device, fault)
    tc.setup()
    setup_s = time.perf_counter() - t_start
    w = tc.window(seconds)
    log(f"window: {w['steps']} steps in {w['window_s']:.3f} s, "
        f"{w['train_img_s']:.3f} img/s, set-up {setup_s:.3f} s "
        f"({phases_line(imports_s, tc.phases)}); "
        f"{card_line() if device == 'cuda' else device}")
    metrics, breakdown, tr = {}, None, None
    if trace:
        tr = tc.traced(int(traffic["trace_rounds"]))
        log(f"traced stretch: {tr['steps']} steps, {tr['img_s']:.3f} img/s"
            f" under the profiler, device busy {tr['trace']['busy_s']:.4f}"
            f" of {tr['trace']['window_s']:.4f} s")
        ctx = SimpleNamespace(
            kind="train", cell=cell, traffic=traffic, config=tc.config,
            config_dict=config_file["config"], window=w, trace=tr["trace"],
            launches=tr["launches"], batches={tc.B: tr["steps"]},
            images_per_s=w["train_img_s"],
            enqueue_ms=tc.enqueue_ms())
        metrics = read_layer(bench, cell, ctx)
        breakdown = {"device_ops": tr["trace"]["device_ops"],
                     "idle_gaps": tr["trace"]["idle_gaps"]}
    else:
        metrics = {"train_img_s": {"value": w["train_img_s"],
                                   "unit": "img/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items()
                   if k in bench.e2e(cell["name"])}
    peak = w["peak_bytes"]
    tc.free()
    ref = tc.reference()
    numbers = compare.train_numbers(tc.program, ref)
    log("not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items()
        if k not in limits["limits"]))
    correct, checks = compare.judge(numbers, limits)
    checks["nonfinite_losses"] = {"value": w["nonfinite"], "limit": 0}
    correct = correct and w["nonfinite"] == 0
    return {"correct": correct, "attempted": w["steps"],
            "failed": w["nonfinite"],
            "metrics": metrics, "device": device_info(
                cell["chips"], peak, tr["trace"] if trace else None, device),
            "breakdown": breakdown, "checks": checks}
