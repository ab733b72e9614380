"""The benchmark's frame: the manifest and the files it names, the rules
for names and units, the statistics of the end-to-end metrics, the check
that nothing of JAX is loaded, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under this directory, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the frozen configuration dict and its source;
* ``traffic/<cell>.json``: the cell's traffic parameters (``kind`` names
  the general generator that reads them);
* ``limits/<cell>.json``: the limit of each number the cell's comparison
  holds, with the readings it was set from;
* ``metrics/<metric>.json``: a per-layer metric's reader and its
  arguments; ``readers/<reader>.py`` holds the reader.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import re
import statistics
import sys
from typing import Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# the modules that must not be loaded in a run: compared by the top-level
# name (before the first dot) whole, so ``fmc_uia_tpu_torch`` is not
# ``fmc_uia_tpu``
FORBIDDEN_TOPLEVEL = ("jax", "jaxlib", "flax", "fmc_uia_tpu")

MANIFEST_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


class BenchError(Exception):
    """A manifest, file or run that breaks the benchmark's rules."""


def load_json(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _line(text, what: str) -> None:
    if not (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text):
        raise BenchError(f"{what}: 1 to 200 characters on one line, no tab")


def check_name(name, what: str) -> None:
    if not (isinstance(name, str) and NAME_RE.match(name)):
        raise BenchError(f"{what} {name!r}: a name is 1 to 64 letters, "
                         "digits, '_', '.' or '-', not starting with . or -")


def check_unit(unit, what: str) -> None:
    if not (isinstance(unit, str) and UNIT_RE.match(unit)):
        raise BenchError(f"{what}: unit {unit!r} is 1 to 16 letters, digits,"
                         " '_', '/', '%', '.' or '-'")


def validate_manifest(m: Dict, root: str = ROOT) -> None:
    """Raise ``BenchError`` where ``BENCHMARK.json`` breaks the contract's
    shape rules (keys, names, units, counts, files under ``paths``)."""
    if not isinstance(m, dict) or set(m) != set(MANIFEST_KEYS):
        raise BenchError(f"BENCHMARK.json keys must be {MANIFEST_KEYS}")
    cmd, paths = m["command"], m["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        raise BenchError("command: a list of 1 to 32 strings")
    for w in cmd:
        _line(w, "command word")
        if w.startswith("/") or ".." in w.split("/"):
            raise BenchError(f"command word {w!r} leaves the checkout")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        raise BenchError("paths: 1 to 16 directories")
    for p in paths:
        if not (isinstance(p, str) and PATH_RE.match(p)) or p.startswith(
                "/") or ".." in p.split("/"):
            raise BenchError(f"path {p!r}")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        raise BenchError("run_seconds: a whole number from 1 to 51")
    names = set()

    def unique(name, what):
        check_name(name, what)
        if name in names:
            raise BenchError(f"{what} {name!r} is not unique")
        names.add(name)

    configs = m["configs"]
    if not (isinstance(configs, list) and 1 <= len(configs) <= 24):
        raise BenchError("configs: 1 to 24 entries")
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            raise BenchError(f"config keys must be {sorted(CONFIG_KEYS)}")
        unique(c["name"], "config")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            raise BenchError(f"config file {c['file']} is not under paths")
        if c["file"] in files:
            raise BenchError(f"config file {c['file']} used twice")
        files.add(c["file"])
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16):
            raise BenchError("reduced: at most 16 keys")
        for k in c["reduced"]:
            check_name(k, "reduced key")
    cells = m["workloads"]
    if not (isinstance(cells, list) and 1 <= len(cells) <= 24):
        raise BenchError("workloads: 1 to 24 cells")
    cfg_names = {c["name"] for c in configs}
    pairs = set()
    for w in cells:
        if set(w) != WORKLOAD_KEYS:
            raise BenchError(f"workload keys must be {sorted(WORKLOAD_KEYS)}")
        unique(w["name"], "workload")
        check_name(w["traffic"], "traffic")
        if w["config"] not in cfg_names:
            raise BenchError(f"workload {w['name']}: no config "
                             f"{w['config']!r}")
        if w["chips"] not in (1, 4):
            raise BenchError(f"workload {w['name']}: chips 1 or 4")
        _line(w["why"], f"workload {w['name']} why")
        if (w["config"], w["traffic"]) in pairs:
            raise BenchError(f"workload {w['name']}: pair used twice")
        pairs.add((w["config"], w["traffic"]))
    if sum(w["chips"] == 4 for w in cells) > max(1, len(cells) // 4):
        raise BenchError("too many four-chip cells")
    used = {w["config"] for w in cells}
    if used != cfg_names:
        raise BenchError(f"configs used by no cell: {cfg_names - used}")
    cell_names = {w["name"] for w in cells}
    e2e, layer = m["end_to_end"], m["per_layer"]
    if not (isinstance(e2e, list) and 1 <= len(e2e) <= 16):
        raise BenchError("end_to_end: 1 to 16 metrics")
    if not (isinstance(layer, list) and 1 <= len(layer) <= 128):
        raise BenchError("per_layer: 1 to 128 metrics")
    e2e_names = set()
    for e in e2e:
        if not E2E_KEYS <= set(e) <= E2E_KEYS | {"workloads"}:
            raise BenchError(f"end-to-end metric keys: {sorted(E2E_KEYS)}")
        unique(e["name"], "metric")
        check_unit(e["unit"], e["name"])
        if e["better"] not in ("lower", "higher"):
            raise BenchError(f"{e['name']}: better is lower or higher")
        if e["source"] not in ("host_clock", "device_trace"):
            raise BenchError(f"{e['name']}: source host_clock or "
                             "device_trace")
        b = e["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            raise BenchError(f"{e['name']}: bound from 0.01 to 0.25")
        for c in e.get("workloads", []):
            if c not in cell_names:
                raise BenchError(f"{e['name']}: no cell {c!r}")
        e2e_names.add(e["name"])
    if "setup_s" not in e2e_names:
        raise BenchError("end_to_end must hold setup_s")
    layers_seen = {}
    for p in layer:
        if not LAYER_KEYS <= set(p) <= LAYER_KEYS | {"workloads"}:
            raise BenchError(f"per-layer metric keys: {sorted(LAYER_KEYS)}")
        unique(p["name"], "metric")
        check_unit(p["unit"], p["name"])
        _line(p["layer"], f"{p['name']} layer")
        if p["better"] not in ("lower", "higher"):
            raise BenchError(f"{p['name']}: better is lower or higher")
        if p["source"] not in ("device_trace", "program_span",
                               "program_counter", "host_clock"):
            raise BenchError(f"{p['name']}: source")
        if p["moves"] not in e2e_names or p["moves"] == "setup_s":
            raise BenchError(f"{p['name']}: moves {p['moves']!r}")
        for c in p.get("workloads", []):
            if c not in cell_names:
                raise BenchError(f"{p['name']}: no cell {c!r}")
            if p["moves"] not in cell_e2e(m, c):
                raise BenchError(f"{p['name']}: cell {c} does not report "
                                 f"{p['moves']}")
        layers_seen.setdefault(p["layer"], p["name"])
    for w in cells:
        mine = cell_e2e(m, w["name"])
        if "setup_s" not in mine or len(mine) < 2:
            raise BenchError(f"{w['name']}: setup_s and one more "
                             "end-to-end metric")
        if not cell_layer(m, w["name"]):
            raise BenchError(f"{w['name']}: no per-layer metric")
    if len(json.dumps(m)) > 64 * 1024:
        raise BenchError("BENCHMARK.json is over 64 KiB")


def cell_e2e(m: Dict, cell: str) -> List[Dict]:
    """The names of the end-to-end metrics a cell reports."""
    return [e["name"] for e in m["end_to_end"]
            if "workloads" not in e or cell in e["workloads"]]


def cell_layer(m: Dict, cell: str) -> List[Dict]:
    """The per-layer metric entries a cell reports."""
    mine = set(cell_e2e(m, cell))
    return [p for p in m["per_layer"]
            if (cell in p["workloads"] if "workloads" in p
                else p["moves"] in mine)]


class Bench:
    """The manifest and the files of one cell, found by name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.isfile(path):
            raise BenchError(f"no BENCHMARK.json in {root}")
        self.manifest = load_json(path)
        validate_manifest(self.manifest, root)
        self.dir = os.path.join(root, "perfbench")

    def cell(self, name: str) -> Dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise BenchError(f"no config {name!r}")

    def file(self, kind: str, name: str) -> Dict:
        path = os.path.join(self.dir, kind, f"{name}.json")
        if not os.path.isfile(path):
            raise BenchError(f"no {kind} file for {name!r} ({path})")
        return load_json(path)

    def traffic(self, cell: Dict) -> Dict:
        return self.file("traffic", cell["name"])

    def limits(self, cell: Dict) -> Dict:
        return self.file("limits", cell["name"])

    def e2e(self, cell: str) -> List[str]:
        return cell_e2e(self.manifest, cell)

    def layer(self, cell: str) -> List[Dict]:
        return cell_layer(self.manifest, cell)


def reader(metric: Dict, bench: Bench):
    """(read function, its keyword arguments) of a per-layer metric, from
    ``metrics/<name>.json`` and ``readers/<reader>.py``."""
    spec = bench.file("metrics", metric["name"])
    check_name(spec["reader"], "reader")
    mod = importlib.import_module(f"perfbench.readers.{spec['reader']}")
    return mod.read, dict(spec.get("args", {}))


# -- statistics -------------------------------------------------------------
def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    if pos == lo or v[hi] == v[lo] or math.isinf(v[hi]):
        return v[lo] if pos == lo or v[hi] == v[lo] else math.inf
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def latency_p95(latencies_ms: Sequence[float], failed: int) -> float:
    """p95 over every request attempted: a failed request counts as
    missing every limit (an infinite latency)."""
    return percentile(list(latencies_ms) + [math.inf] * int(failed), 95.0)


def rate(count: float, seconds: float) -> float:
    """Work over the whole window: ``count`` over ``seconds``."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """(q3 - q1) / median, quartiles as ``statistics.quantiles(n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


# -- what a run loaded ------------------------------------------------------
def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of
    ``FORBIDDEN_TOPLEVEL``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules
                  if n.split(".", 1)[0] in FORBIDDEN_TOPLEVEL)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict], device: Dict,
                breakdown: Optional[Dict], checks: Dict) -> str:
    """The last line of a run: ``checks`` (each number compared beside
    its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


class Phases:
    """Seconds of each named phase of a set-up, for the log: ``mark(name)``
    closes the phase that began at the last mark."""

    def __init__(self):
        import time

        self._clock = time.perf_counter
        self._t = self._clock()
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        t = self._clock()
        self.seconds[name] = t - self._t
        self._t = t


# -- the device, on a card or (the tests) the CPU ------------------------
def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def free_cache(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
