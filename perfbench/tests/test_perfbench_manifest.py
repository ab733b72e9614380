"""BENCHMARK.json and the files it names: the contract's shape rules, and
every cell, configuration, traffic mix, limit and metric found by name."""

import copy
import importlib
import json
import os

import pytest

from perfbench import core


def manifest():
    return core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))


def test_manifest_is_valid():
    core.validate_manifest(manifest())


def test_every_file_found_by_name():
    bench = core.Bench()
    m = bench.manifest
    for c in m["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"]
        assert set(cfg["config"]) >= {"data", "model", "training", "tasks"}
        assert cfg["reduced"] == c["reduced"]
    for w in m["workloads"]:
        t = bench.traffic(w)
        assert t["kind"] in ("train_staged", "serve_closed_loop")
        lim = bench.limits(w)
        assert lim["limits"] and all(
            v["limit"] >= 0 for v in lim["limits"].values())
        assert len(bench.e2e(w["name"])) >= 2
        assert bench.layer(w["name"])
    for p in m["per_layer"]:
        fn, kwargs = core.reader(p, bench)
        assert callable(fn) and isinstance(kwargs, dict)


def test_layer_names_one_per_layer():
    m = manifest()
    by_layer = {}
    for p in m["per_layer"]:
        by_layer.setdefault(p["layer"], set()).add(p["name"])
    assert all("\n" not in k for k in by_layer)


@pytest.mark.parametrize("name,ok", [
    ("swin_b512.train", True), ("K1f_roofline.train", True),
    ("_x", True), ("a" * 64, True), ("a" * 65, False), ("has space", False),
    ("comma,name", False), ("slash/name", False), (".hidden", False),
    ("-dash", False), ("μs", False), ("", False)])
def test_names(name, ok):
    if ok:
        core.check_name(name, "test")
    else:
        with pytest.raises(core.BenchError):
            core.check_name(name, "test")


@pytest.mark.parametrize("unit,ok", [
    ("img/s", True), ("ms", True), ("%", True), ("GiB", True),
    ("tokens/s", True), ("a" * 16, True), ("a" * 17, False),
    ("per second", False), ("μs", False), ("", False)])
def test_units(unit, ok):
    if ok:
        core.check_unit(unit, "test")
    else:
        with pytest.raises(core.BenchError):
            core.check_unit(unit, "test")


@pytest.mark.parametrize("break_it", [
    lambda m: m.pop("run_seconds"),
    lambda m: m.update(run_seconds=52),
    lambda m: m["end_to_end"][0].update(bound=0.3),
    lambda m: m["end_to_end"][0].update(bound=0.005),
    lambda m: m["end_to_end"].pop(),                    # setup_s gone
    lambda m: m["workloads"][0].update(chips=2),
    lambda m: m["workloads"][0].update(why="x" * 201),
    lambda m: m["workloads"].append(dict(m["workloads"][0])),
    lambda m: m["per_layer"][0].update(moves="nope"),
    lambda m: m["per_layer"][0].update(why="extra key"),
    lambda m: m["configs"][0].update(file="elsewhere/x.json"),
    lambda m: m.update(command=["python3", "/abs/run.py"]),
])
def test_broken_manifests_refused(break_it):
    m = copy.deepcopy(manifest())
    break_it(m)
    with pytest.raises(core.BenchError):
        core.validate_manifest(m)


def test_a_cell_is_added_by_files_and_entries(tmp_path):
    """A later cell needs new files and entries only: a copy of the
    benchmark with one more cell (a config, traffic and limits of its
    own) validates and finds its files."""
    import shutil

    root = tmp_path / "co"
    shutil.copytree(core.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    cfg = core.load_json(os.path.join(core.HERE, "configs",
                                      "swin_b512.json"))
    cfg["name"] = "swin_b512_w12"
    (root / "perfbench" / "configs" / "swin_b512_w12.json").write_text(
        json.dumps(cfg))
    m["configs"].append(dict(m["configs"][0], name="swin_b512_w12",
                             file="perfbench/configs/swin_b512_w12.json"))
    new = dict(m["workloads"][0], name="swin_b512_w12.train",
               config="swin_b512_w12")
    m["workloads"].append(new)
    src = m["workloads"][0]["name"]
    for kind in ("traffic", "limits"):
        shutil.copy(root / "perfbench" / kind / f"{src}.json",
                    root / "perfbench" / kind / "swin_b512_w12.train.json")
    for e in m["end_to_end"] + m["per_layer"]:
        if src in e.get("workloads", []):
            e["workloads"].append(new["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    bench = core.Bench(str(root))
    cell = bench.cell("swin_b512_w12.train")
    assert bench.traffic(cell)["kind"]
    assert bench.config("swin_b512_w12")["name"] == "swin_b512_w12"
    assert "setup_s" in bench.e2e(cell["name"])


def test_readers_are_modules_of_their_own():
    bench = core.Bench()
    for p in bench.manifest["per_layer"]:
        spec = bench.file("metrics", p["name"])
        mod = importlib.import_module(f"perfbench.readers.{spec['reader']}")
        assert mod.__doc__
