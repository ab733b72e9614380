"""A closed-loop serving cell: the program's ``StreamingPredictor`` under
``clients`` clients, each sending its next request when its last is
answered.

Set-up builds the model from the seed's weights and the service with the
traffic's settings, warms up every (task, chain size) the traffic can
make, and makes the request images. The window submits for ``--seconds``:
``serve_img_s`` counts the requests answered inside it over its length;
``serve_p95_ms`` is the 95th percentile of the latency of every request
submitted in it (from ``submit`` to the future being fulfilled, the
requests still out at the close waited for), a failed request counting
as missing every limit. The answers of a sample of requests, drawn from
the seed among those kept (one in ``keep_every``), are then compared with
the reference's forward of the same images (``compare.py``).
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import FIRST_COMPLETED, wait
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from perfbench import compare, core, traffic as traffic_lib
from perfbench.train_cell import launch_counters
from perfbench.weights import make_weights, reference_template


class ServeCell:
    def __init__(self, bench_cell: Dict, config_file: Dict, traffic: Dict,
                 seed: int, device: str = "cuda", fault: str = None):
        from fmc_uia_tpu_torch.config import Config
        from fmc_uia_tpu_torch.tasks import TaskRegistry

        self.cell = bench_cell
        self.config_dict = config_file["config"]
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.fault = fault
        self.config = Config(config_dict=self.config_dict)
        self.registry = TaskRegistry.from_config(self.config)
        self.tasks = [tid for _, tid in traffic["tasks"]]

    def setup(self) -> None:
        from fmc_uia_tpu_torch.models import build_model
        from fmc_uia_tpu_torch.serving import StreamingPredictor

        from perfbench.reference.config import Config as RefConfig
        from perfbench.reference.tasks import TaskRegistry as RefRegistry

        clock = core.Phases()
        ref_cfg = RefConfig(config_dict=self.config_dict)
        template = reference_template(ref_cfg, RefRegistry.from_config(
            ref_cfg), self.device)
        weights = make_weights(template, self.seed, self.device)
        del template
        clock.mark("weights")
        dtype = (torch.bfloat16 if self.config.mixed_precision
                 else torch.float32)
        model = build_model(self.config, self.registry, dtype=dtype,
                            device=self.device, init=False)
        model.load_state_dict(weights, strict=True)
        del weights
        t = self.traffic
        norm = self.config.get("data.augmentation.normalize")
        self.svc = StreamingPredictor(
            model, self.registry, norm["mean"], norm["std"],
            int(t["image"]), max_batch=int(t["max_batch"]),
            max_delay_ms=float(t["max_delay_ms"]),
            autoscale=bool(t["autoscale"]),
            max_inflight=int(t["max_inflight"]), device=self.device)
        self._unplant = compare.plant(self.fault, self.svc.predictor)
        clock.mark("model")
        self.svc.warmup(task_ids=self.tasks)
        core.sync(self.device)
        clock.mark("warm_up")
        self.images = traffic_lib.serve_images(t, self.seed, self.device)
        self.order = traffic_lib.serve_order(t, self.seed,
                                             int(t["max_requests"]))
        self.k = 0  # the next request of ``order``
        core.sync(self.device)
        clock.mark("traffic")
        self.phases = clock.seconds

    def kept(self, k: int) -> bool:
        return (k * 2654435761 + self.seed) % int(
            self.traffic["keep_every"]) == 0

    def _loop(self, seconds: float, hook=None) -> Dict:
        """The closed loop from request ``self.k`` on: ``clients``
        requests kept out, a new one sent as each is answered until
        ``seconds`` have passed, then the last ones waited for. ``hook``,
        if given, is called with the seconds since the start after each
        batch of answers."""
        svc, order, images = self.svc, self.order, self.images
        clients = int(self.traffic["clients"])
        lat: Dict[int, tuple] = {}
        answers: Dict[int, np.ndarray] = {}
        failed: List[int] = []
        lock = threading.Lock()
        pending = {}
        first = self.k

        def done(k, ts):
            now = time.perf_counter()
            with lock:
                lat[k] = (now, 1e3 * (now - ts))

        def submit():
            k = self.k
            if k >= len(order):
                raise RuntimeError("the traffic's max_requests ran out")
            j, ti = order[k]
            ts = time.perf_counter()
            f = svc.submit(images[j], self.tasks[ti])
            f.add_done_callback(lambda f, k=k, ts=ts: done(k, ts))
            pending[f] = k
            self.k += 1

        t0 = time.perf_counter()
        t_end = t0 + seconds
        while len(pending) < clients:
            submit()
        while pending:
            ready, _ = wait(list(pending), return_when=FIRST_COMPLETED)
            for f in ready:
                kk = pending.pop(f)
                if f.exception() is not None:
                    failed.append(kk)
                elif self.kept(kk):
                    answers[kk] = f.result()
                if time.perf_counter() < t_end:
                    submit()
            if hook is not None:
                hook(time.perf_counter() - t0)
        while len(lat) + len(failed) < self.k - first:  # the last callbacks
            time.sleep(1e-3)
        in_window = sum(1 for when, _ in lat.values() if when <= t_end)
        lats = [ms for _, ms in lat.values()]
        return {"attempted": self.k - first, "failed": len(failed),
                "answered_in_window": in_window,
                "serve_img_s": core.rate(in_window, seconds),
                "serve_p95_ms": core.latency_p95(lats, len(failed)),
                "p50_ms": core.percentile(lats, 50) if lats else math.nan,
                "answers": answers}

    def window(self, seconds: float) -> Dict:
        """The timed closed loop (module docstring)."""
        stats0 = _stats(self.svc)
        core.reset_peak(self.device)
        out = self._loop(seconds)
        out["stats"] = _stats_delta(stats0, _stats(self.svc))
        out["peak_bytes"] = core.peak_bytes(self.device)
        return out

    def traced(self, trace_s: float) -> Dict:
        """After the window, the same loop under the profiler: it warms up
        over the first second, then records ``trace_s`` seconds. For the
        stretch, the predictor's calls are counted by batch size under a
        lock that the counters are read under too, so that both are read
        between two calls and agree."""
        from perfbench.trace import Trace

        pred = self.svc.predictor
        predict, lock, calls = pred.predict_device, threading.Lock(), {}

        def counted(images, task_id):
            with lock:
                out = predict(images, task_id)
                calls[len(images)] = calls.get(len(images), 0) + 1
            return out

        def read():
            with lock:
                return dict(calls), launch_counters()

        trace = Trace(torch)
        marks = {}

        def hook(t):
            if "begin" not in marks and t >= 1.0:
                trace.begin()
                marks["begin"] = read()
            elif "end" not in marks and "begin" in marks and (
                    t >= 1.0 + trace_s):
                marks["end"] = read()
                trace.end()

        pred.predict_device = counted
        try:
            trace.start()
            self._loop(1.0 + trace_s + 0.5, hook)
        finally:
            pred.predict_device = predict
        if "end" not in marks:
            raise RuntimeError("the traced stretch did not close")
        (b0, c0), (b1, c1) = marks["begin"], marks["end"]
        batches = {s: b1[s] - b0.get(s, 0) for s in b1 if b1[s] > b0.get(
            s, 0)}
        return {"trace": trace.reduce(), "batches": batches,
                "launches": {k: c1[k] - c0[k] for k in c1}}

    def enqueue_ms(self, reps: int = 3) -> float:
        """Median host ms of ``Predictor.predict_device`` at ``max_batch``
        with the card idle, over ``reps`` calls a task."""
        pred = self.svc.predictor
        B = int(self.traffic["max_batch"])
        batch = self.images[:B]
        vals = []
        for tid in self.tasks:
            for _ in range(reps):
                core.sync(self.device)
                t0 = time.perf_counter()
                pred.predict_device(batch, tid)
                vals.append(1e3 * (time.perf_counter() - t0))
        core.sync(self.device)
        return core.percentile(vals, 50)

    def free(self) -> None:
        self.svc.close()
        self._unplant()
        del self.svc
        core.free_cache(self.device)

    def sample(self, answers: Dict[int, np.ndarray]) -> List[int]:
        """``compare_per_task`` kept requests of each task, drawn from the
        seed (all kept ones where a task has fewer)."""
        rng = np.random.Generator(np.random.PCG64(
            [self.seed & 0xFFFFFFFF, self.seed >> 32, 0x736D706C]))
        out = []
        n = int(self.traffic["compare_per_task"])
        for ti in range(len(self.tasks)):
            ks = sorted(kk for kk in answers if self.order[kk][1] == ti)
            if ks:
                out += list(rng.choice(ks, size=min(n, len(ks)),
                                       replace=False))
        return sorted(int(x) for x in out)

    def reference(self, picks: List[int], answers: Dict[int, np.ndarray],
                  control: bool = False) -> Dict[str, float]:
        """The serving numbers of the answers ``picks`` against the
        reference's f32 forward of the same images; with ``control`` the
        answers are the float8 reference's own, decoded."""
        from perfbench.reference.config import Config as RefConfig
        from perfbench.reference.multitask import build_model
        from perfbench.reference.step import Fp8Forward, predict_raw
        from perfbench.reference.tasks import TaskRegistry as RefRegistry

        cfg = RefConfig(config_dict=self.config_dict)
        registry = RefRegistry.from_config(cfg)
        per_type: Dict[str, float] = {}
        with compare.no_tf32():
            template = reference_template(cfg, registry, self.device)
            weights = make_weights(template, self.seed, self.device)
            del template
            model = build_model(cfg, registry, dtype=torch.float32,
                                device=self.device)
            model.load_state_dict(weights, strict=True)
            del weights
            for ti, tid in enumerate(self.tasks):
                spec = registry[tid]
                ks = [kk for kk in picks if self.order[kk][1] == ti]
                for i in range(0, len(ks), 8):
                    chunk = ks[i:i + 8]
                    img = torch.from_numpy(np.stack([
                        self.images[self.order[kk][0]] for kk in chunk
                    ])).to(self.device)
                    ref = predict_raw(model, cfg, img, spec.task_name,
                                      spec.global_index)
                    if control:
                        with Fp8Forward():
                            low = predict_raw(model, cfg, img,
                                              spec.task_name,
                                              spec.global_index)
                        got = compare.decode(low, spec.task_name,
                                             spec.num_classes)
                    else:
                        got = [torch.as_tensor(answers[kk]) for kk in chunk]
                    for name, v in compare.serve_gaps(
                            ref, got, spec.task_name,
                            spec.num_classes).items():
                        per_type[name] = max(per_type.get(name, 0.0), v)
        del model
        core.free_cache(self.device)
        return per_type


def _stats(svc) -> Dict:
    s = svc.stats
    return {"dispatches": s["dispatches"], "pad_images": s["pad_images"],
            "by_size": dict(s["by_size"])}


def _stats_delta(a: Dict, b: Dict) -> Dict:
    sizes = set(a["by_size"]) | set(b["by_size"])
    return {"dispatches": b["dispatches"] - a["dispatches"],
            "pad_images": b["pad_images"] - a["pad_images"],
            "by_size": {s: b["by_size"].get(s, 0) - a["by_size"].get(s, 0)
                        for s in sizes}}


def run_serve(bench, cell, config_file, traffic, limits, seed, seconds,
              trace, t_start, log, device="cuda", fault=None) -> Dict:
    from perfbench.cells import (card_line, device_info, phases_line,
                                 read_layer)

    imports_s = time.perf_counter() - t_start
    sc = ServeCell(cell, config_file, traffic, seed, device, fault)
    sc.setup()
    setup_s = time.perf_counter() - t_start
    w = sc.window(seconds)
    st = w["stats"]
    log(f"window: {w['attempted']} requests, {w['answered_in_window']} "
        f"answered in {seconds} s: {w['serve_img_s']:.3f} img/s, p50 "
        f"{w['p50_ms']:.2f} ms, p95 {w['serve_p95_ms']:.2f} ms, "
        f"{st['dispatches']} dispatches {st['by_size']}, set-up "
        f"{setup_s:.3f} s ({phases_line(imports_s, sc.phases)}); "
        f"{card_line() if device == 'cuda' else device}")
    metrics, breakdown, tr = {}, None, None
    if trace:
        tr = sc.traced(float(traffic["trace_seconds"]))
        log(f"traced stretch: calls {tr['batches']}, device busy "
            f"{tr['trace']['busy_s']:.4f} of {tr['trace']['window_s']:.4f} s")
        ctx = SimpleNamespace(
            kind="serve", cell=cell, traffic=traffic, config=sc.config,
            config_dict=config_file["config"], window=w, trace=tr["trace"],
            launches=tr["launches"], batches=tr["batches"],
            images_per_s=w["serve_img_s"], stats=st,
            enqueue_ms=sc.enqueue_ms())
        metrics = read_layer(bench, cell, ctx)
        breakdown = {"device_ops": tr["trace"]["device_ops"],
                     "idle_gaps": tr["trace"]["idle_gaps"]}
    else:
        metrics = {"serve_img_s": {"value": w["serve_img_s"],
                                   "unit": "img/s"},
                   "serve_p95_ms": {"value": w["serve_p95_ms"],
                                    "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items()
                   if k in bench.e2e(cell["name"])}
    peak = w["peak_bytes"]
    sc.free()
    picks = sc.sample(w["answers"])
    numbers = sc.reference(picks, w["answers"])
    numbers["compared"] = float(len(picks))
    correct, checks = compare.judge(numbers, limits)
    checks["failed_requests"] = {"value": w["failed"], "limit": 0}
    correct = correct and w["failed"] == 0
    return {"correct": correct, "attempted": w["attempted"],
            "failed": w["failed"], "metrics": metrics,
            "device": device_info(cell["chips"], peak,
                                  tr["trace"] if trace else None, device),
            "breakdown": breakdown, "checks": checks}


def calibrate_serve(bench, cell, config_file, traffic, seeds, controls,
                    faults, seconds):
    """Readings for the limits: per seed, a short window at the cell's
    load and the answers' numbers; the control's on ``controls``; each
    fault's on ``controls``."""
    runs = [(s, None) for s in seeds] + [(s, f) for f in faults
                                         for s in controls]
    for seed, fault in runs:
        sc = ServeCell(cell, config_file, traffic, seed, fault=fault)
        sc.setup()
        w = sc.window(seconds)
        sc.free()
        picks = sc.sample(w["answers"])
        row = {"seed": seed, "kind": fault or "program",
               "compared": len(picks), "serve_img_s": w["serve_img_s"],
               **sc.reference(picks, w["answers"])}
        yield row
        if fault is None and seed in controls:
            yield {"seed": seed, "kind": "control", "compared": len(picks),
                   **sc.reference(picks, w["answers"], control=True)}
