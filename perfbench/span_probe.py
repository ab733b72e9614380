"""The program's spans over a cell's traced stretch, on the card, with the
stretch run in turns with the span recorder off and on.

    python3 perfbench/span_probe.py --workload <cell> --seed <n> \\
        [--pairs 3] [--out chiprun_out/spans]

Set-up is the cell's own (``train_cell.py``, ``serve_cell.py``); no timed
window and no comparison follow it. Then ``--pairs`` pairs of traced
stretches as ``TrainCell.traced`` and ``ServeCell.traced`` run them (the
profiler warmed up first, the cell's ``trace_rounds`` or
``trace_seconds``), off then on, on then off, and so on. Each stretch
gives its rate under the profiler, the device-trace per-layer metrics of
the cell (``trace.py``'s reduction, unchanged) and, with the spans on,
the span metrics (``readers/span.py``), the idle gaps named by span
(``span_trace.name_gaps``), each hand-written kernel's device seconds by
its wrapper's span beside its name group's, and the checks: the phases
against the step, the ``kernel.*`` spans against ``.launches``, and for
serving the median ``serve.request`` against the closed loop's own
latency median over the same requests. Prints one JSON line of each
number's median and range over the stretches, spans off and on apart,
and writes every stretch whole to ``<out>/<cell>.<seed>.json``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
    ROOT, "build", "perfbench", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
    ROOT, "build", "perfbench", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

TRAIN = ("train.step_host_ms", "train.prep_host_ms",
         "train.forward_host_ms", "train.backward_host_ms",
         "train.update_host_ms", "kernels.host_ms.train")
SERVE = ("serve.queue_p95_ms", "serve.flight_ms", "serve.inflight_wait_ms",
         "serve.dispatch_host_ms")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def launches():
    """Every hand-written kernel's ``.launches``, by span name."""
    from fmc_uia_tpu_torch.ops import preprocess

    from perfbench.train_cell import launch_counters

    out = {f"kernel.{k}": v for k, v in launch_counters().items()}
    out["kernel.K3"] = preprocess.augment_normalize.launches
    return out


def device_metrics(bench, cell, ctx):
    """The cell's per-layer metrics read from the device trace."""
    from perfbench import core

    out = {}
    for m in bench.layer(cell["name"]):
        if m["source"] == "device_trace":
            fn, kwargs = core.reader(m, bench)
            v = fn(ctx, **kwargs)
            if v is not None:
                out[m["name"]] = v
    return out


def named_share(gaps) -> float:
    """The share of the listed idle seconds not under "host between
    calls"."""
    from perfbench.span_trace import BETWEEN

    total = sum(s for _, s in gaps)
    return (1.0 - sum(s for n, s in gaps if n == BETWEEN) / total
            if total else 1.0)


def checks(records, c0, c1, within=None):
    """The four phases' sum over the steps' sum, and each kernel span's
    count against its ``.launches`` delta (the spans that began
    ``within`` the two counter reads, where those were not taken at the
    recording's ends)."""
    steps = sum(r.end_ns - r.start_ns for r in records
                if r.name == "train.step")
    phases = sum(r.end_ns - r.start_ns for r in records
                 if r.name in ("train.prep", "train.forward",
                               "train.backward", "train.update"))
    count = {}
    lo, hi = within or (0, float("inf"))
    for r in records:
        if r.name.startswith("kernel.") and lo <= r.start_ns <= hi:
            count[r.name] = count.get(r.name, 0) + 1
    return {"phases_over_step": phases / steps if steps else None,
            "kernel_spans": count,
            "launches": {k: c1[k] - c0[k] for k in c1 if c1[k] > c0[k]}}


def reduce(bench, cell, trace, ctx, c0, c1, metrics, within=None):
    """One stretch's numbers (module docstring)."""
    from perfbench.readers import span as span_reader

    tr = ctx.trace
    out = {"spans": trace.spans_on, "window_s": tr["window_s"],
           "busy_s": tr["busy_s"], "idle_gaps": tr["idle_gaps"],
           "device": device_metrics(bench, cell, ctx)}
    if trace.spans_on:
        sp = trace.reduce_spans()
        recs = trace.recorded.records
        out.update(
            span_metrics={m: span_reader.value(recs, m) for m in metrics},
            span_busy_s=sp["busy_s"], span_idle_gaps=sp["idle_gaps"],
            named_share_trace=named_share(tr["idle_gaps"]),
            named_share_spans=named_share(sp["idle_gaps"]),
            kernel_by_span=sp["kernel_by_span"],
            kernel_missed=sp["kernel_missed"],
            group_s={k: v for k, v in tr["group_s"].items()
                     if k.startswith("K")},
            threads_mapped=sp["threads_mapped"],
            threads=len(trace.recorded.threads),
            records=len(recs), dropped=sp["spans_dropped"],
            **checks(recs, c0, c1, within))
    return out


def train_pairs(bench, cell, config_file, traffic, seed, pairs):
    import torch

    from perfbench.span_trace import SpanTrace
    from perfbench.train_cell import TrainCell

    tc = TrainCell(cell, config_file, traffic, seed)
    tc.setup()
    log(f"set-up {time.perf_counter() - T_START:.3f} s")
    rounds = int(traffic["trace_rounds"])
    steps = rounds * tc.types
    out = []
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            trace = SpanTrace(torch, spans=on)
            trace.start()
            for _ in range(tc.types):
                tc._one()
            trace.begin()
            c0 = launches()
            for _ in range(steps):
                tc._one()
            trace.end()
            c1 = launches()
            ctx = SimpleNamespace(
                kind="train", cell=cell, traffic=traffic, config=tc.config,
                config_dict=config_file["config"], trace=trace.reduce(),
                launches={k[len("kernel."):]: c1[k] - c0[k] for k in c1},
                batches={tc.B: steps})
            row = reduce(bench, cell, trace, ctx, c0, c1, TRAIN)
            row["img_s"] = steps * tc.B / trace.window_s
            out.append(row)
            log(json.dumps({k: row.get(k) for k in (
                "spans", "img_s", "span_metrics", "named_share_spans")}))
    tc.free()
    return out


def serve_stretch(bench, cell, sc, trace_s, on):
    """One traced stretch of the closed loop, as ``ServeCell.traced``,
    with every request's submit and answer times (epoch ns)."""
    import torch

    from perfbench.span_trace import SpanTrace

    svc, pred = sc.svc, sc.svc.predictor
    predict, lock, calls = pred.predict_device, threading.Lock(), {}
    submit, done = svc.submit, []

    def counted(images, task_id):
        with lock:
            out = predict(images, task_id)
            calls[len(images)] = calls.get(len(images), 0) + 1
        return out

    def timed(image, task_id):
        t = time.time_ns()
        f = submit(image, task_id)
        f.add_done_callback(lambda f, t=t: done.append((t, time.time_ns())))
        return f

    def read():
        with lock:
            return dict(calls), launches(), time.time_ns()

    trace = SpanTrace(torch, spans=on)
    marks = {}

    def hook(t):
        if "begin" not in marks and t >= 1.0:
            trace.begin()
            marks["begin"] = read()
            marks["t0"] = time.time_ns()
        elif "end" not in marks and "begin" in marks and t >= 1.0 + trace_s:
            marks["t1"] = time.time_ns()
            marks["end"] = read()
            trace.end()

    pred.predict_device, svc.submit = counted, timed
    try:
        trace.start()
        sc._loop(1.0 + trace_s + 0.5, hook)
    finally:
        pred.predict_device = predict
        del svc.submit
    (b0, c0, l0), (b1, c1, l1) = marks["begin"], marks["end"]
    batches = {s: b1[s] - b0.get(s, 0) for s in b1 if b1[s] > b0.get(s, 0)}
    ctx = SimpleNamespace(
        kind="serve", cell=cell, traffic=sc.traffic, config=sc.config,
        config_dict=sc.config_dict, trace=trace.reduce(),
        launches={k[len("kernel."):]: c1[k] - c0[k] for k in c1},
        batches=batches)
    row = reduce(bench, cell, trace, ctx, c0, c1, SERVE, (l0, l1))
    t0, t1 = marks["t0"], marks["t1"]
    row["img_s"] = sum(1 for _, b in done if t0 <= b <= t1) / (
        (t1 - t0) / 1e9)
    if on:
        _serve_checks(row, trace.recorded.records, done)
    return row


def _serve_checks(row, records, done):
    """The median ``serve.request`` against the loop's own latency
    median over the requests submitted and answered inside the
    recording, and ``serve.queue``'s p95 by task."""
    from perfbench import core

    req = [r for r in records if r.name == "serve.request"]
    lo = min(r.start_ns for r in req)
    hi = max(r.end_ns for r in req)
    loop = [(b - a) / 1e6 for a, b in done if lo <= a and b <= hi]
    by_task = {}
    for r in records:
        if r.name == "serve.queue":
            by_task.setdefault(r.ids["task"], []).append(
                (r.end_ns - r.start_ns) / 1e6)
    row.update(
        request_p50_ms=core.percentile(
            [(r.end_ns - r.start_ns) / 1e6 for r in req], 50),
        loop_p50_ms=core.percentile(loop, 50), requests=len(req),
        loop_requests=len(loop),
        queue_p95_by_task={t: core.percentile(v, 95)
                           for t, v in sorted(by_task.items())})


def serve_pairs(bench, cell, config_file, traffic, seed, pairs):
    from perfbench.serve_cell import ServeCell

    sc = ServeCell(cell, config_file, traffic, seed)
    sc.setup()
    log(f"set-up {time.perf_counter() - T_START:.3f} s")
    out = []
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            row = serve_stretch(bench, cell, sc, float(
                traffic["trace_seconds"]), on)
            out.append(row)
            log(json.dumps({k: row.get(k) for k in (
                "spans", "img_s", "span_metrics", "named_share_spans",
                "request_p50_ms", "loop_p50_ms")}))
    sc.free()
    return out


def summary(rows):
    """Each number's median (and range) over the stretches, spans off and
    on apart."""
    from perfbench import core

    def stat(vals):
        vals = [v for v in vals if v is not None]
        if not vals:
            return None
        return [core.percentile(vals, 50), min(vals), max(vals)]

    out = {}
    for on in (False, True):
        mine = [r for r in rows if r["spans"] == on]
        side = {"img_s": stat([r["img_s"] for r in mine])}
        for m in mine[0]["device"]:
            side[m] = stat([r["device"].get(m) for r in mine])
        if on:
            for m in mine[0]["span_metrics"]:
                side[m] = stat([r["span_metrics"][m] for r in mine])
            for k in ("named_share_trace", "named_share_spans",
                      "phases_over_step", "request_p50_ms", "loop_p50_ms"):
                side[k] = stat([r.get(k) for r in mine])
        out["on" if on else "off"] = side
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "spans"))
    args = ap.parse_args(argv)
    import torch

    from perfbench import cells, core

    if not torch.cuda.is_available():
        log("span_probe: no CUDA device: no result")
        return 3
    bench = core.Bench(ROOT)
    cell = bench.cell(args.workload)
    traffic = bench.traffic(cell)
    config_file = bench.config(cell["config"])
    run = (train_pairs if traffic["kind"] == "train_staged"
           else serve_pairs)
    rows = run(bench, cell, config_file, traffic, args.seed, args.pairs)
    result = {"cell": cell["name"], "seed": args.seed,
              "card": cells.card_line(), "stretches": rows}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{cell['name']}.{args.seed}.json"),
              "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"cell": cell["name"], "seed": args.seed,
                      "card": result["card"], **summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
