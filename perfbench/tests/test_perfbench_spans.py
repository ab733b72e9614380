"""The program's spans over a traced stretch: the gap naming of
``span_trace.name_gaps`` on synthetic events (each of its four rules, and
the device numbers the same with and without spans and as
``Trace.reduce`` gives them), ``readers/span.py`` on synthetic spans, and
on the card (``cuda``) the shared clock and the kernel spans against the
wrappers' ``.launches``."""

import time
from types import SimpleNamespace

import pytest

from fmc_uia_tpu_torch.utils.profiling import Recorded, SpanRecord
from perfbench.readers import span as span_reader
from perfbench.span_trace import (
    BETWEEN,
    kernel_by_span,
    name_gaps,
    thread_map,
)
from perfbench.trace import Trace


def rec(name, a, b, tid=11, sid=0, parent=None, **ids):
    return SpanRecord(name, a, b, tid, sid, parent, ids or None)


# device ops (name, start ns, end ns, correlation id): idle gaps
# (100, 300), (420, 1000), (1130, 2000) and (2140, 5000)
DEV = [("qkv_window_attn_a", 0, 100, 1), ("nvjet_b", 300, 420, 2),
       ("sm90::gemm_sm90_c", 1000, 1130, 3), ("elementwise_d", 2000, 2140, 4),
       ("qkv_window_attn_a", 5000, 5050, 5)]
# host events (name, start, end, profiler thread id, correlation id): the
# profiler names a thread by its ident's low 32 bits, read signed (thread
# 22's ident 0x7F0080000016 is -2147483626); thread 0 carries a blocked
# launch's "Command Buffer Full" under that launch's correlation id
HOST = [("cudaMemcpyAsync", 150, 250, 1011, 0),
        ("cudaLaunchKernel", 0, 5, 1011, 1),
        ("cudaLaunchKernel", 290, 295, 1011, 2),
        ("cudaLaunchKernel", 990, 994, -2147483626, 3),
        ("Command Buffer Full", 991, 993, 0, 3),
        ("cudaLaunchKernel", 1990, 1995, 1011, 4),
        ("cudaLaunchKernel", 4990, 4995, 33, 5)]
THREADS = {11: 1011, 22: 0x7F0080000016}
SPANS = [rec("train.forward", 350, 1050, tid=11),
         rec("train.prep", 650, 750, tid=11),
         rec("kernel.K1b", 600, 995, tid=22),
         rec("serve.idle", 1200, 1900, tid=22),
         rec("serve.queue", 1500, 1600, tid=22, request=0),
         rec("serve.request", 3000, 4000, tid=11, request=0)]


def test_each_naming_rule():
    """(1) the runtime call at the middle; (2) the innermost span on the
    launching thread (``kernel.K1b``, though ``train.prep`` on another
    thread is shorter); (3) the innermost span on any thread; (4) host
    between calls. A request's lifetime spans (``serve.queue``,
    ``serve.request``) name none, though they are open and shorter."""
    out = name_gaps(DEV, HOST, SPANS, THREADS)
    got = {k: round(v * 1e9) for k, v in out["idle_gaps"]}
    assert got == {"cudaMemcpyAsync": 200, "kernel.K1b": 580,
                   "serve.idle": 870, BETWEEN: 2860}
    assert out["threads_mapped"] == 2


def test_without_spans_only_runtime_calls_name_gaps():
    out = name_gaps(DEV, HOST)
    got = {k: round(v * 1e9) for k, v in out["idle_gaps"]}
    assert got == {"cudaMemcpyAsync": 200, BETWEEN: 4310}


def test_device_numbers_do_not_depend_on_spans():
    a, b = name_gaps(DEV, HOST), name_gaps(DEV, HOST, SPANS, THREADS)
    for key in ("busy_s", "device_span_s", "group_s", "device_ops"):
        assert a[key] == b[key], key
    assert a["busy_s"] == pytest.approx(540e-9)
    assert a["group_s"]["K1f"] == pytest.approx(150e-9)


class _Ev:
    def __init__(self, name, a, b, device):
        self.name = name
        self.time_range = SimpleNamespace(start=a, end=b)
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"


def test_same_numbers_as_the_trace_reduction():
    """Without spans, ``name_gaps`` on ns gives what ``Trace.reduce``
    gives on the same events in µs."""
    tr = Trace(None)
    tr.window_s = 1.0
    tr.prof = SimpleNamespace(events=lambda: (
        [_Ev(n, a / 1e3, b / 1e3, True) for n, a, b, _ in DEV]
        + [_Ev(n, a / 1e3, b / 1e3, False) for n, a, b, _, _ in HOST]))
    want = tr.reduce()
    got = name_gaps(DEV, HOST)
    for key in ("busy_s", "device_span_s"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    assert got["group_s"].keys() == want["group_s"].keys()
    for k, v in want["group_s"].items():
        assert got["group_s"][k] == pytest.approx(v, rel=1e-12)
    for key in ("device_ops", "idle_gaps"):
        assert [n for n, _ in got[key]] == [n for n, _ in want[key]]
        assert [v for _, v in got[key]] == pytest.approx(
            [v for _, v in want[key]], rel=1e-12)


def test_thread_map_reads_the_low_32_bits():
    assert thread_map([1011, -2147483626, 0, 33], THREADS) == {
        1011: 11, -2147483626: 22}


def test_kernel_device_time_by_wrapper_span():
    """Only the op launched inside ``kernel.K1b`` on its own thread
    counts, by its correlation id."""
    launch = {3: (22, 990), 2: (11, 290), 5: (None, 4990)}
    by_span, missed = kernel_by_span(DEV, launch, SPANS)
    assert by_span == {"K1b": 130e-9}
    # op 1 (K1f) has no launch recorded, op 5 (K1f) an unknown thread
    assert missed == {"K1f no launch": 100e-9, "K1f thread": 50e-9}
    assert kernel_by_span(DEV, launch, []) == (
        {}, {"K1f no launch": 100e-9, "K1f thread": 50e-9,
             "K1b thread": 130e-9})


def _train_records():
    out, sid = [], 0
    for s, t0 in enumerate((0, 10_000_000)):  # two 10 ms steps
        sid += 1
        step = sid
        out.append(rec("train.step", t0, t0 + 10_000_000, sid=step,
                       step=s))
        edges = (0, 1, 4, 8, 10)
        for name, a, b in zip(("train.prep", "train.forward",
                               "train.backward", "train.update"),
                              edges, edges[1:]):
            sid += 1
            out.append(rec(name, t0 + a * 1_000_000, t0 + b * 1_000_000,
                           sid=sid, parent=step))
        out.append(rec("kernel.K1f", t0 + 2_000_000, t0 + 2_500_000,
                       sid=sid + 1))
        out.append(rec("kernel.K1b", t0 + 5_000_000, t0 + 6_000_000,
                       tid=22, sid=sid + 2))
        sid += 2
    return out


def _serve_records():
    out = []
    for i in range(20):  # queue times 1..20 ms
        out.append(rec("serve.queue", 0, (i + 1) * 1_000_000, request=i,
                       task="T1"))
    # dispatches of 10, 12 and 20 ms holding waits of 2, 0 and 5 ms
    for d, (dur, wait) in enumerate(((10, 2), (12, 0), (20, 5))):
        out.append(rec("serve.dispatch", 0, dur * 1_000_000, sid=100 + d,
                       dispatch=d))
        if wait:
            out.append(rec("serve.inflight_wait", 0, wait * 1_000_000,
                           sid=200 + d, parent=100 + d, dispatch=d))
        out.append(rec("serve.flight", 0, (30 + 10 * d) * 1_000_000,
                       dispatch=d))
    return out


def test_span_readers_on_synthetic_spans():
    ctx = SimpleNamespace(spans=Recorded(_train_records() + _serve_records(),
                                         0, {}))
    want = {"train.step_host_ms": 10.0, "train.prep_host_ms": 1.0,
            "train.forward_host_ms": 3.0, "train.backward_host_ms": 4.0,
            "train.update_host_ms": 2.0, "kernels.host_ms.train": 1.5,
            "serve.queue_p95_ms": 19.05, "serve.flight_ms": 40.0,
            "serve.inflight_wait_ms": 7 / 3, "serve.dispatch_host_ms": 12.0}
    for metric, v in want.items():
        assert span_reader.read(ctx, metric) == pytest.approx(v), metric


def test_span_readers_find_nothing_without_spans():
    for metric in ("train.step_host_ms", "kernels.host_ms.train",
                   "serve.queue_p95_ms", "serve.dispatch_host_ms"):
        assert span_reader.read(SimpleNamespace(), metric) is None
        assert span_reader.read(SimpleNamespace(
            spans=Recorded([], 0, {})), metric) is None
    with pytest.raises(KeyError):
        span_reader.value([], "train.nothing")


@pytest.mark.cuda
def test_span_clock_is_the_trace_clock(card):
    """A span around ``torch.cuda._sleep`` between host sleeps holds that
    kernel's launch (its runtime call, by correlation id, on the span's
    thread), and a 20 ms host sleep inside a span names the idle gap it
    makes."""
    import torch

    from fmc_uia_tpu_torch.utils import profiling
    from perfbench.span_trace import SpanTrace, kineto_events

    tr = SpanTrace(torch)
    tr.start()
    torch.cuda._sleep(1000)
    tr.begin()
    torch.cuda._sleep(1000)
    time.sleep(0.005)
    with profiling.span("train.forward"):
        torch.cuda._sleep(20_000_000)
    torch.cuda.synchronize()
    with profiling.span("train.update"):
        time.sleep(0.02)
    torch.cuda._sleep(1000)
    time.sleep(0.005)
    tr.end()
    dev, host = kineto_events(tr.prof)
    recs = tr.recorded.records
    fwd = next(r for r in recs if r.name == "train.forward")
    long_op = max(dev, key=lambda d: d[2] - d[1])
    launch = [h for h in host if h[4] == long_op[3]]
    tmap = thread_map([h[3] for h in host], tr.recorded.threads)
    assert launch, (long_op, host[:8])
    assert fwd.start_ns <= launch[0][1] <= fwd.end_ns, (fwd, launch)
    assert tmap.get(launch[0][3]) == fwd.tid, (launch, tr.recorded.threads)
    out = tr.reduce_spans()
    top_name, top_s = out["idle_gaps"][0]
    assert top_name == "train.update" and top_s >= 0.019, out["idle_gaps"]


@pytest.mark.cuda
def test_kernel_spans_count_the_launches_on_the_card(card):
    """A small Swin train cell on the card: each ``kernel.*`` span count
    equals its wrapper's ``.launches`` delta, the fused attention's
    forward and backward among them."""
    from collections import Counter

    from fmc_uia_tpu_torch.utils import profiling
    from perfbench.span_probe import launches
    from perfbench.tests.tiny import tiny
    from perfbench.train_cell import TrainCell

    _, cell, cfg, traffic, _ = tiny("swin_b512.train")
    tc = TrainCell(cell, cfg, traffic, seed=2 ** 31 + 11, device="cuda")
    tc.setup()
    c0 = launches()
    profiling.record()
    for _ in range(tc.types):
        tc._one()
    out = profiling.stop()
    c1 = launches()
    tc.free()
    spans = Counter(r.name for r in out.records)
    assert {k: c1[k] - c0[k] for k in c1} == {k: spans[k] for k in c1}
    assert spans["kernel.K1f"] > 0 and spans["kernel.K1b"] > 0
