"""The device trace of a stretch with the program's spans laid over it.

``SpanTrace`` is ``trace.Trace`` with the program's span recorder
(``fmc_uia_tpu_torch/utils/profiling.py``) switched on between ``begin()``
and ``end()``, or, given ``spans=False``, the same stretch with it off.
``reduce_spans()`` reads the profiler's raw (kineto) events, whose times
are Unix-epoch ns like the spans', and hands them with the spans to
``name_gaps``, a pure function:

* ``busy_s``, ``device_span_s``, ``group_s`` and ``device_ops`` as
  ``Trace.reduce`` computes them;
* ``idle_gaps``: the device's 200 longest idle gaps, each named by the
  first of: (1) the innermost host event (a CUDA runtime call) at its
  middle; (2) the innermost span open at its middle on the thread that
  launched the device operation ending the gap (by correlation id);
  (3) the innermost span open there on any thread; (4) "host between
  calls". A request's lifetime spans (``LIFETIMES``) name no gap;
* ``kernel_by_span``: the device seconds of the operations launched from
  inside each ``kernel.*`` span (by correlation id and thread), the
  evidence that a kernel's device time can be found by its wrapper's
  span rather than by name fragments (``kernel_groups.json``), and
  ``kernel_missed``: a name group's seconds that no wrapper span holds.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from perfbench.trace import TOP, Trace, _union, group_of

BETWEEN = "host between calls"
GAPS = 200  # the longest idle gaps that are named
# a request's lifetime (submit to answer, submit to dispatch): what it
# waited in, not what a thread did, so these name no gap
LIFETIMES = ("serve.request", "serve.queue")

# (name, start_ns, end_ns, correlation id)
DeviceOp = Tuple[str, int, int, int]
# (name, start_ns, end_ns, the calling thread as the profiler names it,
# correlation id): kineto's resource id, which for a CUDA runtime call is
# the thread's id as CUPTI gives it (``start_thread_id()`` is the thread
# that parsed the trace, for every event with no CPU op above it)
HostOp = Tuple[str, int, int, int, int]


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def kineto_events(prof) -> Tuple[List[DeviceOp], List[HostOp]]:
    """The device operations and the host events (CUDA runtime calls) of
    a ``torch.profiler.profile`` that has stopped, in epoch ns."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a = int(e.start_ns())
        b = a + int(e.duration_ns())
        if _is_device(e):
            dev.append((e.name(), a, b, int(e.correlation_id())))
        else:
            host.append((e.name(), a, b, int(e.device_resource_id()),
                         int(e.correlation_id())))
    return dev, host


def thread_map(host_tids, threads: Dict[int, int]) -> Dict[int, int]:
    """The profiler's id of each host event's thread -> the OS thread id
    the spans carry. CUPTI names a thread by its ``pthread_self()`` cut to
    32 bits (``threading.get_ident()``'s low 32 bits, read signed)."""
    low = {ident & 0xFFFFFFFF: native for native, ident in threads.items()}
    return {k: low[k & 0xFFFFFFFF] for k in set(host_tids)
            if k & 0xFFFFFFFF in low}


class _Open:
    """The innermost of a set of intervals holding a point."""

    def __init__(self, items: Sequence[Tuple[str, int, int]]):
        self.name = [n for n, _, _ in items]
        self.a = np.array([a for _, a, _ in items], dtype=np.int64)
        self.b = np.array([b for _, _, b in items], dtype=np.int64)

    def at(self, t: float) -> Optional[str]:
        inside = np.nonzero((self.a <= t) & (self.b >= t))[0]
        if inside.size == 0:
            return None
        return self.name[inside[np.argmin((self.b - self.a)[inside])]]


def name_gaps(dev: Sequence[DeviceOp], host: Sequence[HostOp],
              spans=(), threads: Optional[Dict[int, int]] = None) -> Dict:
    """The reduction of one traced stretch (module docstring). ``spans``:
    the recorder's records; ``threads``: its OS id -> ident map."""
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ns, gaps = _union([(a, b) for _, a, b, _ in dev])
    group = defaultdict(float)
    ops = defaultdict(float)
    for name, a, b, _ in dev:
        group[group_of(name)] += (b - a) / 1e9
        ops[name] += (b - a) / 1e9
    runtime = _Open([(n, a, b) for n, a, b, _, _ in host])
    tmap = thread_map([h[3] for h in host], threads or {})
    launch = {}  # correlation id -> (the launching thread, its call's start)
    for _, a, _, tid, c in host:
        # a blocked launch's "Command Buffer Full" shares its correlation
        # id under thread 0: the call from a known thread wins
        if c and launch.get(c, (None,))[0] is None:
            launch[c] = (tmap.get(tid), a)
    work = [r for r in spans if r.name not in LIFETIMES]
    by_thread = defaultdict(list)
    for r in work:
        by_thread[r.tid].append((r.name, r.start_ns, r.end_ns))
    on_thread = {t: _Open(v) for t, v in by_thread.items()}
    anywhere = _Open([(r.name, r.start_ns, r.end_ns) for r in work])
    starts = sorted((a, c) for _, a, _, c in dev)
    idx = np.array([a for a, _ in starts], dtype=np.int64)

    def ending(b: int) -> int:
        """The correlation id of the operation that starts at ``b``."""
        i = int(np.searchsorted(idx, b, side="left"))
        return starts[min(i, len(starts) - 1)][1]

    def doing(a: int, b: int) -> str:
        mid = 0.5 * (a + b)
        name = runtime.at(mid)
        if name is not None:
            return name
        tid, _ = launch.get(ending(b), (None, None))
        if tid in on_thread:
            name = on_thread[tid].at(mid)
            if name is not None:
                return name
        return anywhere.at(mid) or BETWEEN

    by_span, missed = kernel_by_span(dev, launch, spans)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = defaultdict(float)
    for a, b in gaps[:GAPS]:
        idle[doing(a, b)] += (b - a) / 1e9
    return {
        "busy_s": busy_ns / 1e9,
        "device_span_s": (max(b for _, _, b, _ in dev)
                          - min(a for _, a, _, _ in dev)) / 1e9,
        "group_s": dict(group),
        "device_ops": sorted(([k, v] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
        "kernel_by_span": by_span,
        "kernel_missed": missed,
        "threads_mapped": len(tmap),
    }


def kernel_by_span(dev: Sequence[DeviceOp], launch: Dict, spans
                   ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Device seconds of the operations launched inside a ``kernel.*``
    span on the launching thread, by the kernel's id (``K1f``, ...); and
    of the operations of a hand-written kernel's name group that were
    not, by group and why (no launch recorded, a thread with no kernel
    span, launched outside every kernel span)."""
    mine = defaultdict(list)
    for r in spans:
        if r.name.startswith("kernel."):
            mine[r.tid].append((r.name[len("kernel."):], r.start_ns,
                                r.end_ns))
    inside = {t: _Open(v) for t, v in mine.items()}
    out, missed = defaultdict(float), defaultdict(float)
    for name, a, b, c in dev:
        tid, t = launch.get(c, (None, None))
        k = inside[tid].at(t) if tid in inside else None
        if k is not None:
            out[k] += (b - a) / 1e9
            continue
        g = group_of(name)
        if g.startswith("K"):
            why = ("no launch" if t is None else "thread" if tid not in
                   inside else "outside")
            missed[f"{g} {why}"] += (b - a) / 1e9
    return dict(out), dict(missed)


class SpanTrace(Trace):
    """``Trace`` with the program's spans recorded over the stretch
    (``spans=True``), or the same stretch with the recorder off."""

    def __init__(self, torch_mod, spans: bool = True):
        super().__init__(torch_mod)
        self.spans_on = bool(spans)
        self.recorded = None

    def begin(self) -> None:
        super().begin()
        if self.spans_on:
            from fmc_uia_tpu_torch.utils import profiling

            profiling.record()

    def end(self) -> None:
        """As ``Trace.end``; the stretch's length is read before the
        recorder hands its records over."""
        if not self.spans_on:
            super().end()
            return
        from fmc_uia_tpu_torch.utils import profiling

        self.torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.recorded = profiling.stop()
        super().end()
        self.window_s = window_s

    def reduce_spans(self) -> Dict:
        dev, host = kineto_events(self.prof)
        rec = self.recorded
        out = name_gaps(dev, host, rec.records if rec else (),
                        rec.threads if rec else None)
        out["window_s"] = self.window_s
        out["spans_dropped"] = rec.dropped if rec else 0
        return out
