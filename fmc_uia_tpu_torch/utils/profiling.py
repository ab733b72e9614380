"""Profiling and step-timing instrumentation (port of
``fmc_uia_tpu/utils/profiling.py``).

  * ``ProfileTrace``: a config-driven ``torch.profiler`` window around a
    step range, written as a Chrome trace into its directory.
  * ``StepTimer``: per-step wall times in windows, with throughput and
    median summaries; it waits for the device only at window ends.
  * ``span``: the program's spans (``SPANS``), recorded in memory between
    ``record()`` and ``stop()`` on the Unix-epoch nanosecond clock that
    ``torch.profiler``'s (kineto's) events carry, so that a span can be
    laid over a device trace of the same stretch. Off by default; off,
    ``span`` returns one shared null context and reads no clock.

Config keys (all optional):
  training.profile.enabled: bool
  training.profile.dir: str (default <experiment dir>/profile)
  training.profile.start_step / stop_step: ints
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np


class ProfileTrace:
    """Start/stop a ``torch.profiler`` trace across a step window."""

    def __init__(self, config, default_dir: str):
        prof = config.get("training.profile", {}) or {}
        self.enabled = bool(prof.get("enabled", False))
        self.trace_dir = str(prof.get("dir", default_dir))
        self.start_step = int(prof.get("start_step", 5))
        self.stop_step = int(prof.get("stop_step", 15))
        self._prof = None

    def maybe_start(self, step: int) -> None:
        if self.enabled and self._prof is None and step == self.start_step:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.stop_step:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.trace_dir, f"trace_{self.start_step}_{self.stop_step}"
                ".json"))


class StepTimer:
    """Windowed step-time collector with median summaries.

    Steps are timed in windows of ``window`` dispatches with ONE wait for
    the device at each boundary (``lap(sync)``): waiting after every step
    would serialize the host's enqueue with the device. Each sample is the
    mean step time of its window; the median is over window means. The
    first window (warm-up) is dropped, and a window that ran a task type's
    first step (``taint``) is not recorded.
    """

    def __init__(self, window: int = 8, skip_windows: int = 1):
        self.window = max(1, int(window))
        self.skip_windows = int(skip_windows)
        self._times: List[float] = []
        self._laps = 0
        self._nwin = 0
        self._t0: Optional[float] = None
        self._tainted = False

    def lap(self, sync=None, taint: bool = False) -> None:
        """Called once per step with a zero-arg device wait; only every
        ``window``-th call waits and records."""
        if taint:
            self._tainted = True
        self._laps += 1
        if self._laps % self.window:
            return
        if sync is not None:
            sync()
        now = time.perf_counter()
        if self._t0 is not None:
            self._nwin += 1
            if self._nwin > self.skip_windows and not self._tainted:
                self._times.append((now - self._t0) / self.window)
        self._t0 = now
        self._tainted = False

    def summary(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        out = {
            "steps": len(arr) * self.window,
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
        }
        if batch_size:
            out["images_per_sec"] = batch_size / out["p50_s"]
        return out

    def reset(self) -> None:
        self._times.clear()
        self._laps = 0
        self._nwin = 0
        self._t0 = None


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
# Every span the program opens, by name, and what it covers. Names are
# these constants, never built by formatting.
SPANS = {
    "train.step": "one Trainer.train_batch call (ids: step)",
    "train.prep": "put_batch, zeroing the grads, the flips and train_prep",
    "train.forward": "the model's forward and the loss",
    "train.backward": "total.backward()",
    "train.update": "the grads' reduction and clip, and the optimizer step "
                    "(under accumulation: the accumulator's add too)",
    "serve.request": "StreamingPredictor.submit -> the future fulfilled "
                     "(ids: request)",
    "serve.queue": "submit -> taken by the dispatcher (ids: request, task)",
    "serve.dispatch": "the requests taken -> predict_device returned (ids: "
                      "dispatch, requests, n_real, size)",
    "serve.inflight_wait": "the dispatcher waiting for an in-flight slot, "
                           "inside serve.dispatch (ids: dispatch)",
    "serve.flight": "predict_device returned -> the answers on the host, "
                    "on the completion thread (ids: dispatch)",
    "serve.idle": "the dispatcher waiting for work",
    "kernel.K1f": "the fused Swin attention branch's forward launch",
    "kernel.K1b": "the fused Swin attention branch's backward launch",
    "kernel.K2f": "the fused Swin MLP branch's forward launch",
    "kernel.K2b": "the fused Swin MLP branch's backward launch",
    "kernel.K3": "the fused augmentation and normalisation launch",
    "kernel.K4f": "the ViT global attention's forward launch",
    "kernel.K4b": "the ViT global attention's backward launch",
}
SPAN_LIMIT = 200_000  # records kept by default; the rest are counted


class SpanRecord(NamedTuple):
    """One span: start and end in Unix-epoch ns, the OS thread id of the
    thread that closed it (``threading.get_native_id()``), its id and its
    parent's (the span open on the same thread when it opened, None at
    the top or for a span timed by its caller), and its ids (or None)."""
    name: str
    start_ns: int
    end_ns: int
    tid: int
    id: int
    parent: Optional[int]
    ids: Optional[Dict]


class Recorded(NamedTuple):
    """What ``stop()`` returns: the records in the order they closed, the
    count dropped at the bound, and each recording thread's OS id mapped
    to its ``threading.get_ident()``."""
    records: List[SpanRecord]
    dropped: int
    threads: Dict[int, int]


class _Recording:
    """One recording. Adding a record takes no lock: under the interpreter
    lock ``next`` on a counter and ``list.append`` are atomic, so the
    bound and the count of drops hold whatever the threads."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self.records: List[tuple] = []  # SpanRecord's fields
        self.threads: Dict[int, int] = {}
        self.ids = itertools.count(1)
        self.added = itertools.count()
        self.open = True

    def add(self, name, start_ns, end_ns, tid, sid, parent, ids) -> None:
        if not self.open:
            return
        if tid not in self.threads:
            self.threads[tid] = threading.get_ident()
        if next(self.added) < self.limit:
            self.records.append((name, start_ns, end_ns, tid, sid, parent,
                                 ids or None))

    def close(self) -> Recorded:
        self.open = False
        n = next(self.added)
        return Recorded([SpanRecord._make(r) for r in self.records[:n]],
                        max(0, n - self.limit), dict(self.threads))


_recording: Optional[_Recording] = None  # None: recording is off
_clock = time.time_ns  # the span clock: kineto's events carry epoch ns
_NULL = contextlib.nullcontext()
_local = threading.local()


def _thread():
    """This thread's OS id and its stack of open span ids."""
    try:
        return _local.state
    except AttributeError:
        _local.state = (threading.get_native_id(), [])
        return _local.state


class _Span:
    __slots__ = ("rec", "name", "ids", "id", "parent", "start", "tid",
                 "stack")

    def __init__(self, rec: _Recording, name: str, ids: Dict):
        self.rec, self.name, self.ids = rec, name, ids

    def __enter__(self):
        self.tid, stack = _thread()
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec.ids)
        stack.append(self.id)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = _clock()
        self.stack.pop()
        self.rec.add(self.name, self.start, end, self.tid, self.id,
                     self.parent, self.ids)
        return False


def span(name: str, **ids):
    """A context manager timing ``name`` (one of ``SPANS``) with ``ids``
    (a request, a step, a dispatch). While recording is off it returns a
    shared null context: one flag read, no clock read, no record."""
    rec = _recording
    if rec is None:
        return _NULL
    return _Span(rec, name, ids)


def now_ns() -> int:
    """The span clock (Unix-epoch ns) while recording, else 0 without
    reading it: the start of a span that ``add_span`` closes later."""
    return 0 if _recording is None else _clock()


def add_span(name: str, start_ns: int, **ids) -> None:
    """Record ``name`` from ``start_ns`` (a ``now_ns()`` reading, taken on
    any thread) to now, on this thread; nothing where recording is off or
    ``start_ns`` was read while it was off (0)."""
    rec = _recording
    if rec is None or not start_ns:
        return
    rec.add(name, start_ns, _clock(), _thread()[0], next(rec.ids), None,
            ids)


def record(limit: int = SPAN_LIMIT) -> None:
    """Start recording spans, keeping at most ``limit`` records."""
    global _recording
    if _recording is not None:
        raise RuntimeError("spans are already being recorded")
    _recording = _Recording(limit)


def stop() -> Recorded:
    """Stop recording and return what was recorded. A span still open
    when recording stops is not recorded."""
    global _recording
    rec, _recording = _recording, None
    if rec is None:
        return Recorded([], 0, {})
    return rec.close()
