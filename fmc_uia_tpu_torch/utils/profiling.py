"""Profiling and step-timing instrumentation (port of
``fmc_uia_tpu/utils/profiling.py``).

  * ``ProfileTrace``: a config-driven ``torch.profiler`` window around a
    step range, written as a Chrome trace into its directory.
  * ``StepTimer``: per-step wall times in windows, with throughput and
    percentile summaries; it waits for the device only at window ends.

Config keys (all optional):
  training.profile.enabled: bool
  training.profile.dir: str (default <experiment dir>/profile)
  training.profile.start_step / stop_step: ints
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

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
    """Windowed step-time collector with percentile summaries.

    Steps are timed in windows of ``window`` dispatches with ONE wait for
    the device at each boundary (``lap(sync)``): waiting after every step
    would serialize the host's enqueue with the device. Each sample is the
    mean step time of its window; percentiles are over window means. The
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
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
        }
        if batch_size:
            out["images_per_sec"] = batch_size / out["p50_s"]
            out["p50_per_image_ms"] = out["p50_s"] / batch_size * 1e3
        return out

    def reset(self) -> None:
        self._times.clear()
        self._laps = 0
        self._nwin = 0
        self._t0 = None
