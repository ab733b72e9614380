"""The device trace of a short steady stretch of the window:
``torch.profiler`` over the stretch, reduced to what the readers take.

* ``busy_s``: the union of the device's activity intervals (kernels,
  copies, fills), so overlapping work counts once; ``window_s`` the
  stretch's length on the host clock, from a synchronised start to a
  synchronised end.
* ``group_s``: device seconds by kernel group, each kernel named into the
  first group of ``kernel_groups.json`` one of whose name fragments it
  holds, else into ``other``.
* ``device_ops`` / ``idle_gaps``: the breakdown of the result line: the
  device operations that took most time, and the longest idle gaps of
  the device, each named by the innermost host event recorded at its
  middle (a CUDA runtime call), else "host between calls".
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from perfbench.core import HERE, load_json

KERNEL_GROUPS = [(g["name"], tuple(g["fragments"]))
                 for g in load_json(os.path.join(
                     HERE, "kernel_groups.json"))["groups"]]
TOP = 10


def group_of(kernel_name: str) -> str:
    for name, frags in KERNEL_GROUPS:
        if any(f in kernel_name for f in frags):
            return name
    return "other"


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(covered length, the gaps between covered stretches)."""
    total, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


class Trace:
    """The profiler over a stretch of the window: ``start()`` enters it in
    its warm-up phase (its set-up cost falls there and is not recorded),
    ``begin()`` opens the recorded stretch, ``end()`` closes it; both
    synchronise the device. Only device activity (and the CUDA runtime
    calls that go with it) is recorded, which costs the host little."""

    def __init__(self, torch_mod):
        self.torch = torch_mod
        self.prof = None
        self.window_s = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1,
                                              repeat=1))
        self.prof.__enter__()

    def begin(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.step()
        self.t0 = time.perf_counter()

    def end(self) -> None:
        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.step()
        self.prof.__exit__(None, None, None)

    def reduce(self) -> Dict:
        events = self.prof.events()
        dev, host = [], []
        for e in events:
            tr = e.time_range
            if _is_device(e):
                dev.append((e.name, tr.start, tr.end))
            else:
                host.append((e.name, tr.start, tr.end))
        if not dev:
            raise RuntimeError("the profiler recorded no device activity")
        t_lo = min(a for _, a, _ in dev)
        busy_us, gaps = _union([(a, b) for _, a, b in dev])
        group_us = defaultdict(float)
        op_us = defaultdict(float)
        for name, a, b in dev:
            group_us[group_of(name)] += b - a
            op_us[name] += b - a
        h_name = [h[0] for h in host]
        h_a = np.array([h[1] for h in host], dtype=np.float64)
        h_b = np.array([h[2] for h in host], dtype=np.float64)

        def doing(t):
            """The innermost host operation running at ``t``."""
            inside = np.nonzero((h_a <= t) & (h_b >= t))[0]
            if inside.size == 0:
                return "host between calls"
            return h_name[inside[np.argmin((h_b - h_a)[inside])]]

        gaps.sort(key=lambda g: g[0] - g[1])
        idle = defaultdict(float)
        for a, b in gaps[:200]:
            idle[doing(0.5 * (a + b))] += (b - a) / 1e6
        return {
            "busy_s": busy_us / 1e6,
            "window_s": self.window_s,
            "device_span_s": (max(b for _, _, b in dev) - t_lo) / 1e6,
            "group_s": {k: v / 1e6 for k, v in group_us.items()},
            "device_ops": sorted(([k, v / 1e6] for k, v in op_us.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:TOP],
        }
