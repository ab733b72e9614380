"""Per-layer numbers read from the program's spans over the traced
stretch (``fmc_uia_tpu_torch/utils/profiling.py``, recorded by
``span_trace.SpanTrace``), in ms. ``ctx.spans`` is the recorder's
``Recorded``; a run that recorded none (``ctx`` has no ``spans``, or the
program has no such span) reads nothing.

* ``train.step_host_ms``: the mean ``train.step`` over the stretch's
  steps, the card busy;
* ``train.{prep,forward,backward,update}_host_ms``: the phase's span time
  a step;
* ``kernels.host_ms.train``: the ``kernel.*`` spans' time a step (the
  hand-written kernels' wrappers, on whichever thread launched them);
* ``serve.queue_p95_ms``: the 95th percentile of ``serve.queue`` over the
  requests submitted in the stretch;
* ``serve.flight_ms``: the median ``serve.flight`` over the dispatches;
* ``serve.inflight_wait_ms``: the ``serve.inflight_wait`` time a dispatch;
* ``serve.dispatch_host_ms``: the median self time of ``serve.dispatch``
  (less its ``serve.inflight_wait``).
"""

from collections import defaultdict

from perfbench import core

PHASES = {"train.prep_host_ms": "train.prep",
          "train.forward_host_ms": "train.forward",
          "train.backward_host_ms": "train.backward",
          "train.update_host_ms": "train.update"}


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def _named(records, name):
    return [r for r in records if r.name == name]


def _per_step(records, pick):
    steps = len(_named(records, "train.step"))
    if not steps:
        return None
    return sum(_ms(r) for r in records if pick(r.name)) / steps


def _dispatch_self(records):
    wait = defaultdict(float)
    for r in _named(records, "serve.inflight_wait"):
        wait[r.parent] += _ms(r)
    return [_ms(r) - wait[r.id] for r in _named(records, "serve.dispatch")]


def value(records, metric: str):
    """The metric ``metric`` (module docstring) of a list of span
    records, or None where they hold nothing for it."""
    if metric == "train.step_host_ms":
        steps = [_ms(r) for r in _named(records, "train.step")]
        return sum(steps) / len(steps) if steps else None
    if metric in PHASES:
        return _per_step(records, lambda n: n == PHASES[metric])
    if metric == "kernels.host_ms.train":
        return _per_step(records, lambda n: n.startswith("kernel."))
    if metric == "serve.queue_p95_ms":
        vals = [_ms(r) for r in _named(records, "serve.queue")]
        return core.percentile(vals, 95) if vals else None
    if metric == "serve.flight_ms":
        vals = [_ms(r) for r in _named(records, "serve.flight")]
        return core.percentile(vals, 50) if vals else None
    if metric == "serve.inflight_wait_ms":
        n = len(_named(records, "serve.dispatch"))
        if not n:
            return None
        return sum(_ms(r) for r in _named(records,
                                          "serve.inflight_wait")) / n
    if metric == "serve.dispatch_host_ms":
        vals = _dispatch_self(records)
        return core.percentile(vals, 50) if vals else None
    raise KeyError(f"no span metric {metric!r}")


def read(ctx, metric: str):
    spans = getattr(ctx, "spans", None)
    if spans is None:
        return None
    return value(spans.records, metric)
