"""Streaming inference service: per-task micro-batching over the 4 task
types (port of ``fmc_uia_tpu/serving.py``).

Same design as the JAX service:

  * requests enter per-task queues; one dispatcher thread drains them
    into micro-batches, padding a partial batch up to the next size of a
    power-of-two chain (1, 2, 4, ..., max_batch) when ``autoscale`` is on,
    else up to ``max_batch``;
  * dispatch is asynchronous: the dispatcher enqueues the forward on the
    GPU and hands the in-flight result to a completion thread, which
    brings it to the host (``.cpu()``, the counterpart of
    ``np.asarray(dev)``) and fulfils the futures; ``max_inflight`` bounds
    the queued device work;
  * ``max_delay_ms`` bounds the added latency: a partial batch is flushed
    when its oldest request is that old;
  * ``stats`` counts dispatches, pad images and dispatches by padded size;
  * while spans are recorded (``utils/profiling.py``), each request gets
    ``serve.request`` and ``serve.queue`` under its request id, each
    dispatch ``serve.dispatch`` (with its ``serve.inflight_wait``) and
    ``serve.flight`` under its dispatch id, and the dispatcher's waits for
    work ``serve.idle``.

Usage:
    svc = StreamingPredictor(model, registry, mean, std, image_size,
                             max_batch=16, device="cuda")
    fut = svc.submit(image_u8_hwc, "T2A_fetal_abdomen")
    mask = fut.result()
    svc.close()
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import Counter
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

from fmc_uia_tpu_torch.export import Predictor
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.utils.profiling import add_span, now_ns, span


class StreamingPredictor:
    """Thread-safe micro-batching wrapper around ``Predictor``."""

    def __init__(self, model, registry: TaskRegistry, mean, std,
                 image_size: int, max_batch: int = 16,
                 max_delay_ms: float = 5.0, autoscale: bool = True,
                 max_inflight: int = 2, device="cuda"):
        self.predictor = Predictor(model, registry, mean, std, image_size,
                                   device=device)
        self.registry = registry
        self.image_size = int(image_size)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.autoscale = bool(autoscale)
        chain = []
        s = 1
        while s < self.max_batch:
            chain.append(s)
            s *= 2
        chain.append(self.max_batch)
        self._chain = chain
        self.stats = {"dispatches": 0, "pad_images": 0,
                      "by_size": Counter()}
        self._queues: Dict[str, "queue.Queue"] = {
            tid: queue.Queue() for tid in registry.task_ids}
        self._wake = threading.Event()
        self._request_ids = itertools.count()
        self._dispatch_ids = itertools.count()
        self._closed = False
        self._inflight = threading.Semaphore(max(1, int(max_inflight)))
        self._done_q: "queue.Queue" = queue.Queue()
        self._completer = threading.Thread(target=self._completion_loop,
                                           daemon=True)
        self._completer.start()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    # -- client API ----------------------------------------------------------
    def submit(self, image_u8: np.ndarray, task_id: str) -> Future:
        """image_u8: [S, S, 3] uint8, already resized to image_size."""
        if self._closed:
            raise RuntimeError("StreamingPredictor is closed")
        if task_id not in self._queues:
            raise KeyError(f"Unknown task_id {task_id!r}; have "
                           f"{sorted(self._queues)}")
        image_u8 = np.asarray(image_u8, np.uint8)
        want = (self.image_size, self.image_size, 3)
        if image_u8.shape != want:
            raise ValueError(f"image shape {image_u8.shape} != {want}; "
                             "resize on the client")
        fut: Future = Future()
        # (image, future, enqueue time, request id, span start)
        self._queues[task_id].put((image_u8, fut, time.monotonic(),
                                   next(self._request_ids), now_ns()))
        self._wake.set()
        return fut

    def warmup(self, task_ids=None, sizes=None) -> None:
        """Run every (task type, chain size) once outside the serving
        path: builds the kernels and fills the allocator's caches."""
        by_type = {}
        for tid in (task_ids or self.registry.task_ids):
            by_type.setdefault(self.registry[tid].task_name, tid)
        dummy = np.zeros((1, self.image_size, self.image_size, 3), np.uint8)
        for size in (sizes or self._chain):
            batch = np.repeat(dummy, size, axis=0)
            for tid in by_type.values():
                self.predictor.predict_images(batch, tid)

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=30)
        self._done_q.put(None)  # completer exits after draining
        self._completer.join(timeout=30)

    # -- dispatcher ----------------------------------------------------------
    def _ready_task(self) -> Optional[str]:
        """Pick the queue to serve: full batch first, else expired oldest."""
        now = time.monotonic()
        best, best_age = None, -1.0
        for tid, q in self._queues.items():
            n = q.qsize()
            if n >= self.max_batch:
                return tid
            if n > 0:
                try:
                    age = now - q.queue[0][2]
                except IndexError:
                    continue
                if age > best_age:
                    best, best_age = tid, age
        if best is not None and best_age >= self.max_delay_s:
            return best
        return None

    def _dispatch_loop(self) -> None:
        while True:
            tid = self._ready_task()
            if tid is None:
                if self._closed and all(
                        q.empty() for q in self._queues.values()):
                    return
                with span("serve.idle"):
                    self._wake.wait(timeout=self.max_delay_s / 2
                                    if self.max_delay_s > 0 else 0.001)
                self._wake.clear()
                if self._closed:
                    # drain whatever remains before exiting
                    tid = next((t for t, q in self._queues.items()
                                if not q.empty()), None)
                    if tid is None:
                        return
                else:
                    continue

            items = []
            q = self._queues[tid]
            while len(items) < self.max_batch:
                try:
                    items.append(q.get_nowait())
                except queue.Empty:
                    break
            if not items:
                continue
            for it in items:
                add_span("serve.queue", it[4], request=it[3], task=tid)
            n_real = len(items)
            if self.autoscale:
                target = next(s for s in self._chain if s >= n_real)
            else:
                target = self.max_batch
            did = next(self._dispatch_ids)
            with span("serve.dispatch", dispatch=did,
                      requests=[it[3] for it in items], n_real=n_real,
                      size=target):
                images = np.stack([it[0] for it in items])
                if n_real < target:
                    pad = np.repeat(images[-1:], target - n_real, axis=0)
                    images = np.concatenate([images, pad])
                self.stats["dispatches"] += 1
                self.stats["pad_images"] += target - n_real
                self.stats["by_size"][target] += 1
                with span("serve.inflight_wait", dispatch=did):
                    self._inflight.acquire()
                try:
                    dev = self.predictor.predict_device(images, tid)
                except Exception as e:  # dispatch failure
                    self._inflight.release()
                    for it in items:
                        if not it[1].done():
                            it[1].set_exception(e)
                    continue
            self._done_q.put((dev, items, n_real, did, now_ns()))

    def _completion_loop(self) -> None:
        """Bring device results to the host and fulfil futures, off the
        dispatch path — readback overlaps the next batch's forward."""
        while True:
            entry = self._done_q.get()
            if entry is None:
                return
            dev, items, n_real, did, returned = entry
            try:
                preds = dev[:n_real].cpu().numpy()
                add_span("serve.flight", returned, dispatch=did)
                for it, pred in zip(items, preds):
                    it[1].set_result(np.asarray(pred))
                    add_span("serve.request", it[4], request=it[3])
            except Exception as e:  # device failure
                for it in items:
                    if not it[1].done():
                        it[1].set_exception(e)
            finally:
                self._inflight.release()
