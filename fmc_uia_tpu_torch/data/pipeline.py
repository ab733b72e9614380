"""Batch pipeline: split, collate, prefetch (port of
``fmc_uia_tpu/data/pipeline.py``).

A thread-pooled host loader makes fixed-shape numpy batches, prefetched
ahead of the device by a producer thread. Every train batch is single-task
(the sampler's invariant); val batches are grouped per task too, padded to
the batch size with a ``valid`` mask. The decode, inflate and resize calls
release the GIL (``image_io``), so the pool's threads run in parallel.
With ``data.device_cache`` the rows a device cache covers are gathered on
the card instead (``data/device_cache.py``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fmc_uia_tpu_torch.data.dataset import MultiTaskDataset
from fmc_uia_tpu_torch.data.device_cache import (
    _narrow_labels,
    build_device_cache,
)
from fmc_uia_tpu_torch.data.sampler import MultiTaskUniformSampler
from fmc_uia_tpu_torch.tasks import TaskRegistry

_ITEM = ("{what} is not ported to fmc_uia_tpu_torch yet (ROADMAP.md, port "
         "queue item '{item}')")


def split_train_val(task_ids: Sequence[str], val_split: float, seed: int
                    ) -> Tuple[List[int], List[int]]:
    """Per-task stratified split of the rows whose task ids are
    ``task_ids``, with the JAX package's ``RandomState`` calls: tasks in
    sorted order (``groupby``), a task's rows ascending, shuffled, the first
    ``val_split`` share to val; then both lists shuffled."""
    rng = np.random.RandomState(seed)
    groups: Dict[str, List[int]] = {}
    for i, tid in enumerate(task_ids):
        groups.setdefault(tid, []).append(i)
    train_indices: List[int] = []
    val_indices: List[int] = []
    for tid in sorted(groups):
        gidx = np.asarray(groups[tid], dtype=np.int64)
        rng.shuffle(gidx)
        n_val = int(len(gidx) * val_split)
        val_indices.extend(gidx[:n_val].tolist())
        train_indices.extend(gidx[n_val:].tolist())
    rng.shuffle(train_indices)
    rng.shuffle(val_indices)
    return train_indices, val_indices


def _collate(samples: Sequence[Dict], registry: TaskRegistry,
             n_valid: Optional[int] = None) -> Dict:
    """Stack one single-task batch into fixed-shape arrays; ``n_valid`` real
    samples when the batch was padded (the final eval chunk of a task)."""
    task_id = samples[0]["task_id"]
    spec = registry[task_id]
    images = np.stack([s["image"] for s in samples])
    if images.dtype != np.float32:
        images = images.astype(np.uint8)
    labels = np.stack([s["label"] for s in samples])
    labels = _narrow_labels(spec.task_name, labels, spec.num_classes)
    B = len(samples)
    valid = np.arange(B) < (B if n_valid is None else n_valid)
    return {
        "image": images,
        "label": labels,
        "task_id": task_id,
        "task_index": spec.global_index,
        "task_type": spec.task_name,
        "valid": valid,
    }


class DataEngine:
    """Iterates collated single-task batches with background prefetch.

    ``put_fn``, when set, is applied to each batch on the producer thread;
    ``fit`` points it at ``Trainer.put_batch`` so that the batch's
    host->device copy is enqueued before the step loop asks for it.
    ``device_cache``, when set, gathers the batches whose rows it covers on
    the device (its tensors pass ``put_batch`` without a copy).
    ``stats`` holds the last iteration's counts: batches and their images
    (a train batch of a task with fewer than half a batch of rows holds
    fewer than ``batch_size``: the sampler's wraparound takes each row at
    most twice), the producer's seconds in decode + resize + collate
    (``load_s``) and in ``put_fn`` (``put_s``), the consumer's seconds
    waiting on the queue (``wait_s``) and the iteration's wall seconds
    (``wall_s``)."""

    def __init__(
        self,
        dataset: MultiTaskDataset,
        indices: Sequence[int],
        registry: TaskRegistry,
        batch_size: int,
        shuffle_sampler: Optional[MultiTaskUniformSampler] = None,
        num_workers: int = 4,
        prefetch_depth: int = 2,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.indices = list(indices)
        self.registry = registry
        self.batch_size = int(batch_size)
        self.sampler = shuffle_sampler
        self.num_workers = max(1, int(num_workers))
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.drop_last = drop_last
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        self.put_fn = None
        self.device_cache = None
        self.stats: Dict[str, float] = {}

    def __len__(self) -> int:
        if self.sampler is not None:
            return len(self.sampler)
        per_task: Dict[str, int] = {}
        for i in self.indices:
            tid = self.dataset.rows[i]["task_id"]
            per_task[tid] = per_task.get(tid, 0) + 1
        total = 0
        for n in per_task.values():
            total += (n // self.batch_size if self.drop_last
                      else -(-n // self.batch_size))
        return total

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    # -- batch index streams -------------------------------------------------
    def _train_batches(self) -> Iterator[List[int]]:
        for positions in self.sampler:
            yield [self.indices[p] for p in positions]

    def _eval_batches(self) -> Iterator[List[int]]:
        """Sequential batches grouped per task, tasks in sorted order."""
        by_task: Dict[str, List[int]] = {}
        for i in self.indices:
            tid = self.dataset.rows[i]["task_id"]
            by_task.setdefault(tid, []).append(i)
        for tid in sorted(by_task):
            rows = by_task[tid]
            for s in range(0, len(rows), self.batch_size):
                chunk = rows[s : s + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                yield chunk

    def _load_batch(self, rows: List[int]) -> Dict:
        n_valid = len(rows)
        if not self.drop_last and n_valid < self.batch_size:
            # pad the final chunk to the fixed batch size (repeat the last
            # row): every batch has one shape
            rows = rows + [rows[-1]] * (self.batch_size - n_valid)
        if self.device_cache is not None and self.device_cache.covers(rows):
            return self.device_cache.get_batch(rows, n_valid=n_valid)
        samples = list(self._pool.map(self.dataset.__getitem__, rows))
        return _collate(samples, self.registry, n_valid=n_valid)

    def _produce(self, rows: List[int]) -> Dict:
        t0 = time.perf_counter()
        batch = self._load_batch(rows)
        t1 = time.perf_counter()
        if self.put_fn is not None:
            batch = self.put_fn(batch)
        self.stats["load_s"] += t1 - t0
        self.stats["put_s"] += time.perf_counter() - t1
        self.stats["batches"] += 1
        self.stats["images"] += len(batch["image"])
        return batch

    def __iter__(self) -> Iterator[Dict]:
        stream = (self._train_batches() if self.sampler is not None
                  else self._eval_batches())
        self.stats = {"batches": 0, "images": 0, "load_s": 0.0,
                      "put_s": 0.0, "wait_s": 0.0, "wall_s": 0.0}
        t_start = time.perf_counter()
        if self.prefetch_depth == 0:
            for rows in stream:
                yield self._produce(rows)
            self.stats["wall_s"] = time.perf_counter() - t_start
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        done = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def producer():
            try:
                for rows in stream:
                    if stop.is_set():
                        break
                    q.put(self._produce(rows))
            except BaseException as e:  # re-raised by the consumer below
                error.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.stats["wait_s"] += time.perf_counter() - t0
                if item is done:
                    break
                yield item
        finally:
            # an early exit (preemption) must not leave the producer
            # blocked on a full queue: stop it and drain
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
            self.stats["wall_s"] = time.perf_counter() - t_start
        if error:
            raise error[0]


def build_data_engines(config, registry: Optional[TaskRegistry] = None,
                       mesh=None, device="cuda"
                       ) -> Tuple[DataEngine, DataEngine, TaskRegistry]:
    """Train/val engines from the config, with the single-task filter and
    the dataset-derived task list written into the config. With
    ``data.device_cache`` both engines share one ``DeviceDatasetCache`` on
    ``device`` (budget ``data.device_cache_budget_mb``, default 4096)."""
    if mesh is not None:
        raise NotImplementedError(_ITEM.format(
            what="data-parallel meshes", item="Parallel modes"))
    dataset = MultiTaskDataset(
        config.data_root, image_size=config.image_size,
        force_grayscale=bool(config.get("data.force_grayscale", False)),
        use_adaptive_norm=bool(config.get("data.use_adaptive_norm", False)),
        bg_threshold=config.get("data.bg_threshold", "auto"),
        cache_samples=bool(config.get("data.cache_samples", False)),
    )
    task_configs = dataset.derive_task_configs()

    st = config.get("training.single_task", {}) or {}
    if st.get("enabled", False):
        tid, tname = st.get("task_id"), st.get("task_name")
        if tid and tname:
            raise ValueError(
                "Set only one of training.single_task.task_id or task_name")
        if not tid and not tname:
            raise ValueError(
                "single_task.task_id or task_name required in single-task mode")
        rows = dataset.rows
        if tid:
            known = {c["task_id"] for c in task_configs}
            if tid not in known:
                raise ValueError(
                    f"Unknown task_id {tid!r}. Available: {sorted(known)}")
            dataset.rows = [r for r in rows if r["task_id"] == tid]
        else:
            match = [r for r in rows
                     if str(r["task_name"]).lower() == str(tname).lower()]
            if not match:
                names = sorted({r["task_name"] for r in rows})
                raise ValueError(
                    f"Unknown task_name {tname!r}. Available: {names}")
            dataset.rows = match
        task_configs = dataset.derive_task_configs()

    config.set_task_configs_from_dataset(task_configs)
    if registry is None:
        registry = TaskRegistry(task_configs)

    print("Using dataset-derived task configurations for model/task-prompt "
          "(config tasks are overwritten at runtime).")
    print(f"Detected {len(task_configs)} tasks:")
    for tc in task_configs:
        print(f"  - {tc['task_id']}: {tc['task_name']}, "
              f"num_classes={tc['num_classes']}")

    task_ids = [r["task_id"] for r in dataset.rows]
    train_idx, val_idx = split_train_val(task_ids, config.val_split,
                                         config.seed)
    n = len(dataset)
    print(f"\n✓ Dataset split (seed={config.seed}):")
    print(f"  - Total samples: {n}")
    print(f"  - Train samples: {len(train_idx)} "
          f"({100 * (len(train_idx) / n):.1f}%)")
    print(f"  - Val samples: {len(val_idx)} "
          f"({100 * (len(val_idx) / n):.1f}%)")

    sampler = MultiTaskUniformSampler(
        task_ids_per_index=[task_ids[i] for i in train_idx],
        batch_size=config.batch_size,
        steps_per_epoch=config.get("training.steps_per_epoch"),
        seed=config.seed,
    )
    train_engine = DataEngine(
        dataset, train_idx, registry, config.batch_size,
        shuffle_sampler=sampler, num_workers=config.num_workers,
    )
    val_engine = DataEngine(
        dataset, val_idx, registry, config.batch_size,
        shuffle_sampler=None, num_workers=config.num_workers,
        drop_last=False,
    )
    if bool(config.get("data.device_cache", False)):
        budget = int(config.get("data.device_cache_budget_mb", 4096))
        cache = build_device_cache(dataset, list(train_idx) + list(val_idx),
                                   registry, budget * (1 << 20),
                                   device=device,
                                   workers=config.num_workers)
        if cache is not None:
            train_engine.device_cache = cache
            val_engine.device_cache = cache
            note = (f" ({len(cache.skipped_tasks)} task(s) stream)"
                    if cache.skipped_tasks else "")
            print(f"[data] device dataset cache: {cache.nbytes / 1e6:.0f} MB"
                  f" staged to device memory{note}")
    return train_engine, val_engine, registry
