"""Device-resident dataset cache (port of ``fmc_uia_tpu/data/device_cache.py``):
per-task sample banks on the card, and each batch gathered there by index.

Every decoded, resized sample is staged to device memory once (uint8
images, or f32 under ``data.use_adaptive_norm``; segmentation masks as
uint8 class ids). A batch is then one ``index_select`` per bank, driven by
the host sampler's rows: the per-step host work is the index vector, not
decode + resize + collate + copy. The step receives the same tensors the
host path gives it after ``Trainer.put_batch``: bitwise the same image and
label, the label widened to int64 on the card.

As in the JAX package:

- tasks are staged largest first; a task that does not fit the
  remaining budget streams through the host path, and that is printed
  (the JAX package's ``partial`` staging, the one mode its pipeline
  uses). The sampler's one-task-per-batch rule makes this exact: a batch
  is wholly staged or wholly streamed;
- a sample whose bytes came from another row (the dataset's
  corrupt-image retry) is recorded in ``substituted`` and printed;
- ``covers`` and ``get_batch(rows, n_valid)`` follow
  ``DataEngine._load_batch``'s contract, padded eval rows and the
  ``valid`` mask included.

Two differences, both deliberate:

- a task's bytes are reckoned from its row count, the image size, the
  channels and the dtypes *before* it is decoded; the JAX package decodes
  the whole task first, then checks the budget;
- an out-of-memory error of the card propagates. The JAX package turns a
  ``MemoryError`` into streaming with a message; here the budget alone
  decides what streams, and nothing is caught.

Under a mesh (``mesh=``) the banks are sharded over the batch axes: of
a task's n rows, rank r decodes and holds positions ``r*c:(r+1)*c``
(c = ceil(n / W), the bank padded to c rows), so each rank holds about
1/W of each bank and the budget is reckoned per rank. ``get_batch(rows,
n_valid, span)`` takes the global batch's rows and returns this rank's
slice: every rank gathers the rows it owns for every rank's slice, one
``all_to_all`` (on a process group of the cache's own, so it never
interleaves with the step's collectives) delivers them, and each row is
taken from its owner, bitwise the single process's rows.

The gather runs on whichever thread calls ``get_batch`` (the DataEngine's
producer), on the device's current stream, the default stream, which the
step's thread uses too: the gather is queued behind the steps already
queued and before the step that reads its output, and the banks are never
written after staging, so nothing races.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fmc_uia_tpu_torch.data.dataset import MultiTaskDataset
from fmc_uia_tpu_torch.parallel import comm
from fmc_uia_tpu_torch.parallel.mesh import BATCH_AXES, axis_group
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    SEGMENTATION,
    TaskRegistry,
)


def _narrow_labels(task_name: str, labels: np.ndarray,
                   num_classes: int) -> np.ndarray:
    """Segmentation masks are class ids < 256: ship and stage them as
    uint8 (4x fewer bytes); the consumers widen them on the device."""
    if (task_name == SEGMENTATION and labels.dtype == np.int32
            and num_classes <= 255):
        return labels.astype(np.uint8)
    return labels


def sample_bytes(dataset: MultiTaskDataset, task_name: str,
                 num_classes: int) -> int:
    """Bytes one sample of a task takes in the banks: the image
    (S x S x 3, uint8 or f32) and its label as the dataset makes it, a
    segmentation mask narrowed as ``_narrow_labels`` narrows it."""
    S = dataset.image_size
    image = S * S * 3 * (4 if dataset.use_adaptive_norm else 1)
    if task_name == SEGMENTATION:
        label = S * S * (1 if num_classes <= 255 else 4)
    elif task_name == CLASSIFICATION:
        label = 4
    elif task_name == DETECTION:
        label = 4 * 4
    else:
        label = 2 * dataset.max_reg_points * 4
    return image + label


class DeviceDatasetCache:
    """Per-task sample banks staged to ``device`` once.

    Args:
      dataset: the host dataset (decode + resize happen there, once a row).
      indices: the rows to stage (train and val together: one bank).
      registry: the task registry.
      budget_bytes: the staging budget.
      device: where the banks live (the CPU in the tests).
      workers: the decode thread pool's width.
      mesh: shard the banks over the mesh's batch axes (module docstring).
    """

    def __init__(self, dataset: MultiTaskDataset, indices: Sequence[int],
                 registry: TaskRegistry, budget_bytes: int = 4 << 30,
                 device="cuda", workers: int = 4, mesh=None):
        self.registry = registry
        self.device = torch.device(device)
        # the batch axes' ranks: W banks' shards, this rank's index; the
        # group is the cache's own (fresh), used by the producer thread
        g = axis_group(mesh, BATCH_AXES)
        self.W, self.me = comm.group_size(g), comm.group_rank(g)
        self.group = (axis_group(mesh, BATCH_AXES, fresh=True)
                      if self.W > 1 else None)
        self._chunk: Dict[str, int] = {}
        by_task: Dict[str, List[int]] = {}
        for i in indices:
            by_task.setdefault(dataset.rows[int(i)]["task_id"],
                               []).append(int(i))
        self.position: Dict[int, int] = {}  # row -> position in its bank
        self._index_task: Dict[int, str] = {}
        self._images: Dict[str, torch.Tensor] = {}
        self._labels: Dict[str, torch.Tensor] = {}
        self.skipped_tasks: List[str] = []
        self.substituted: List[tuple] = []  # (requested, actual source)
        self.nbytes = 0
        # the budget decides from the bytes each task will take, before
        # any decode
        plan = []
        for tid in sorted(by_task, key=lambda t: -len(by_task[t])):
            spec = registry[tid]
            nbytes = -(-len(by_task[tid]) // self.W) * sample_bytes(
                dataset, spec.task_name, spec.num_classes)
            if self.nbytes + nbytes > budget_bytes:
                self.skipped_tasks.append(tid)
                print(f"[data] device cache: task {tid} ({nbytes / 1e6:.0f}"
                      f" MB) exceeds the remaining budget; it streams from "
                      f"the host")
                continue
            self.nbytes += nbytes
            plan.append(tid)
        with ThreadPoolExecutor(max_workers=max(1, int(workers))) as pool:
            for tid in plan:
                self._stage(dataset, tid, by_task[tid], pool)

    def _stage(self, dataset, tid: str, rows: List[int], pool) -> None:
        spec = self.registry[tid]
        c = -(-len(rows) // self.W)
        self._chunk[tid] = c
        mine = rows[self.me * c:(self.me + 1) * c]
        samples = list(pool.map(dataset.__getitem__, mine))
        for i, s in zip(mine, samples):
            src = int(s.get("source_index", i))
            if src != i:
                self.substituted.append((i, src))
                print(f"[data] device cache: index {i} decoded from row "
                      f"{src} (corrupt-image retry); the substitution is "
                      f"frozen into the bank")
        if len(samples) < c:  # this rank's shard padded to c rows
            pad = dataset[rows[0]] if not samples else samples[0]
            samples = samples + [{k: np.zeros_like(pad[k]) for k in
                                  ("image", "label")}] * (c - len(samples))
        images = np.stack([s["image"] for s in samples])
        if images.dtype != np.float32:  # adaptive normalisation is f32
            images = images.astype(np.uint8)
        labels = _narrow_labels(spec.task_name,
                                np.stack([s["label"] for s in samples]),
                                spec.num_classes)
        self._images[tid] = torch.from_numpy(images).to(self.device)
        self._labels[tid] = torch.from_numpy(labels).to(self.device)
        for pos, i in enumerate(rows):
            self.position[i] = pos
            self._index_task[i] = tid

    def covers(self, indices: Sequence[int]) -> bool:
        return all(int(i) in self.position for i in indices)

    def _take(self, bank: torch.Tensor, positions) -> torch.Tensor:
        idx = torch.as_tensor(np.asarray(positions, np.int64))
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return bank.index_select(0, idx)

    def _assemble(self, tid: str, bank: torch.Tensor, pos: np.ndarray,
                  span) -> torch.Tensor:
        """This rank's slice of the global rows at bank positions ``pos``:
        the rows each rank owns for every slice, one all_to_all, each row
        taken from its owner."""
        start, stop, total = span
        if self.W == 1:
            return self._take(bank, pos[start:stop])
        c = self._chunk[tid]
        owner, local = pos // c, pos % c
        sent = self._take(bank, np.where(owner == self.me, local, 0))
        got = comm.all_to_all_dim0(sent, self.group)
        m = stop - start
        pick = owner[start:stop] * m + np.arange(m)
        return self._take(got, pick)

    def get_batch(self, rows: Sequence[int], n_valid: Optional[int] = None,
                  span=None) -> Dict:
        """One single-task batch gathered on the device; ``rows`` are
        dataset rows, as ``DataEngine._load_batch`` passes them (a padded
        final eval chunk included). ``span`` (start, stop, len(rows)):
        this rank's slice of them, under a mesh (module docstring)."""
        tid = self._index_task.get(int(rows[0]))
        if tid is None:
            raise KeyError(f"index {rows[0]} not staged in the device cache")
        B = len(rows)
        if span is None and self.W > 1:
            raise ValueError("sharded banks give a rank's slice only: pass "
                             "span")
        if span is None:
            span = (0, B, B)
        pos = np.asarray([self.position[int(i)] for i in rows], np.int64)
        image = self._assemble(tid, self._images[tid], pos, span)
        label = self._assemble(tid, self._labels[tid], pos, span)
        if not label.is_floating_point():
            label = label.long()  # widened on the device
        spec = self.registry[tid]
        out = {
            "image": image,
            "label": label,
            "task_id": tid,
            "task_index": spec.global_index,
            "task_type": spec.task_name,
            "valid": (np.arange(B) < (B if n_valid is None else n_valid)
                      )[span[0]:span[1]],
        }
        if self.W > 1 or span != (0, B, B):
            out["rows"] = tuple(span)
        return out


def build_device_cache(dataset: MultiTaskDataset, indices: Sequence[int],
                       registry: TaskRegistry, budget_bytes: int,
                       device="cuda", workers: int = 4, mesh=None
                       ) -> Optional[DeviceDatasetCache]:
    """A cache (the tasks over the budget stream), or None, with a
    message, when nothing is staged."""
    cache = DeviceDatasetCache(dataset, indices, registry, budget_bytes,
                               device=device, workers=workers, mesh=mesh)
    if not cache.position:
        print("[data] device cache disabled: no task fits the budget")
        return None
    return cache
