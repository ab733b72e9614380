"""Task-uniform batch sampler (port of ``fmc_uia_tpu/data/sampler.py``,
the same ``random.Random`` calls in the same order).

Host-side scheduler with the exact semantics of the reference's sampler
(reference data/dataset.py:140-192): indices grouped by task_id, seeded
``random.Random``, per-step uniform task choice, per-task cursors with
reshuffle-on-wraparound, ``steps_per_epoch`` defaulting to
``len(dataset) // batch_size``. Every batch is homogeneous in task — the
invariant the per-task-type train steps rely on.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence


class MultiTaskUniformSampler:
    def __init__(self, task_ids_per_index: Sequence[str], batch_size: int,
                 steps_per_epoch: Optional[int] = None,
                 seed: Optional[int] = None):
        """Args:
          task_ids_per_index: task_id of each dataset row (index-aligned).
          batch_size: samples per batch (all from one task).
          steps_per_epoch: batches per epoch; default len // batch_size.
          seed: seed for the scheduler RNG.
        """
        self.batch_size = int(batch_size)
        self.rng = random.Random(seed)

        self.indices_by_task: Dict[str, List[int]] = {}
        for idx, task_id in enumerate(task_ids_per_index):
            self.indices_by_task.setdefault(task_id, []).append(idx)
        self.task_ids = list(self.indices_by_task.keys())

        for task_id in self.task_ids:
            self.rng.shuffle(self.indices_by_task[task_id])

        n = len(task_ids_per_index)
        self.steps_per_epoch = (
            n // self.batch_size if steps_per_epoch is None
            else int(steps_per_epoch)
        )

    def __len__(self) -> int:
        return self.steps_per_epoch

    def __iter__(self) -> Iterator[List[int]]:
        cursors = {t: 0 for t in self.task_ids}
        for _ in range(self.steps_per_epoch):
            task_id = self.rng.choice(self.task_ids)
            indices = self.indices_by_task[task_id]
            start = cursors[task_id]
            end = start + self.batch_size
            if end > len(indices):
                batch = indices[start:]
                self.rng.shuffle(indices)
                remaining = self.batch_size - len(batch)
                batch = batch + indices[:remaining]
                cursors[task_id] = remaining
            else:
                batch = indices[start:end]
                cursors[task_id] = end
            yield batch

    def advance_epochs(self, n: int) -> None:
        """Fast-forward the scheduler state by ``n`` epochs.

        Resume support: replays the index-generation sequence (RNG draws +
        wraparound reshuffles) without materializing batches, so a resumed
        run sees exactly the data order the original run would have seen
        from epoch ``n`` on. Host-side index ops only — cost is
        O(n * steps_per_epoch). The reference has no resume path at all
        (SURVEY §5: save-only checkpoints, reference train.py:710-727)."""
        for _ in range(int(n)):
            for _ in self:
                pass
