"""Task registry — the static task universe behind the compiled step functions.

The port's own copy of ``fmc_uia_tpu/tasks.py`` (same tables, same names):
the PyTorch package imports nothing from the JAX package.

The reference dispatches per-subtask heads through an ``nn.ModuleDict`` keyed
by task_id string at Python level (code/models/heads.py:585-590,
multitask_model.py:176-250). On TPU we instead compile ONE step per task
*type* and select the subtask head by a device-side integer index into banked
parameter stacks. This module owns the static tables that make that possible:

  * a stable global ordering of tasks (registration order, as in the dataset
    derivation loop at reference train.py:64-73),
  * per-type local indices (position of a task inside its type's head bank),
  * num_classes tables and per-type padded maxima (classification heads with
    2..6 classes share one bank padded to 6; invalid logits are masked).

The canonical task-name strings are preserved exactly, including
``'Regression'`` with a capital R (reference heads.py:543, dataset.py:76).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

# Canonical task-type strings (order fixed; used as the static axis of the
# 4 compiled step functions).
SEGMENTATION = "segmentation"
CLASSIFICATION = "classification"
DETECTION = "detection"
REGRESSION = "Regression"  # capital R — exact contract with reference

TASK_TYPES: tuple = (SEGMENTATION, CLASSIFICATION, DETECTION, REGRESSION)


@dataclass(frozen=True)
class TaskSpec:
    """One subtask (reference: entries of config.yaml:232-320)."""

    task_id: str
    task_name: str  # one of TASK_TYPES
    num_classes: int
    global_index: int  # position in registration order
    local_index: int  # position within its task type's head bank

    @property
    def task_type(self) -> str:
        return self.task_name


class TaskRegistry:
    """Static task universe with device-friendly lookup tables."""

    def __init__(self, task_configs: Sequence[Dict]):
        if not task_configs:
            raise ValueError("TaskRegistry requires at least one task config")
        self._specs: List[TaskSpec] = []
        self._by_id: Dict[str, TaskSpec] = {}
        per_type_counter: Dict[str, int] = {t: 0 for t in TASK_TYPES}

        for gidx, cfg in enumerate(task_configs):
            name = cfg["task_name"]
            if name not in TASK_TYPES:
                raise ValueError(
                    f"Unknown task_name {name!r}; expected one of {TASK_TYPES}"
                )
            spec = TaskSpec(
                task_id=cfg["task_id"],
                task_name=name,
                num_classes=int(cfg["num_classes"]),
                global_index=gidx,
                local_index=per_type_counter[name],
            )
            per_type_counter[name] += 1
            if spec.task_id in self._by_id:
                raise ValueError(f"Duplicate task_id {spec.task_id!r}")
            self._specs.append(spec)
            self._by_id[spec.task_id] = spec

        # Static numpy lookup tables (embedded as constants under jit).
        self.num_classes_table = np.asarray(
            [s.num_classes for s in self._specs], dtype=np.int32
        )
        self.local_index_table = np.asarray(
            [s.local_index for s in self._specs], dtype=np.int32
        )
        self.type_index_table = np.asarray(
            [TASK_TYPES.index(s.task_name) for s in self._specs], dtype=np.int32
        )

    # -- pythonic access ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._specs)

    def __iter__(self):
        return iter(self._specs)

    def __getitem__(self, task_id: str) -> TaskSpec:
        return self._by_id[task_id]

    def __contains__(self, task_id: str) -> bool:
        return task_id in self._by_id

    @property
    def task_ids(self) -> List[str]:
        return [s.task_id for s in self._specs]

    @property
    def specs(self) -> List[TaskSpec]:
        return list(self._specs)

    def of_type(self, task_type: str) -> List[TaskSpec]:
        """Tasks of one type, ordered by local_index."""
        return [s for s in self._specs if s.task_name == task_type]

    def num_of_type(self, task_type: str) -> int:
        return len(self.of_type(task_type))

    def present_types(self) -> List[str]:
        return [t for t in TASK_TYPES if self.num_of_type(t) > 0]

    def max_classes(self, task_type: str) -> int:
        """Padded class count for the type's shared head bank."""
        specs = self.of_type(task_type)
        if not specs:
            return 0
        return max(s.num_classes for s in specs)

    def local_num_classes(self, task_type: str) -> np.ndarray:
        """num_classes per local index of one type — for logit masking."""
        return np.asarray(
            [s.num_classes for s in self.of_type(task_type)], dtype=np.int32
        )

    def to_task_configs(self) -> List[Dict]:
        """Round-trip back to the reference's task-config dict list."""
        return [
            {
                "task_id": s.task_id,
                "task_name": s.task_name,
                "num_classes": s.num_classes,
            }
            for s in self._specs
        ]

    @classmethod
    def from_config(cls, config) -> "TaskRegistry":
        return cls(config.get_task_configs())
