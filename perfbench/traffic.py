"""The general traffic generators. A cell's traffic file
(``traffic/<cell>.json``) holds only parameters; its ``kind`` names the
generator here that reads them:

* ``train_staged``: batches of ``batch`` seeded random uint8 images of
  ``image``², one per entry of ``tasks`` ([task type, task id]) a round,
  ``pool_rounds`` rounds of distinct rows made on the device, the steps
  taken round-robin over the pool. Labels as the reference benchmark
  makes them: seg masks of {0, 1}, class ids below the task's count,
  boxes (x1, y1) ~ U(0.1, 0.5) with sides 0.3, regression points U(0, 1).
* ``serve_closed_loop``: ``clients`` clients, each sending its next
  request when the last is answered; request k takes image
  ``pool[j_k]`` of a pool of ``image_pool`` seeded images and task
  ``tasks[t_k]``: j_k drawn from the seed, the task sequence a balanced
  shuffle fixed by ``task_order_seed`` (every seed the same work).

Every draw comes from generators seeded by ``--seed`` and a fixed salt per
stream, so one seed gives one set of inputs on both sides of a
comparison.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

SALT_TRAIN = 0x7261696E  # streams of draws, one per use
SALT_SERVE = 0x73657276
SALT_ORDER = 0x6F726472


def _gen(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + salt) % (2 ** 63))
    return g


def train_batch(registry, task_type: str, task_id: str, B: int, S: int,
                g: torch.Generator, device) -> Dict:
    """One batch of a task, made on ``device`` from ``g``."""
    spec = registry[task_id]
    image = torch.randint(0, 255, (B, S, S, 3), generator=g, device=device,
                          dtype=torch.uint8)
    if task_type == "segmentation":
        label = torch.randint(0, 2, (B, S, S), generator=g, device=device)
    elif task_type == "classification":
        label = torch.randint(0, spec.num_classes, (B,), generator=g,
                              device=device)
    elif task_type == "detection":
        xy = 0.1 + 0.4 * torch.rand(B, 2, generator=g, device=device)
        label = torch.cat([xy, xy + 0.3], 1)
    elif task_type == "Regression":
        label = torch.rand(B, 2 * spec.num_classes, generator=g,
                           device=device)
    else:
        raise ValueError(f"unknown task type {task_type!r}")
    return {"image": image, "label": label, "task_id": task_id,
            "task_index": spec.global_index, "task_type": task_type}


def train_pool(traffic: Dict, registry, seed: int, device,
               rounds: int = None) -> List[Dict]:
    """The pool of batches in step order: round r's batches, one per task
    of ``traffic['tasks']``, for r in range(pool_rounds) (or the first
    ``rounds``: the same batches, as the first rounds of the full pool)."""
    if traffic["kind"] != "train_staged":
        raise ValueError(f"not a train_staged traffic: {traffic['kind']}")
    g = _gen(seed, SALT_TRAIN, device)
    n = int(traffic["pool_rounds"] if rounds is None else rounds)
    return [train_batch(registry, t, tid, int(traffic["batch"]),
                        int(traffic["image"]), g, device)
            for _ in range(n) for t, tid in traffic["tasks"]]


def serve_images(traffic: Dict, seed: int, device) -> np.ndarray:
    """The pool of request images, uint8 [n, S, S, 3] on the host (made on
    ``device`` in one call and copied once)."""
    g = _gen(seed, SALT_SERVE, device)
    S = int(traffic["image"])
    n = int(traffic["image_pool"])
    img = torch.randint(0, 255, (n, S, S, 3), generator=g, device=device,
                        dtype=torch.uint8)
    return img.cpu().numpy()


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        [int(seed) & 0xFFFFFFFF, int(seed) >> 32, salt]))


def serve_order(traffic: Dict, seed: int, n_requests: int) -> np.ndarray:
    """[n_requests, 2]: request k's (image index, task index). The task
    indices are balanced (each task the same count, to one) and shuffled
    by ``traffic['task_order_seed']``, the same for every run: the order
    of the tasks sets how the batcher's queues fill, so every seed gets
    the same work. The image indices are uniform, drawn from ``seed``."""
    T = len(traffic["tasks"])
    tasks = np.arange(n_requests) % T
    _rng(int(traffic["task_order_seed"]), SALT_ORDER).shuffle(tasks)
    images = _rng(seed, SALT_ORDER).integers(0, int(traffic["image_pool"]),
                                             n_requests)
    return np.stack([images, tasks], 1)
