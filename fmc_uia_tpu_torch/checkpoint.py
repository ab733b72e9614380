"""Checkpoints: save AND resume (port of ``fmc_uia_tpu/checkpoint.py``).

The port has its own format and does not read the JAX package's Orbax
checkpoints:

  * ``checkpoint_epoch_N.pt``: one ``torch.save`` of the full train state
    — the model's state dict, the optimizer's state (its kind, ``count``
    and ``mu``/``nu`` or SGD's ``trace``), the adaptive log-vars, the
    gradient accumulator (under ``training.accumulation_steps`` > 1; the
    host's micro-step count is not saved, as the JAX package saves
    ``TrainState.grad_accum`` and not it), the Trainer's generator state
    and the scheduler's state — beside ``checkpoint_epoch_N.meta.json``
    (epoch, best score) and ``checkpoint_epoch_N.config.yaml`` (JSON
    text).
  * ``best_model.pt``: the model's state dict.

Loading uses ``torch.load(weights_only=True)``: tensors, numbers, strings
and containers only.

Under a mesh the files hold the single process's format: the Trainer
gathers its tensor-parallel shards and ZeRO slices (every rank takes part),
rank 0 writes, and every rank reads and keeps its own part; so a
checkpoint written by W ranks resumes on 1 and the other way round.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from fmc_uia_tpu_torch.parallel.distributed import is_main_process


def train_state(trainer) -> Dict:
    """Everything a resumed run needs to continue exactly."""
    return {
        "model": trainer.model_state(),
        "optimizer": trainer.optimizer_state(),
        "grad_accum": trainer.accum_state(),
        "adaptive": (None if trainer.adaptive is None
                     else {k: v.detach() for k, v in
                           trainer.adaptive.items()}),
        "generator": trainer.generator.get_state(),
        "scheduler": trainer.scheduler.state_dict(),
        "host_step": int(trainer.host_step),
    }


@torch.no_grad()
def load_train_state(trainer, state: Dict) -> None:
    """Restore ``train_state`` into a Trainer built like the saved one."""
    trainer.load_model_state(state["model"])
    trainer.load_optimizer_state(state["optimizer"])
    acc = state.get("grad_accum")
    if (trainer.grad_accum is None) != (acc is None):
        raise ValueError("gradient accumulation on/off differs from the "
                         "checkpoint")
    if acc is not None:
        trainer.load_accum_state(acc)
    if (trainer.adaptive is None) != (state["adaptive"] is None):
        raise ValueError("adaptive loss on/off differs from the checkpoint")
    if trainer.adaptive is not None:
        for k, v in state["adaptive"].items():
            trainer.adaptive[k].copy_(v)
    trainer.generator.set_state(state["generator"].cpu())
    trainer.scheduler.load_state_dict(state["scheduler"])
    trainer.host_step = int(state["host_step"])


def save_checkpoint(ckpt_dir, trainer, epoch: int, best_score: float,
                    config_dict: Dict) -> Path:
    """Full-train-state checkpoint after ``epoch`` completed epochs
    (every rank calls it; rank 0 writes)."""
    ckpt_dir = Path(ckpt_dir).resolve()
    path = ckpt_dir / f"checkpoint_epoch_{epoch}.pt"
    state = train_state(trainer)
    if not is_main_process():
        return path
    torch.save(state, path)
    with open(ckpt_dir / f"checkpoint_epoch_{epoch}.meta.json", "w") as f:
        json.dump({"epoch": int(epoch), "best_score": float(best_score)}, f)
    with open(ckpt_dir / f"checkpoint_epoch_{epoch}.config.yaml", "w") as f:
        json.dump(config_dict, f, indent=2, default=str)
    return path


def latest_checkpoint(ckpt_dir) -> Optional[Tuple[Path, Dict]]:
    """Newest checkpoint under ``ckpt_dir``, searched directly AND one level
    down (fit() writes into timestamped experiment dirs, so resume is
    usually given their parent, the output dir)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best, best_key = None, (-1, -1.0)
    metas = list(ckpt_dir.glob("checkpoint_epoch_*.meta.json")) + list(
        ckpt_dir.glob("*/checkpoint_epoch_*.meta.json"))
    for meta_file in metas:
        with open(meta_file) as f:
            meta = json.load(f)
        path = meta_file.parent / f"checkpoint_epoch_{meta['epoch']}.pt"
        if not path.exists():
            continue
        key = (meta["epoch"], meta_file.stat().st_mtime)
        if key > best_key:
            best, best_key = (path, meta), key
    return best


def restore_checkpoint(path, trainer) -> None:
    load_train_state(trainer, torch.load(path, map_location=trainer.device,
                                         weights_only=True))


def save_best_params(ckpt_dir, model) -> Path:
    """The model's state dict (the reference's best_model.pth); ``model``
    is a module or a state dict (``Trainer.model_state()`` under a mesh).
    Only rank 0 writes."""
    path = Path(ckpt_dir).resolve() / "best_model.pt"
    if is_main_process():
        torch.save(model.state_dict() if hasattr(model, "state_dict")
                   else model, path)
    return path


def load_best_params(ckpt_dir, device) -> Dict:
    path = Path(ckpt_dir).resolve() / "best_model.pt"
    return torch.load(path, map_location=device, weights_only=True)
