"""Top-level training entry: the config-driven fit loop (port of
``fmc_uia_tpu/fit.py``).

config -> seed -> logger -> data engines (dataset-derived tasks) -> model
-> Trainer (losses, grouped AdamW, schedule) -> epoch loop (train,
validate, score, best-model save, periodic checkpoint) -> final summary ->
best-model evaluation on the train split.

Differences from the JAX package:

- ``device`` (default ``"cuda"``) picks the card or, when asked, the CPU;
  asking for CUDA without a GPU raises.
- The host->device copy of each batch (``Trainer.put_batch``: pinned
  memory from the caching host allocator, ``non_blocking``) runs on the
  data engine's producer thread, on the default CUDA stream, which both
  threads share: the copy is ordered behind the steps already queued, and
  the step that uses the batch is queued after the copy, so no event or
  ``record_stream`` is needed. The copy of a 24 x 512² batch (~19 MB)
  takes ~1 ms of a ~250 ms step, so a side stream would buy nothing.
- Exact resume comes from the checkpoint's Trainer generator state and
  scheduler state (the JAX package folds the step count into its keys and
  replays the scheduler); the sampler is fast-forwarded as there.
- ``experiment.compile_cache`` has no counterpart (PyTorch runs eagerly;
  the CUDA kernels build once per checkout into ``build/``).
- ``model.encoder.pretrained`` (a local checkpoint path) is loaded by
  ``utils/convert.load_pretrained_into``, where the JAX package loads it:
  after the model is built, before the optimizer and any resume.
- With ``data.device_cache`` the data engines gather the batches on the
  card from banks staged once (``data/device_cache.py``); the best-model
  evaluation on the train split reads the same banks.
- Not ported, raising (ROADMAP.md): device meshes.

CLI: ``python -m fmc_uia_tpu_torch --config <yaml> [--resume] [--device]``.
"""

from __future__ import annotations

import signal
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from fmc_uia_tpu_torch import checkpoint as ckpt_lib
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.pipeline import DataEngine, build_data_engines
from fmc_uia_tpu_torch.device import resolve_device
from fmc_uia_tpu_torch.metrics import (
    average_validation_score,
    evaluate,
    format_rows,
)
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.ops.image import input_prep_fns
from fmc_uia_tpu_torch.train import _NOT_PORTED, Trainer
from fmc_uia_tpu_torch.utils.common import count_parameters, set_seed
from fmc_uia_tpu_torch.utils.convert import load_pretrained_into
from fmc_uia_tpu_torch.utils.logger import (
    TrainingLogger,
    plot_comprehensive_training_curves,
    plot_training_curves,
)
from fmc_uia_tpu_torch.utils.profiling import ProfileTrace, StepTimer

class _PreemptionGuard:
    """Preemption-safe training: set a flag on SIGTERM, act at a safe point.

    The handler only flips a flag; ``fit()`` writes a full checkpoint at
    the next batch boundary and returns, so that ``--resume`` continues
    from the interrupted epoch."""

    def __init__(self, enabled: bool = True):
        self.requested = False
        self._prev = None
        self._installed = False
        if not enabled:
            return
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        except ValueError:  # not the main thread: no handler
            pass

    def _handler(self, signum, frame):
        self.requested = True
        print("\nSIGTERM received — checkpointing at the next batch "
              "boundary, then exiting (continue with --resume)", flush=True)

    def close(self):
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False


def _wait(t: torch.Tensor) -> None:
    """Wait for the device to finish the work queued before ``t``'s."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _moe_accumulate(stats: Dict, key: str, task_name: str, vals: Dict
                    ) -> None:
    e = stats.setdefault(key, {
        "task_name": task_name, "importance_sum": 0.0, "load_sum": 0.0,
        "count": 0, "aux_sum": 0.0, "aux_count": 0})
    e["importance_sum"] = e["importance_sum"] + vals["moe_importance"]
    e["load_sum"] = e["load_sum"] + vals["moe_load"]
    e["count"] += 1
    if "moe_aux" in vals:
        e["aux_sum"] += float(vals["moe_aux"])
        e["aux_count"] += 1


def _moe_finalize(stats: Dict) -> Dict:
    """Per key the mean importance and load per expert (lists) and, where
    logged, the mean balance loss (``aux_loss``), as the JAX fit."""
    out = {}
    for key, e in stats.items():
        rec = {"task_name": e["task_name"],
               "importance": (e["importance_sum"] / e["count"]).tolist(),
               "load": (e["load_sum"] / e["count"]).tolist()}
        if e["aux_count"]:
            rec["aux_loss"] = e["aux_sum"] / e["aux_count"]
        out[key] = rec
    return out


def _train_epoch(trainer: Trainer, train_engine, epoch: int,
                 print_freq: int, profiler=None, timer=None,
                 stop=None) -> Dict:
    """One epoch; returns the per-task losses, the MoE statistics by task
    id and by task type (None without MoE) and the epoch's loop stats.
    The loop reads nothing from the device per step: the logs stay on the
    device and are read in bulk (every 256 steps, at print points and at
    the end)."""
    epoch_losses = defaultdict(list)
    moe_task, moe_type = {}, {}
    pending = []  # (task_id, task_type, device logs)
    moe_keys = ("moe_aux", "moe_importance", "moe_load")

    def drain():
        if not pending:
            return
        # every step logs the same keys: one stacked read per key
        host = {k: torch.stack([logs[k].float() for _, _, logs in pending]
                               ).cpu().numpy() for k in pending[0][2]}
        for j, (tid, ttype, _) in enumerate(pending):
            vals = {k: v[j] for k, v in host.items()}
            epoch_losses[tid].append(float(vals["total_loss"]))
            if "moe_importance" in vals:
                _moe_accumulate(moe_task, tid, ttype, vals)
                _moe_accumulate(moe_type, ttype, ttype, vals)
        pending.clear()

    seen_types = set()
    steps = 0
    t0 = time.perf_counter()
    batches = iter(train_engine)
    for batch_idx, batch in enumerate(batches):
        if stop is not None and stop():
            batches.close()  # preemption: stop the producer now
            break
        if profiler is not None:
            profiler.maybe_start(trainer.host_step)
        first_of_type = batch["task_type"] not in seen_types
        seen_types.add(batch["task_type"])
        logs = trainer.train_batch(batch, epoch)
        steps += 1
        if profiler is not None:
            profiler.maybe_stop(trainer.host_step)
        if timer is not None:
            timer.lap(lambda: _wait(logs["total_loss"]), taint=first_of_type)
        pending.append((batch["task_id"], batch["task_type"],
                        {k: v for k, v in logs.items()
                         if k == "total_loss" or k in moe_keys}))
        if len(pending) >= 256:
            drain()
        if print_freq > 0 and (batch_idx + 1) % print_freq == 0:
            drain()
            tid = batch["task_id"]
            avg = float(np.mean(epoch_losses[tid]))
            print(f"  Batch [{batch_idx + 1}/{len(train_engine)}] | "
                  f"Task: {tid} | Loss: {avg:.4f}")
    drain()
    data = train_engine.stats
    loop = {"steps": steps, "loop_s": time.perf_counter() - t0,
            "queue_wait_s": data["wait_s"], "host_load_s": data["load_s"],
            "host_put_s": data["put_s"], "batches": data["batches"],
            "images": data["images"]}
    moe_stats = None
    if moe_task:
        moe_stats = {"by_task_id": _moe_finalize(moe_task),
                     "by_task_name": _moe_finalize(moe_type)}
    return dict(epoch_losses), moe_stats, loop


def _group_means(rows: List[Dict]) -> Dict:
    """Per task group, the mean of its primary metric(s) over tasks."""
    groups = {"classification": ["Accuracy", "F1-Score"],
              "segmentation": ["Dice"], "detection": ["IoU"],
              "regression": ["MAE (pixels)"]}
    out = {}
    for gname, metrics in groups.items():
        vals = {m: [float(r[m]) for r in rows
                    if r.get(m) is not None and not np.isnan(r[m])]
                for m in metrics}
        means = {m: (float(np.mean(v)) if v else None)
                 for m, v in vals.items()}
        out[gname] = means if gname == "classification" else next(
            (v for v in means.values() if v is not None), None)
    return out


def fit(config_path: Optional[str] = None, config=None,
        resume: bool = False, device="cuda", mesh=None) -> Dict:
    """Run full training; returns a result summary dict (with the port's
    per-epoch loop stats under ``epoch_stats`` and the number of
    evaluation batches under ``eval_batches``)."""
    dev = resolve_device(device)
    if config is None:
        config = Config(config_path)
    if mesh is not None or config.get("parallel.mesh"):
        raise NotImplementedError(_NOT_PORTED.format(
            what="device meshes (parallel.mesh)", item="Parallel modes"))
    set_seed(config.seed)

    # --resume continues the checkpoint's own experiment dir
    resume_found = (ckpt_lib.latest_checkpoint(config.output_dir)
                    if resume else None)
    logger = TrainingLogger(
        config.output_dir, config.exp_name,
        existing_dir=resume_found[0].parent if resume_found else None)

    train_engine, val_engine, registry = build_data_engines(config,
                                                            device=dev)
    # the snapshot holds the dataset-derived task list
    logger.save_config(config.config)
    model = build_model(config, registry, device=dev)
    print(f"Model parameters: {count_parameters(model):,}")
    pretrained = config.get("model.encoder.pretrained")
    if isinstance(pretrained, str) and pretrained not in ("", "none"):
        load_pretrained_into(model.encoder,
                             str(config.get("model.encoder.name")),
                             pretrained)
        print(f"Loaded pretrained encoder weights from {pretrained}")
    elif pretrained is True:
        print("WARNING: model.encoder.pretrained=true requests a timm "
              "download (reference behavior); this environment has no "
              "egress — set it to a local checkpoint path instead. "
              "Training from scratch.")

    trainer = Trainer(config, model, registry, device=dev)
    train_engine.put_fn = trainer.put_batch

    mean = config.get("data.augmentation.normalize.mean")
    std = config.get("data.augmentation.normalize.std")
    eval_prep = input_prep_fns(config)[1]
    ckpt_dir = logger.get_experiment_dir()

    start_epoch = 0
    best_val_score = -float("inf")
    best_epoch = 0
    if resume_found:
        path, meta = resume_found
        ckpt_lib.restore_checkpoint(path, trainer)
        start_epoch = meta["epoch"]
        best_val_score = meta["best_score"]
        best_epoch = start_epoch  # the restored best is <= this epoch
        logger.truncate_history(start_epoch)  # redo interrupted epochs
        # the checkpoint restored the schedule and the Trainer's generator;
        # the sampler replays its epochs, so the next epoch's batches are
        # those of an unbroken run
        train_engine.sampler.advance_epochs(start_epoch)
        print(f"Resumed from {path} at epoch {start_epoch}")

    print_freq = int(config.get("training.print_freq", 50) or 0)
    save_ckpts = bool(config.get("experiment.save_checkpoints", True))
    ckpt_freq = int(config.get("experiment.checkpoint_freq", 5))
    profiler = ProfileTrace(config, str(ckpt_dir / "profile"))
    timer = StepTimer()
    guard = _PreemptionGuard(bool(config.get(
        "experiment.preemption_checkpoint", True)))
    epoch_stats, eval_batches = [], 0

    print(f"\n{'=' * 80}")
    print("Multi-Task Ultrasound Image Analysis Training")
    print(f"Experiment: {config.exp_name}")
    print(f"{'=' * 80}\n")
    print(f"\n{'=' * 80}")
    print("Starting Training...")
    print(f"{'=' * 80}\n")

    try:
        for epoch in range(start_epoch, config.num_epochs):
            t0 = time.time()
            print(f"\nEpoch [{epoch + 1}/{config.num_epochs}]")
            print("-" * 80)
            epoch_losses, moe_stats, loop = _train_epoch(
                trainer, train_engine, epoch, print_freq, profiler=profiler,
                timer=timer, stop=lambda: guard.requested)
            epoch_stats.append({"epoch": epoch + 1, **loop})
            if guard.requested:
                # the completed-epoch count: --resume redoes this epoch
                ckpt_lib.save_checkpoint(ckpt_dir, trainer, epoch,
                                         best_val_score, config.config)
                logger.save_final_summary(best_epoch=best_epoch,
                                          best_score=best_val_score)
                print(f"Preempted during epoch {epoch + 1}; checkpoint saved"
                      f" to {ckpt_dir} — continue with --resume")
                return {"best_score": best_val_score,
                        "best_epoch": best_epoch,
                        "experiment_dir": str(ckpt_dir), "preempted": True,
                        "epoch_stats": epoch_stats,
                        "eval_batches": eval_batches}
            timing = timer.summary(batch_size=config.batch_size)
            if timing:
                print(f"  step p50={timing['p50_s'] * 1e3:.1f}ms  "
                      f"throughput={timing.get('images_per_sec', 0):.1f} "
                      "img/s")
            timer.reset()

            print(f"\nEpoch {epoch + 1} Train Loss Summary:")
            for tid in sorted(epoch_losses):
                print(f"  {tid:<30}: {np.mean(epoch_losses[tid]):.4f}")
            snapshot = trainer.adaptive_snapshot()
            if snapshot:
                print("\nAdaptive Loss Weights and Uncertainties:")
                for t in sorted(snapshot["weights"]):
                    print(f"  {t:<20}: weight={snapshot['weights'][t]:.4f}, "
                          f"sigma={snapshot['sigmas'][t]:.4f}")

            val_freq = max(1, int(config.get("validation.freq", 1) or 1))
            run_val = (bool(config.get("validation.enabled", True))
                       and ((epoch + 1) % val_freq == 0
                            or epoch + 1 == config.num_epochs))
            if run_val:
                print("\nRunning validation...")
                val_rows = evaluate(model, val_engine, registry, mean, std,
                                    prep=eval_prep, device=dev)
                eval_batches += val_engine.stats["batches"]
                avg_val_score = average_validation_score(val_rows)
                print(f"\n--- Epoch {epoch + 1} Validation Report ---")
                if val_rows:
                    print(format_rows(val_rows))
                print(f"--- Average Validation Score (Higher is better): "
                      f"{avg_val_score:.4f} ---")
            else:
                val_rows = []
                avg_val_score = -float("inf")  # never wins best

            logger.log_epoch(epoch=epoch + 1, train_losses=epoch_losses,
                             val_rows=val_rows,
                             learning_rate=trainer.scheduler.current_lr(),
                             epoch_time=time.time() - t0,
                             adaptive_weights=snapshot, moe_stats=moe_stats)
            if avg_val_score > best_val_score:
                best_val_score = avg_val_score
                best_epoch = epoch + 1
                ckpt_lib.save_best_params(ckpt_dir, model)
            # skip epochs carry no validation signal for plateau mode
            trainer.scheduler.step(avg_val_score if run_val else None)
            if save_ckpts and (epoch + 1) % ckpt_freq == 0:
                ckpt_lib.save_checkpoint(ckpt_dir, trainer, epoch + 1,
                                         best_val_score, config.config)

        logger.save_final_summary(best_epoch=best_epoch,
                                  best_score=best_val_score)

        # best-model evaluation on the TRAIN split
        best_eval = None
        if (ckpt_dir / "best_model.pt").exists():
            model.load_state_dict(ckpt_lib.load_best_params(ckpt_dir, dev))
            train_eval_engine = DataEngine(
                train_engine.dataset, train_engine.indices, registry,
                config.batch_size, shuffle_sampler=None,
                num_workers=config.num_workers, drop_last=False)
            train_eval_engine.device_cache = train_engine.device_cache
            try:
                rows = evaluate(model, train_eval_engine, registry, mean,
                                std, prep=eval_prep, device=dev)
            finally:
                train_eval_engine.close()
            eval_batches += train_eval_engine.stats["batches"]
            best_eval = _group_means(rows)
        else:
            print("Best-model evaluation skipped: no best model was saved "
                  "(validation off)")
        logger.save_best_model_summary(best_eval)
    finally:
        guard.close()
        profiler.close()
        train_engine.close()
        val_engine.close()

    try:
        plot_training_curves(ckpt_dir)
        plot_comprehensive_training_curves(ckpt_dir)
    except Exception as e:  # matplotlib absent, say: the fit has finished
        print(f"Could not generate training curves plot: {e}")
    print(f"\nTraining complete. Best score {best_val_score:.4f} "
          f"(epoch {best_epoch}). Logs: {ckpt_dir}")
    return {
        "best_score": best_val_score,
        "best_epoch": best_epoch,
        "experiment_dir": str(ckpt_dir),
        "best_eval_on_train": best_eval,
        "epoch_stats": epoch_stats,
        "eval_batches": eval_batches,
    }
