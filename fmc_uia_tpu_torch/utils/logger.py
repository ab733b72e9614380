"""Training logger: JSON/CSV history (port of
``fmc_uia_tpu/utils/logger.py`` ``TrainingLogger``).

Writes the JAX package's files into a timestamped experiment dir, with the
same columns:

  training_history.json   complete nested per-epoch history
  train_losses.csv        per-task per-epoch loss mean/std/min/max/count
  val_metrics.csv         long-format per-task per-epoch metrics
  training_summary.csv    per-epoch averages (+ lr, epoch_time)
  moe_stats.csv           per-expert importance/load by task (MoE runs)
  config.yaml             config snapshot (JSON text, which YAML reads)
  final_summary.json/.txt best epoch/score
  best_model_summary.txt  best-model train-set evaluation

CSVs are written with ``csv`` (a missing value is an empty cell, as pandas
writes NaN). The plots of the JAX package are not ported (ROADMAP.md).
"""

from __future__ import annotations

import csv
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _write_csv(path: Path, fields: List[str], rows: List[Dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
        w.writeheader()
        w.writerows({k: ("" if _missing(v) else v) for k, v in r.items()}
                    for r in rows)


class TrainingLogger:
    def __init__(self, log_dir, experiment_name: str, existing_dir=None):
        """``existing_dir``: attach to a previous run's experiment dir
        instead of creating a fresh timestamped one (``--resume``)."""
        if existing_dir is not None:
            self.experiment_dir = Path(existing_dir)
        else:
            timestamp = time.strftime("%Y%m%d_%H%M%S")
            self.experiment_dir = (Path(log_dir)
                                   / f"{experiment_name}_{timestamp}")
        self.experiment_dir.mkdir(parents=True, exist_ok=True)
        self.experiment_name = experiment_name
        self.history: List[Dict] = []
        hist_file = self.experiment_dir / "training_history.json"
        if existing_dir is not None and hist_file.exists():
            with open(hist_file) as f:
                self.history = json.load(f)

    def truncate_history(self, max_epoch: int) -> None:
        """Drop entries beyond ``max_epoch`` (1-based): resume redoes any
        interrupted epoch."""
        self.history = [e for e in self.history
                        if int(e.get("epoch", 0)) <= max_epoch]

    def get_experiment_dir(self) -> Path:
        return self.experiment_dir

    # -- per-epoch logging -------------------------------------------------
    def log_epoch(self, epoch: int, train_losses: Dict[str, List[float]],
                  val_rows: Optional[List[Dict]], learning_rate: float,
                  epoch_time: float, adaptive_weights: Optional[Dict] = None,
                  moe_stats: Optional[Dict] = None) -> None:
        entry: Dict = {
            "epoch": epoch,
            "learning_rate": float(learning_rate),
            "epoch_time": float(epoch_time),
            "train_losses": {
                tid: {
                    "mean": float(np.mean(v)),
                    "std": float(np.std(v)),
                    "min": float(np.min(v)),
                    "max": float(np.max(v)),
                    "count": len(v),
                }
                for tid, v in train_losses.items() if len(v)
            },
        }
        if val_rows:
            entry["val_metrics"] = [dict(r) for r in val_rows]
        if adaptive_weights:
            entry["adaptive_weights"] = adaptive_weights
        if moe_stats:
            entry["moe_stats"] = moe_stats
        self.history.append(entry)
        self._rewrite_files()

    def _rewrite_files(self) -> None:
        with open(self.experiment_dir / "training_history.json", "w") as f:
            json.dump(self.history, f, indent=2, default=float)

        loss_rows, summary_rows, val_rows, moe_rows = [], [], [], []
        for entry in self.history:
            epoch = entry["epoch"]
            means = []
            for tid, stats in entry["train_losses"].items():
                loss_rows.append({"epoch": epoch, "task_id": tid, **stats})
                means.append(stats["mean"])
            summary_rows.append({
                "epoch": epoch,
                "avg_train_loss": float(np.mean(means)) if means else None,
                "learning_rate": entry["learning_rate"],
                "epoch_time": entry["epoch_time"],
            })
            for rec in entry.get("val_metrics", []):
                for metric, value in rec.items():
                    if metric in ("Task ID", "Task Name") or _missing(value):
                        continue
                    val_rows.append({
                        "epoch": epoch,
                        "task_id": rec["Task ID"],
                        "task_name": rec["Task Name"],
                        "metric": metric,
                        "value": float(value),
                    })
            for scope_name, scope in (entry.get("moe_stats") or {}).items():
                for key, stats in scope.items():
                    for expert, (imp, load) in enumerate(zip(
                            stats.get("importance", []),
                            stats.get("load", []))):
                        moe_rows.append({
                            "epoch": epoch, "scope": scope_name, "key": key,
                            "task_name": stats.get("task_name", ""),
                            "expert": expert, "importance": float(imp),
                            "load": float(load)})
        d = self.experiment_dir
        _write_csv(d / "train_losses.csv", ["epoch", "task_id", "mean", "std",
                                            "min", "max", "count"], loss_rows)
        _write_csv(d / "training_summary.csv", ["epoch", "avg_train_loss",
                                                "learning_rate",
                                                "epoch_time"], summary_rows)
        if val_rows:
            _write_csv(d / "val_metrics.csv", ["epoch", "task_id",
                                               "task_name", "metric",
                                               "value"], val_rows)
        if moe_rows:
            _write_csv(d / "moe_stats.csv", ["epoch", "scope", "key",
                                             "task_name", "expert",
                                             "importance", "load"], moe_rows)

    # -- one-shot artifacts ------------------------------------------------
    def save_config(self, config_dict: Dict) -> None:
        """config.yaml as JSON text (JSON is YAML: ``yaml.safe_load`` reads
        it), so that no PyYAML is needed to write it."""
        with open(self.experiment_dir / "config.yaml", "w",
                  encoding="utf-8") as f:
            json.dump(config_dict, f, indent=2, default=str)
            f.write("\n")

    def save_final_summary(self, best_epoch: int, best_score: float) -> None:
        summary = {
            "experiment": self.experiment_name,
            "total_epochs": len(self.history),
            "best_epoch": int(best_epoch),
            "best_score": float(best_score),
        }
        with open(self.experiment_dir / "final_summary.json", "w") as f:
            json.dump(summary, f, indent=2)
        with open(self.experiment_dir / "final_summary.txt", "w") as f:
            for k, v in summary.items():
                f.write(f"{k}: {v}\n")

    def save_best_model_summary(self, eval_on_train: Optional[Dict]) -> None:
        """best_model_summary.txt: latest-epoch per-task metrics, group
        mean primary metrics, and the best-model train-set evaluation."""
        lines: List[str] = []
        last = self.history[-1] if self.history else None
        if last is not None:
            lines.append(f"Validation Summary - Best Epoch {last['epoch']}")
            lines.append(
                f"Timestamp: {time.strftime('%Y-%m-%d %H:%M:%S')}")
            lines.append("")
            lines.append("Per-task validation metrics of Best Epoch:")
            lines.append("")
            group_vals: Dict[str, List[float]] = {
                "segmentation": [], "detection": [], "regression": []}
            cls_vals: Dict[str, List[float]] = {"Accuracy": [],
                                                "F1-Score": []}
            for rec in sorted(last.get("val_metrics", []),
                              key=lambda r: str(r.get("Task ID", ""))):
                tid = rec.get("Task ID", "")
                tname = str(rec.get("Task Name", ""))
                metrics = {k: v for k, v in rec.items()
                           if k not in ("Task ID", "Task Name")}
                parts = [f"{k}: {float(v):.4f}" for k, v in metrics.items()
                         if not _missing(v)]
                lines.append(f"  - Task {tid} | {tname} -> "
                             + ", ".join(parts))
                tn = tname.lower()
                if "classification" in tn:
                    for m in ("Accuracy", "F1-Score"):
                        if not _missing(metrics.get(m)):
                            cls_vals[m].append(float(metrics[m]))
                    continue
                g, primary = None, None
                if "segmentation" in tn:
                    g, primary = "segmentation", metrics.get(
                        "Dice", metrics.get("IoU"))
                elif "detection" in tn:
                    g, primary = "detection", metrics.get("IoU")
                elif "regression" in tn:
                    g, primary = "regression", metrics.get(
                        "MAE", metrics.get("MAE (pixels)"))
                if g and not _missing(primary):
                    group_vals[g].append(float(primary))
            lines.append("")
            lines.append("Group mean primary metrics:")
            for m in ("Accuracy", "F1-Score"):
                vals = cls_vals[m]
                lines.append(
                    f"  - Classification {m}: "
                    + (f"{float(np.mean(vals)):.4f} (mean over "
                       f"{len(vals)} task(s))" if vals
                       else "N/A (no tasks found)"))
            for g in ("segmentation", "detection", "regression"):
                vals = group_vals[g]
                lines.append(
                    f"  - {g.title()}: "
                    + (f"{float(np.mean(vals)):.4f} (mean over "
                       f"{len(vals)} task(s))" if vals
                       else "N/A (no tasks found)"))

        if eval_on_train:
            lines.append("")
            lines.append("Best Model Evaluation on Training Set:")
            for group, value in eval_on_train.items():
                if isinstance(value, dict):
                    acc = value.get("Accuracy")
                    f1 = value.get("F1-Score")
                    acc_s = f"{acc:.4f}" if acc is not None else "N/A"
                    f1_s = f"{f1:.4f}" if f1 is not None else "N/A"
                    lines.append(f"  - {group.title()}: Accuracy={acc_s}, "
                                 f"F1-Score={f1_s}")
                elif value is not None:
                    lines.append(f"  - {group.title()}: {value:.4f}")
                else:
                    lines.append(f"  - {group.title()}: N/A")
        if not lines:
            lines = ["(no evaluation available)"]
        with open(self.experiment_dir / "best_model_summary.txt", "w",
                  encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
