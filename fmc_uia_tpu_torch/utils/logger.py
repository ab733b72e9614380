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
writes NaN). The JAX package's training-curve plots are drawn from those
CSVs, read with ``csv`` (pandas' grouped means: keys sorted, missing
values skipped), by ``plot_training_curves`` and
``plot_comprehensive_training_curves``; matplotlib is imported inside them
only:

  training_curves.png                 loss, lr, epoch time, mean val metric
  training_loss_per_task.png          2x3: loss per task group + average
  validation_metrics_per_task.png     2x3: primary metric per group + avg
  training_summary_comprehensive.png  2x2: train/val by group, per task,
                                      lr and epoch time
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


# ---------------------------------------------------------------------------
# training-curve plots
# ---------------------------------------------------------------------------
def _read_csv(path: Path) -> List[Dict]:
    """Rows of a CSV this logger wrote: ``epoch`` as int, the numeric
    columns as float (an empty cell NaN), the rest as strings."""
    if not path.exists():
        return []
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    text = ("task_id", "task_name", "metric", "scope", "key")
    for r in rows:
        for k, v in r.items():
            if k == "epoch":
                r[k] = int(v)
            elif k not in text:
                r[k] = float(v) if v != "" else math.nan
    return rows


def _mean_by(rows: List[Dict], key: str, col: str):
    """``groupby(key)[col].mean()``: the sorted keys and the means over
    the present values (NaN where a key has none)."""
    groups: Dict = {}
    for r in rows:
        groups.setdefault(r[key], []).append(r[col])
    keys = sorted(groups)
    means = []
    for k in keys:
        vals = [v for v in groups[k] if not math.isnan(v)]
        means.append(sum(vals) / len(vals) if vals else math.nan)
    return keys, means


def plot_training_curves(experiment_dir) -> None:
    """The 4-panel basic curves (``training_curves.png``)."""
    experiment_dir = Path(experiment_dir)
    if not (experiment_dir / "training_summary.csv").exists():
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    summary = _read_csv(experiment_dir / "training_summary.csv")
    epochs = [r["epoch"] for r in summary]
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    axes[0, 0].plot(epochs, [r["avg_train_loss"] for r in summary])
    axes[0, 0].set_title("Avg train loss")
    axes[0, 1].plot(epochs, [r["learning_rate"] for r in summary])
    axes[0, 1].set_title("Learning rate")
    axes[0, 1].set_yscale("log")
    axes[1, 0].plot(epochs, [r["epoch_time"] for r in summary])
    axes[1, 0].set_title("Epoch time (s)")
    if (experiment_dir / "val_metrics.csv").exists():
        val = _read_csv(experiment_dir / "val_metrics.csv")
        axes[1, 1].plot(*_mean_by(val, "epoch", "value"))
        axes[1, 1].set_title("Mean val metric")
    for ax in axes.flat:
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(experiment_dir / "training_curves.png", dpi=120)
    plt.close(fig)


_GROUPS = ("classification", "segmentation", "detection", "regression")
_GROUP_COLORS = {"classification": "#1f77b4", "segmentation": "#ff7f0e",
                 "detection": "#2ca02c", "regression": "#d62728"}
_AVG_COLOR = "#9467bd"
_PRIMARY_METRICS = {  # per-group primary validation metric
    "classification": ("Accuracy", "F1-Score"),
    "segmentation": ("Dice", "IoU"),
    "detection": ("IoU",),
    "regression": ("MAE (pixels)", "MAE"),
}


def _group_of(task_name: str) -> Optional[str]:
    tn = str(task_name).lower()
    for g in _GROUPS:
        if g in tn:
            return g
    return None


def plot_comprehensive_training_curves(experiment_dir) -> None:
    """The three per-group figures (``training_loss_per_task.png``,
    ``validation_metrics_per_task.png`` when there are validation rows,
    ``training_summary_comprehensive.png``)."""
    experiment_dir = Path(experiment_dir)
    if not (experiment_dir / "train_losses.csv").exists():
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    losses = _read_csv(experiment_dir / "train_losses.csv")
    val = _read_csv(experiment_dir / "val_metrics.csv")
    summary = _read_csv(experiment_dir / "training_summary.csv")
    tid_group = {r["task_id"]: _group_of(r["task_name"]) for r in val}
    group_loss = {g: _mean_by([r for r in losses
                               if tid_group.get(r["task_id"]) == g],
                              "epoch", "mean") for g in _GROUPS}
    avg_loss = _mean_by(losses, "epoch", "mean")

    # ---- figure 1: training loss per group + average -------------------
    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    fig.suptitle("Training Loss - Per Group & Average", fontsize=16,
                 fontweight="bold")
    panels = list(_GROUPS) + ["average", "all"]
    for ax, panel in zip(axes.flat, panels):
        if panel == "average":
            ax.plot(*avg_loss, color=_AVG_COLOR, marker="s", markersize=3)
            ax.set_title("Average (all tasks)")
        elif panel == "all":
            for g in _GROUPS:
                if group_loss[g][0]:
                    ax.plot(*group_loss[g], color=_GROUP_COLORS[g],
                            label=g.title(), alpha=0.8)
            ax.plot(*avg_loss, color=_AVG_COLOR, linestyle="--",
                    label="Average")
            ax.legend(fontsize=8)
            ax.set_title("All groups")
        else:
            if group_loss[panel][0]:
                ax.plot(*group_loss[panel], color=_GROUP_COLORS[panel],
                        marker="o", markersize=3)
            ax.set_title(panel.title())
        ax.set_xlabel("epoch")
        ax.set_ylabel("train loss")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(experiment_dir / "training_loss_per_task.png", dpi=150,
                bbox_inches="tight")
    plt.close(fig)

    # ---- figure 2: validation primary metric per group + average -------
    def primary_series(g):
        keys = _PRIMARY_METRICS[g]
        return _mean_by([r for r in val if _group_of(r["task_name"]) == g
                         and r["metric"] in keys], "epoch", "value")

    if val:
        fig, axes = plt.subplots(2, 3, figsize=(18, 10))
        fig.suptitle("Validation Metrics - Per Group & Average",
                     fontsize=16, fontweight="bold")
        series = {g: primary_series(g) for g in _GROUPS}
        # the overall average leaves out the regression MAE (its scale)
        avg_val = _mean_by([r for r in val if r["metric"] != "MAE (pixels)"],
                           "epoch", "value")
        for ax, panel in zip(axes.flat, panels):
            if panel == "average":
                ax.plot(*avg_val, color=_AVG_COLOR, marker="s",
                        markersize=3)
                ax.set_title("Average (score metrics)")
            elif panel == "all":
                for g in _GROUPS:
                    if series[g][0]:
                        ax.plot(*series[g], color=_GROUP_COLORS[g],
                                label=g.title(), alpha=0.8)
                ax.legend(fontsize=8)
                ax.set_title("All groups (primary metric)")
            else:
                if series[panel][0]:
                    ax.plot(*series[panel], color=_GROUP_COLORS[panel],
                            marker="o", markersize=3)
                ax.set_title(f"{panel.title()} "
                             f"({_PRIMARY_METRICS[panel][0]})")
            ax.set_xlabel("epoch")
            ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(experiment_dir / "validation_metrics_per_task.png",
                    dpi=150, bbox_inches="tight")
        plt.close(fig)

    # ---- figure 3: combined summary ------------------------------------
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    fig.suptitle("Training & Validation Summary - All Tasks", fontsize=16,
                 fontweight="bold")
    ax = axes[0, 0]
    for g in _GROUPS:
        if group_loss[g][0]:
            ax.plot(*group_loss[g], color=_GROUP_COLORS[g], label=g.title(),
                    marker="o", markersize=3, alpha=0.7)
    ax.plot(*avg_loss, color=_AVG_COLOR, linestyle="--", linewidth=2.5,
            label="Average")
    ax.set_title("Training loss by group")
    ax.legend(fontsize=8)

    ax = axes[0, 1]
    if val:
        for g in _GROUPS:
            s = primary_series(g)
            if s[0]:
                ax.plot(*s, color=_GROUP_COLORS[g], label=g.title(),
                        marker="o", markersize=3, alpha=0.7)
        ax.legend(fontsize=8)
    ax.set_title("Validation primary metric by group")

    ax = axes[1, 0]
    for tid in sorted({r["task_id"] for r in losses}):
        rows = [r for r in losses if r["task_id"] == tid]
        ax.plot([r["epoch"] for r in rows], [r["mean"] for r in rows],
                alpha=0.6, linewidth=1, label=tid)
    ax.legend(fontsize=5, ncol=3)
    ax.set_title("Training loss per task")

    ax = axes[1, 1]
    if summary:
        epochs = [r["epoch"] for r in summary]
        line1 = ax.plot(epochs, [r["learning_rate"] for r in summary],
                        color="#17becf", marker="o", markersize=3,
                        label="Learning Rate")
        ax.set_yscale("log")
        ax.set_ylabel("Learning rate", color="#17becf")
        ax2 = ax.twinx()
        line2 = ax2.plot(epochs, [r["epoch_time"] for r in summary],
                         color="#bcbd22", marker="^", markersize=3,
                         label="Epoch Time")
        ax2.set_ylabel("Epoch time (s)", color="#bcbd22")
        lines = line1 + line2
        ax.legend(lines, [ln.get_label() for ln in lines], fontsize=8)
    ax.set_title("Learning Rate & Training Time")
    for ax in axes.flat:
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(experiment_dir / "training_summary_comprehensive.png",
                dpi=150, bbox_inches="tight")
    plt.close(fig)
