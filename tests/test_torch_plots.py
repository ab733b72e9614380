"""The training-curve plots (``plot_training_curves``,
``plot_comprehensive_training_curves``) against the JAX package's, on the
CSVs the port's ``TrainingLogger`` writes for a seeded 4-epoch history
(tasks of the four types, one task with no validation row, a missing
metric value, a task whose losses start at epoch 2).

Every ``Axes.plot`` call of both packages is recorded: the same calls in
the same order, the same labels and colours, the same x values, and the
same y values within 1e-12 relative (pandas' grouped means sum with Kahan
compensation, the port's in plain order). The PNG files are written.
"""

import math
import shutil

import matplotlib
import matplotlib.axes
import numpy as np
import pytest

from fmc_uia_tpu.utils import logger as JL
from fmc_uia_tpu_torch.utils import logger as PL

matplotlib.use("Agg")

TASKS = {"T1_seg": "segmentation", "T2_seg": "segmentation",
         "T3_cls": "classification", "T4_box": "detection",
         "T5_pts": "Regression", "T6_cls": "classification"}
METRIC = {"segmentation": ["Dice"], "classification": ["Accuracy",
                                                       "F1-Score"],
          "detection": ["IoU"], "Regression": ["MAE (pixels)"]}
FILES = ["training_curves.png", "training_loss_per_task.png",
         "validation_metrics_per_task.png",
         "training_summary_comprehensive.png"]


@pytest.fixture()
def experiment(tmp_path):
    rng = np.random.RandomState(0)
    log = PL.TrainingLogger(str(tmp_path), "plots")
    for epoch in range(1, 5):
        losses = {t: list(rng.rand(3) + 1.0 / epoch) for t in TASKS
                  if t != "T6_cls" or epoch > 1}
        rows = []
        for t, ttype in TASKS.items():
            if t == "T2_seg":  # no validation row: no group for its loss
                continue
            row = {"Task ID": t, "Task Name": ttype}
            for m in METRIC[ttype]:
                row[m] = float(rng.rand())
            if t == "T3_cls" and epoch == 2:
                row["F1-Score"] = math.nan  # a missing value
            rows.append(row)
        log.log_epoch(epoch, losses, rows, learning_rate=1e-3 / epoch,
                      epoch_time=10.0 + epoch)
    return log.get_experiment_dir()


def record(monkeypatch):
    calls = []
    orig = matplotlib.axes.Axes.plot

    def plot(self, *args, **kw):
        calls.append((np.asarray(args[0], float), np.asarray(args[1], float),
                      kw.get("label"), kw.get("color"),
                      kw.get("linestyle"), kw.get("marker")))
        return orig(self, *args, **kw)

    monkeypatch.setattr(matplotlib.axes.Axes, "plot", plot)
    return calls


def test_plots_match_jax(experiment, tmp_path, monkeypatch):
    jdir = tmp_path / "jax"
    shutil.copytree(experiment, jdir)
    calls = {}
    for side, mod, d in (("jax", JL, jdir), ("port", PL, experiment)):
        rec = record(monkeypatch)
        mod.plot_training_curves(d)
        mod.plot_comprehensive_training_curves(d)
        calls[side] = rec
        monkeypatch.undo()
        for name in FILES:
            assert (d / name).stat().st_size > 0, (side, name)
    ref, got = calls["jax"], calls["port"]
    assert len(got) == len(ref) > 30
    for k, (a, b) in enumerate(zip(ref, got)):
        assert a[2:] == b[2:], k
        np.testing.assert_array_equal(b[0], a[0], err_msg=str(k))
        np.testing.assert_allclose(b[1], a[1], rtol=1e-12, err_msg=str(k))


def test_plots_without_matplotlib_raise_import_error(experiment,
                                                     monkeypatch):
    """``fit`` catches the failure and prints one line; the plot functions
    themselves need matplotlib only when they draw."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        PL.plot_training_curves(experiment)
    PL.plot_training_curves(experiment / "absent")  # nothing to plot
