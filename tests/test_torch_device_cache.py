"""The device-resident dataset cache (``data/device_cache.py``) on CPU
tensors, held against the host collate path and against the JAX package's
``DeviceDatasetCache`` (mirrors ``tests/test_device_cache.py``).

The synthetic frames are 48 x 48, the training size, so that neither side
resizes and the two packages' images are the same bytes. Every comparison
is bitwise: images, labels (uint8 masks widened on the device), ``valid``
masks, staged bytes, the tasks that stream and the fit's losses.
"""

import copy
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from fmc_uia_tpu.data.dataset import MultiTaskDataset as JaxDataset
from fmc_uia_tpu.data.device_cache import DeviceDatasetCache as JaxCache
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.dataset import MultiTaskDataset
from fmc_uia_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
    _narrow_labels,
    build_device_cache,
    sample_bytes,
)
from fmc_uia_tpu_torch.data.pipeline import DataEngine, _collate
from fmc_uia_tpu_torch.data.sampler import MultiTaskUniformSampler
from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset
from fmc_uia_tpu_torch.fit import fit
from fmc_uia_tpu_torch.tasks import SEGMENTATION, TaskRegistry
from helpers import TINY_CONFIG

S = 48
TYPES = ["segmentation", "classification", "detection", "Regression"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("synth_port_cache"))
    generate_synthetic_dataset(r, samples_per_task=8, image_hw=(S, S),
                               seed=3)
    return r


@pytest.fixture(scope="module")
def ds_registry(root):
    ds = MultiTaskDataset(root, image_size=S)
    return ds, TaskRegistry(ds.derive_task_configs())


def cache(ds, registry, indices=None, **kw):
    idx = range(len(ds)) if indices is None else indices
    return DeviceDatasetCache(ds, idx, registry, device="cpu", **kw)


def rows_of(ds, key, value, n=None):
    rows = [i for i, r in enumerate(ds.rows) if r[key] == value]
    return rows if n is None else rows[:n]


def host_batch(ds, registry, rows, n_valid=None):
    """The host path's batch as the step sees it: collated, labels widened
    as ``Trainer.put_batch`` widens them."""
    b = _collate([ds[i] for i in rows], registry, n_valid=n_valid)
    label = torch.from_numpy(np.ascontiguousarray(b["label"]))
    if not label.is_floating_point():
        label = label.long()
    return dict(b, image=torch.from_numpy(b["image"]), label=label)


def same(got, want):
    for k in ("task_id", "task_index", "task_type"):
        assert got[k] == want[k]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["image"].dtype == want["image"].dtype
    assert torch.equal(got["image"], want["image"])
    assert got["label"].dtype == want["label"].dtype
    assert torch.equal(got["label"], want["label"])


def test_narrow_labels_roundtrip():
    lab = np.random.RandomState(0).randint(0, 5, (4, 8, 8)).astype(np.int32)
    narrow = _narrow_labels(SEGMENTATION, lab, num_classes=5)
    assert narrow.dtype == np.uint8
    assert np.array_equal(narrow.astype(np.int32), lab)
    reg = np.random.RandomState(1).rand(4, 6).astype(np.float32)
    assert _narrow_labels("Regression", reg, 3) is reg


@pytest.mark.parametrize("task_name", TYPES)
def test_gathered_batch_matches_host_and_jax(root, ds_registry, task_name):
    ds, registry = ds_registry
    c = cache(ds, registry)
    rows = rows_of(ds, "task_name", task_name, 5)
    rows = [rows[1], rows[3], rows[0]]  # an arbitrary order
    got = c.get_batch(rows)
    assert got["image"].dtype == torch.uint8
    same(got, host_batch(ds, registry, rows))
    jds = JaxDataset(root, image_size=S)
    jc = JaxCache(jds, range(len(jds)), JaxRegistry(jds.derive_task_configs()))
    ref = jc.get_batch(rows)
    np.testing.assert_array_equal(got["image"].numpy(),
                                  np.asarray(ref["image"]))
    np.testing.assert_array_equal(got["label"].numpy(),
                                  np.asarray(ref["label"]))
    assert c.nbytes == jc.nbytes


def test_engine_with_cache_yields_the_host_batches(ds_registry):
    ds, registry = ds_registry
    indices = list(range(len(ds)))

    def engine():
        sampler = MultiTaskUniformSampler(
            task_ids_per_index=[ds.rows[i]["task_id"] for i in indices],
            batch_size=4, steps_per_epoch=6, seed=11)
        return DataEngine(ds, indices, registry, 4, shuffle_sampler=sampler,
                          num_workers=1, prefetch_depth=0)

    plain, cached = engine(), engine()
    cached.device_cache = cache(ds, registry)
    n = 0
    for a, b in zip(plain, cached, strict=True):
        assert torch.is_tensor(b["image"]) and not torch.is_tensor(a["image"])
        label = torch.from_numpy(a["label"])
        label = label if label.is_floating_point() else label.long()
        same(b, dict(a, image=torch.from_numpy(a["image"]), label=label))
        n += 1
    assert n == 6


def test_eval_padding_valid_mask(ds_registry):
    ds, registry = ds_registry
    indices = list(range(len(ds)))
    eng = DataEngine(ds, indices, registry, batch_size=5, num_workers=1,
                     prefetch_depth=0, drop_last=False)
    plain = DataEngine(ds, indices, registry, batch_size=5, num_workers=1,
                       prefetch_depth=0, drop_last=False)
    eng.device_cache = cache(ds, registry)
    batches = list(eng)
    padded = [b for b in batches if not b["valid"].all()]
    assert len(padded) == len(registry.task_ids)  # 8 rows a task at 5
    for b in padded:
        assert b["image"].shape[0] == 5 and b["valid"].sum() == 3
    for a, b in zip(plain, batches, strict=True):
        label = torch.from_numpy(a["label"])
        label = label if label.is_floating_point() else label.long()
        same(b, dict(a, image=torch.from_numpy(a["image"]), label=label))


def test_budget_fallback(ds_registry, capsys):
    ds, registry = ds_registry
    assert build_device_cache(ds, range(len(ds)), registry, budget_bytes=100,
                              device="cpu") is None
    assert "no task fits the budget" in capsys.readouterr().out
    assert build_device_cache(ds, range(len(ds)), registry,
                              budget_bytes=4 << 30, device="cpu") is not None


def test_partial_staging_matches_jax(root, ds_registry, capsys):
    """A budget that fits the largest task alone: the same tasks stream as
    in the JAX package, and the staged ones serve the host's batches."""
    ds, registry = ds_registry
    jds = JaxDataset(root, image_size=S)
    jreg = JaxRegistry(jds.derive_task_configs())
    full = JaxCache(jds, range(len(jds)), jreg)
    sizes = sorted((full._images[t].nbytes + full._labels[t].nbytes
                    for t in full._images), reverse=True)
    for budget in (sizes[0] + 1, sizes[0] + sizes[1], sum(sizes) - 1):
        ref = JaxCache(jds, range(len(jds)), jreg, budget_bytes=budget,
                       partial=True)
        got = cache(ds, registry, budget_bytes=budget)
        assert got.skipped_tasks == ref.skipped_tasks and got.skipped_tasks
        assert got.nbytes == ref.nbytes <= budget
        assert sorted(got._images) == sorted(ref._images)
    assert "streams from the host" in capsys.readouterr().out
    staged = next(iter(got._images))
    rows = rows_of(ds, "task_id", staged, 3)
    assert got.covers(rows)
    same(got.get_batch(rows), host_batch(ds, registry, rows))
    assert not got.covers(rows_of(ds, "task_id", got.skipped_tasks[0], 2))


def test_budget_is_checked_before_any_decode(ds_registry, monkeypatch):
    ds, registry = ds_registry
    decoded = []
    orig = type(ds).__getitem__
    monkeypatch.setattr(type(ds), "__getitem__",
                        lambda self, i: decoded.append(i) or orig(self, i))
    assert build_device_cache(ds, range(len(ds)), registry,
                              budget_bytes=1000, device="cpu") is None
    assert decoded == []
    # only the staged tasks' rows are decoded, once each
    per_task = 8 * sample_bytes(ds, "segmentation", 2)
    c = cache(ds, registry, budget_bytes=per_task + 1)
    assert sorted(decoded) == sorted(c.position)
    assert len(c._images) == 1
    # the reckoned bytes are the banks' bytes
    full = cache(ds, registry)
    assert full.nbytes == sum(full._images[t].nbytes + full._labels[t].nbytes
                              for t in full._images)


def test_card_out_of_memory_propagates(ds_registry, monkeypatch):
    """A CUDA out-of-memory error while staging is not turned into
    streaming (only the budget decides what streams)."""
    ds, registry = ds_registry

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(DeviceDatasetCache, "_stage", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        build_device_cache(ds, range(len(ds)), registry, 4 << 30,
                           device="cpu")


def test_substituted_rows_are_recorded(tmp_path, capsys):
    r = str(tmp_path / "data")
    generate_synthetic_dataset(r, samples_per_task=4, image_hw=(S, S), seed=5)
    ds = MultiTaskDataset(r, image_size=S)
    with open(os.path.join(ds.csv_path, ds.rows[2]["image_path"]), "r+b") as f:
        f.truncate(100)
    c = cache(ds, TaskRegistry(ds.derive_task_configs()))
    assert c.substituted == [(2, 3)]
    assert "decoded from row 3" in capsys.readouterr().out


def test_f32_banks_under_adaptive_norm(root):
    ds = MultiTaskDataset(root, image_size=S, use_adaptive_norm=True)
    registry = TaskRegistry(ds.derive_task_configs())
    c = cache(ds, registry)
    assert all(b.dtype == torch.float32 for b in c._images.values())
    assert c.nbytes == sum(c._images[t].nbytes + c._labels[t].nbytes
                           for t in c._images)
    rows = rows_of(ds, "task_name", "segmentation", 4)
    same(c.get_batch(rows), host_batch(ds, registry, rows))


def test_cache_covers_subset_only(ds_registry):
    ds, registry = ds_registry
    c = cache(ds, registry, indices=range(10))
    assert c.covers(range(10))
    assert not c.covers([0, 11])


def test_fit_with_cache_gives_the_same_losses(tmp_path):
    """A tiny fit (swin_micro at 64², resized from 96 x 112 frames) with
    ``data.device_cache`` on and off: the same train losses, validation
    rows and best-model evaluation, bit for bit."""
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, samples_per_task=8, seed=6)

    def run(on):
        d = copy.deepcopy(TINY_CONFIG)
        d["data"].update(root_path=root, batch_size=4, image_size=64,
                         num_workers=2, device_cache=on,
                         fused_preprocess=True)
        d["model"]["encoder"] = {"name": "swin_micro", "window_size": 8}
        d["experiment"]["output_dir"] = str(tmp_path / f"out_{on}")
        d["training"].update(num_epochs=2, steps_per_epoch=3)
        r = fit(config=Config(config_dict=d), device="cpu")
        hist = json.loads((Path(r["experiment_dir"])
                           / "training_history.json").read_text())
        return ([e["train_losses"] for e in hist],
                [e["val_metrics"] for e in hist], r["best_eval_on_train"])

    assert run(True) == run(False)
