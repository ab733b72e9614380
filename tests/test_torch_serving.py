"""The port's StreamingPredictor on the CPU (device="cpu"): mixed traffic
over the 4 task types, each result equal to Predictor.predict_images on
the same image; the power-of-two pad chain's stats; close() drains the
queues."""

import numpy as np
import pytest
import torch

from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.export import Predictor
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.serving import StreamingPredictor
from fmc_uia_tpu_torch.tasks import TaskRegistry
from helpers import TINY_CONFIG, make_tiny_config

TASKS = ("T2A_organ_a", "T1_planes", "T4_box", "T5_points")
S = 32


@pytest.fixture(scope="module")
def setup():
    jcfg = make_tiny_config(
        data={"image_size": S},
        model={"encoder": {"name": "swin_micro", "window_size": 8,
                           "fused_block": True, "fused_mlp": True}})
    cfg = Config(config_dict=jcfg.config)
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    norm = TINY_CONFIG["data"]["augmentation"]["normalize"]
    images = np.random.RandomState(0).randint(
        0, 256, (12, S, S, 3)).astype(np.uint8)
    return model, reg, norm["mean"], norm["std"], images


def _svc(setup, **kw):
    model, reg, mean, std, _ = setup
    return StreamingPredictor(model, reg, mean, std, S, device="cpu", **kw)


def test_mixed_traffic_matches_predictor(setup):
    model, reg, mean, std, images = setup
    pred = Predictor(model, reg, mean, std, S, device="cpu")
    svc = _svc(setup, max_batch=4, max_delay_ms=2.0)
    futs = [svc.submit(images[i], TASKS[i % 4]) for i in range(len(images))]
    results = [f.result(timeout=120) for f in futs]
    svc.close()
    for i, got in enumerate(results):
        ref = pred.predict_images(images[i:i + 1], TASKS[i % 4])[0]
        assert got.shape == ref.shape
        if reg[TASKS[i % 4]].task_name in ("segmentation", "classification"):
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert svc.stats["dispatches"] >= 4
    assert (sum(k * v for k, v in svc.stats["by_size"].items())
            == len(images) + svc.stats["pad_images"])


def test_pad_chain_stats(setup):
    """3 requests of one task under a long deadline: one dispatch, padded
    up the chain [1, 2, 4] to 4."""
    _, _, _, _, images = setup
    svc = _svc(setup, max_batch=4, max_delay_ms=2000.0)
    assert svc._chain == [1, 2, 4]
    futs = [svc.submit(images[i], "T1_planes") for i in range(3)]
    for f in futs:
        f.result(timeout=120)
    svc.close()
    assert svc.stats["dispatches"] == 1
    assert svc.stats["pad_images"] == 1
    assert dict(svc.stats["by_size"]) == {4: 1}


def test_close_drains_queues(setup):
    _, _, _, _, images = setup
    svc = _svc(setup, max_batch=8, max_delay_ms=10_000.0)
    futs = [svc.submit(images[i], TASKS[i % 4]) for i in range(6)]
    svc.close()  # the deadline is far away: close() must flush them
    assert all(f.done() and f.exception() is None for f in futs)
    assert all(q.empty() for q in svc._queues.values())
    with pytest.raises(RuntimeError):
        svc.submit(images[0], TASKS[0])
