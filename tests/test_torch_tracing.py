"""The port's spans (``fmc_uia_tpu_torch/utils/profiling.py``) on the CPU:
off, a span is one shared null context that reads no clock; on, a train
step is one ``train.step`` covered by its four phases in order (also under
gradient accumulation), a served request has ``serve.request`` and
``serve.queue`` under one request id and the dispatch spans agree with
``stats``, the ``kernel.*`` spans count what ``.launches`` counts, and the
bound drops and counts what is over it."""

import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.ops import preprocess, swin_block, vit_attention
from fmc_uia_tpu_torch.serving import StreamingPredictor
from fmc_uia_tpu_torch.tasks import TaskRegistry
from fmc_uia_tpu_torch.train import Trainer
from fmc_uia_tpu_torch.utils import profiling
from fmc_uia_tpu_torch.utils.profiling import StepTimer
from helpers import TINY_CONFIG, make_tiny_config
from torch_port_utils import TRAIN_OVERRIDES, train_batch_np

PHASES = ("train.prep", "train.forward", "train.backward", "train.update")
TASKS = ("T2A_organ_a", "T1_planes", "T4_box", "T5_points")
S = 32


def _raise(*_):
    raise AssertionError("the span clock was read")


@pytest.fixture(autouse=True)
def _not_recording():
    """Every test starts and ends with recording off."""
    profiling.stop()
    yield
    profiling.stop()


def _trainer(**training):
    jcfg = make_tiny_config(model=TRAIN_OVERRIDES["model"],
                            data=TRAIN_OVERRIDES["data"],
                            training=training)
    cfg = Config(config_dict=jcfg.config)
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return Trainer(cfg, model, reg, device="cpu", seed=0), reg


def _launches():
    return {"kernel.K1f": swin_block.attention_branch.launches,
            "kernel.K1b": swin_block.attention_branch_backward.launches,
            "kernel.K2f": swin_block.mlp_branch.launches,
            "kernel.K2b": swin_block.mlp_branch_backward.launches,
            "kernel.K3": preprocess.augment_normalize.launches,
            "kernel.K4f": vit_attention.global_attention.launches,
            "kernel.K4b": vit_attention.global_attention_backward.launches}


def _check_steps(records, n):
    """``n`` train.step spans, each covered by its four phases in order."""
    steps = [r for r in records if r.name == "train.step"]
    assert [r.ids["step"] for r in steps] == list(range(n))
    for st in steps:
        kids = sorted((r for r in records if r.parent == st.id),
                      key=lambda r: r.start_ns)
        assert tuple(r.name for r in kids) == PHASES
        assert kids[0].start_ns >= st.start_ns
        assert kids[-1].end_ns <= st.end_ns
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        covered = sum(r.end_ns - r.start_ns for r in kids)
        assert covered >= 0.9 * (st.end_ns - st.start_ns)
        assert all(r.tid == st.tid for r in kids)


def test_off_is_one_null_object_and_reads_no_clock(monkeypatch):
    """Off: ``span`` returns the same null context whatever it is given,
    ``now_ns`` is 0, ``add_span`` records nothing, and a whole train step
    reads the span clock never."""
    monkeypatch.setattr(profiling, "_clock", _raise)
    assert profiling._recording is None
    assert profiling.span("train.step") is profiling.span("kernel.K1f",
                                                          step=3)
    with profiling.span("train.step", step=0):
        pass
    assert profiling.now_ns() == 0
    profiling.add_span("serve.queue", 0, request=1)
    trainer, reg = _trainer()
    trainer.train_batch(train_batch_np(np.random.RandomState(0),
                                       "segmentation", reg), 0)
    assert profiling.stop() == profiling.Recorded([], 0, {})


def test_train_step_spans():
    """Two steps: each a ``train.step`` (ids: the host step) holding
    prep, forward, backward and update in order, on one thread, covering
    it; every name is one of ``SPANS``; the kernel spans count what
    ``.launches`` counts."""
    trainer, reg = _trainer()
    rng = np.random.RandomState(1)
    batches = [train_batch_np(rng, t, reg)
               for t in ("segmentation", "detection")]
    before = _launches()
    profiling.record()
    for b in batches:
        trainer.train_batch(b, 0)
    out = profiling.stop()
    after = _launches()
    assert out.dropped == 0
    _check_steps(out.records, 2)
    assert {r.name for r in out.records} <= set(profiling.SPANS)
    assert set(out.threads) == {r.tid for r in out.records}
    spans = Counter(r.name for r in out.records)
    for name in before:
        assert spans[name] == after[name] - before[name]


def test_accumulation_steps_have_the_same_spans():
    trainer, reg = _trainer(accumulation_steps=2)
    rng = np.random.RandomState(2)
    profiling.record()
    for t in ("classification", "Regression", "segmentation"):
        trainer.train_batch(train_batch_np(rng, t, reg), 0)
    _check_steps(profiling.stop().records, 3)


def test_serving_spans_agree_with_stats():
    """Mixed traffic over the 4 tasks: every request has one
    ``serve.request`` and one ``serve.queue`` under its id, the queue
    inside the request; the dispatch spans' sizes, real images and
    request ids agree with ``stats`` and the requests; each dispatch
    holds one ``serve.inflight_wait`` and has one ``serve.flight``."""
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
        0, 256, (14, S, S, 3)).astype(np.uint8)
    profiling.record()
    svc = StreamingPredictor(model, reg, norm["mean"], norm["std"], S,
                             max_batch=4, max_delay_ms=2.0, device="cpu")
    futs = [svc.submit(images[i], TASKS[i % 4]) for i in range(len(images))]
    for f in futs:
        f.result(timeout=120)
    svc.close()
    out = profiling.stop()
    by = {}
    for r in out.records:
        by.setdefault(r.name, []).append(r)
    req = {r.ids["request"]: r for r in by["serve.request"]}
    queue = {r.ids["request"]: r for r in by["serve.queue"]}
    assert len(req) == len(by["serve.request"]) == len(images)
    assert set(queue) == set(req) and len(by["serve.queue"]) == len(images)
    for rid, q in queue.items():
        assert q.start_ns == req[rid].start_ns
        assert q.end_ns <= req[rid].end_ns
    assert Counter(r.ids["task"] for r in queue.values()) == Counter(
        TASKS[i % 4] for i in range(len(images)))
    disp = by["serve.dispatch"]
    st = svc.stats
    assert len(disp) == st["dispatches"]
    assert Counter(r.ids["size"] for r in disp) == st["by_size"]
    assert sum(r.ids["size"] - r.ids["n_real"] for r in disp) == (
        st["pad_images"])
    assert sorted(i for r in disp for i in r.ids["requests"]) == sorted(req)
    assert all(len(r.ids["requests"]) == r.ids["n_real"] for r in disp)
    waits = Counter(r.parent for r in by["serve.inflight_wait"])
    assert waits == Counter(r.id for r in disp)
    flights = Counter(r.ids["dispatch"] for r in by["serve.flight"])
    assert flights == Counter(r.ids["dispatch"] for r in disp)
    assert "serve.idle" in by


def test_bound_drops_and_counts():
    profiling.record(limit=3)
    with pytest.raises(RuntimeError):
        profiling.record()
    for i in range(5):
        with profiling.span("train.step", step=i):
            pass
    out = profiling.stop()
    assert [r.ids["step"] for r in out.records] == [0, 1, 2]
    assert out.dropped == 2
    assert profiling.stop() == profiling.Recorded([], 0, {})


def test_parents_are_per_thread():
    """A span's parent is the span open on its own thread; a span opened
    on another thread while one is open here has none; a span timed by
    its caller (``add_span``) has none and closes on the calling
    thread."""
    profiling.record()
    t0 = profiling.now_ns()
    with profiling.span("train.step", step=0) as outer:
        with profiling.span("train.prep"):
            pass
        th = threading.Thread(target=lambda: profiling.span(
            "kernel.K1b").__enter__().__exit__(None, None, None))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    profiling.add_span("serve.queue", t0, request=7)
    out = profiling.stop()
    by = {r.name: r for r in out.records}
    assert by["train.prep"].parent == outer.id
    assert by["train.step"].parent is None
    assert by["kernel.K1b"].parent is None
    assert by["kernel.K1b"].tid != by["train.step"].tid
    assert by["serve.queue"].parent is None
    assert by["serve.queue"].start_ns == t0
    assert by["serve.queue"].tid == threading.get_native_id()
    assert len(out.threads) == 2


def test_bound_holds_under_contending_threads():
    """16 threads closing spans at once, the interpreter switching every
    microsecond: exactly the bound kept, the rest counted as dropped,
    every id once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        profiling.record(limit=20_000)

        def work():
            for _ in range(2_000):
                with profiling.span("kernel.K1f"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        out = profiling.stop()
    finally:
        sys.setswitchinterval(old)
    assert len(out.records) == 20_000
    assert out.dropped == 16 * 2_000 - 20_000
    assert len({r.id for r in out.records}) == 20_000
    assert len(out.threads) == 16


def test_a_span_open_at_stop_is_not_recorded():
    profiling.record()
    cm = profiling.span("train.step", step=0)
    cm.__enter__()
    out = profiling.stop()
    cm.__exit__(None, None, None)
    assert out.records == []


def test_step_timer_summary_keys():
    """``StepTimer.summary`` gives the count, the mean and the median
    step, and with a batch size the images a second at the median."""
    t = StepTimer(window=2, skip_windows=0)
    for _ in range(6):
        t.lap()
    out = t.summary(batch_size=4)
    assert set(out) == {"steps", "mean_s", "p50_s", "images_per_sec"}
    assert out["steps"] == 4
    assert out["images_per_sec"] == pytest.approx(4 / out["p50_s"])
