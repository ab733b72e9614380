"""The port's data path against the JAX package's: the synthetic generator,
PNG decode (against cv2), resize, the dataset item by item, the sampler,
the split and the data engine.

Tolerances: pixels, masks, labels, indices and batches are exact; a
resized image within 1 of cv2's (cv2 interpolates in 11-bit fixed point,
the host helper in f32) and of the JAX package's (which resizes with cv2);
boxes within 1e-6; a mask read from a colour PNG within 1 of cv2's (libpng
converts colour to gray with its own weights).
"""

import copy
import os

import numpy as np
import pytest

import cv2
from fmc_uia_tpu import native as jax_native
from fmc_uia_tpu.config import Config as JaxConfig
from fmc_uia_tpu.data.dataset import MultiTaskDataset as JaxDataset
from fmc_uia_tpu.data.pipeline import build_data_engines as jax_engines
from fmc_uia_tpu.data.pipeline import split_train_val as jax_split
from fmc_uia_tpu.data.sampler import MultiTaskUniformSampler as JaxSampler
from fmc_uia_tpu.data.synthetic import generate_synthetic_dataset as jax_gen
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data import image_io
from fmc_uia_tpu_torch.data.dataset import MultiTaskDataset, read_index
from fmc_uia_tpu_torch.data.pipeline import (
    build_data_engines,
    split_train_val,
)
from fmc_uia_tpu_torch.data.sampler import MultiTaskUniformSampler
from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset
from helpers import TINY_CONFIG

S = 64


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same seed through both generators."""
    out = {}
    for side, gen in (("jax", jax_gen), ("port", generate_synthetic_dataset)):
        root = str(tmp_path_factory.mktemp(side))
        gen(root, samples_per_task=12, seed=3)
        out[side] = root
    return out


def _pngs(root):
    d = os.path.join(root, "images")
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def test_generator_matches_jax(roots):
    names = _pngs(roots["jax"])
    assert names == _pngs(roots["port"]) and len(names) == 6 * 12 + 2 * 12
    for name in names:
        flag = (cv2.IMREAD_GRAYSCALE if name.endswith("_mask.png")
                else cv2.IMREAD_COLOR)
        a, b = (cv2.imread(os.path.join(roots[s], "images", name), flag)
                for s in ("jax", "port"))
        np.testing.assert_array_equal(a, b, err_msg=name)
    csvs = sorted(os.listdir(os.path.join(roots["jax"], "csv_files")))
    for name in csvs:
        a, b = (open(os.path.join(roots[s], "csv_files", name)).read()
                for s in ("jax", "port"))
        assert a == b, name


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba", "rgb16", "gray16",
                                  "palette", "gray1"])
def test_decode_matches_cv2(tmp_path, kind):
    """PNGs that cv2 (or PIL, for palette and 1-bit) wrote; read as
    IMREAD_COLOR (-> RGB) and IMREAD_GRAYSCALE."""
    rng = np.random.RandomState(0)
    path = str(tmp_path / f"{kind}.png")
    if kind in ("palette", "gray1"):
        from PIL import Image

        a = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
        im = Image.fromarray(a).convert("P") if kind == "palette" else \
            Image.fromarray(a[..., 0]).convert("1")
        im.save(path)
    else:
        shape = {"rgb": (37, 53, 3), "gray": (37, 53), "rgba": (37, 53, 4),
                 "rgb16": (37, 53, 3), "gray16": (37, 53)}[kind]
        dt = np.uint16 if kind.endswith("16") else np.uint8
        cv2.imwrite(path, rng.randint(0, np.iinfo(dt).max + 1, shape)
                    .astype(dt))
    ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(image_io.read_image(path), ref)
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    got = image_io.read_mask(path)
    assert got.shape == ref.shape
    colour = kind in ("rgb", "rgba", "rgb16", "palette")
    assert np.abs(got.astype(int) - ref).max() <= (1 if colour else 0)


@pytest.mark.parametrize("shape", [(37, 53), (96, 112, 3), (40, 30, 4)])
def test_encode_every_filter_round_trips(tmp_path, shape):
    """write_png cycles the five filter types by row; cv2 and image_io
    decode the file to the array written."""
    a = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    image_io.write_png(path, a)
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if raw.ndim == 3:
        raw = raw[..., [2, 1, 0, 3][:raw.shape[2]]]
    np.testing.assert_array_equal(raw, a)
    got = image_io.read_image(path)
    want = a[..., :3] if a.ndim == 3 else np.repeat(a[..., None], 3, -1)
    np.testing.assert_array_equal(got, want)


def test_corrupt_missing_and_interlaced(tmp_path):
    a = np.random.RandomState(2).randint(0, 256, (20, 20, 3)).astype(np.uint8)
    data = image_io.encode_png(a)
    cut = tmp_path / "cut.png"
    cut.write_bytes(data[: len(data) // 2])
    assert image_io.read_image(str(cut)) is None
    flipped = bytearray(data)
    flipped[40] ^= 0xFF  # inside IDAT: the CRC check fails
    (tmp_path / "crc.png").write_bytes(bytes(flipped))
    assert image_io.read_image(str(tmp_path / "crc.png")) is None
    assert image_io.read_image(str(tmp_path / "none.png")) is None
    # the interlace byte of IHDR set (with its CRC), the rows left as they
    # are: the decoder refuses it by name; read_image hands it to cv2,
    # which cannot read it either, so it gives None, as the JAX package
    import struct
    import zlib

    from fmc_uia_tpu.data.dataset import _decode_image

    il = bytearray(data)
    il[28] = 1
    il[29:33] = struct.pack(">I", zlib.crc32(bytes(il[12:29])))
    (tmp_path / "il.png").write_bytes(bytes(il))
    with pytest.raises(ValueError, match="il.png"):
        image_io.decode_png(bytes(il), False, str(tmp_path / "il.png"))
    assert _decode_image(str(tmp_path / "il.png")) is None
    assert image_io.read_image(str(tmp_path / "il.png")) is None


@pytest.mark.parametrize("src,dst", [((180, 260), (96, 128)),
                                     ((576, 768), (64, 64)),
                                     ((37, 53), (64, 64))])
def test_resize_matches_cv2_and_jax_native(src, dst):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    got = image_io.resize_bilinear(img, *dst)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert np.abs(got.astype(int) - ref).max() <= 1
    if jax_native.available():
        np.testing.assert_array_equal(
            got, jax_native.resize_bilinear(img, *dst))
    mask = rng.randint(0, 5, src).astype(np.uint8)
    np.testing.assert_array_equal(
        image_io.resize_nearest(mask, *dst),
        cv2.resize(mask, dst[::-1], interpolation=cv2.INTER_NEAREST))


def test_resize_batch_threaded():
    rng = np.random.RandomState(4)
    imgs = [rng.randint(0, 256, (rng.randint(50, 120), rng.randint(50, 120),
                                 3)).astype(np.uint8) for _ in range(9)]
    batch = image_io.resize_batch(imgs, 64, 64, bilinear=True, num_threads=4)
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(batch[i],
                                      image_io.resize_bilinear(im, 64, 64))


def test_grayscale_3ch_matches_cv2():
    img = np.random.RandomState(5).randint(0, 256, (31, 47, 3)).astype(
        np.uint8)
    got = image_io.to_grayscale_3ch(img)
    ref = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(got, np.stack([ref] * 3, -1))


def test_index_reads_as_pandas(tmp_path):
    """Blank cells and absent columns are missing; numbers typed per column
    within a file; a column holding strings keeps them."""
    d = tmp_path / "csv_files"
    d.mkdir()
    (d / "a.csv").write_text("task_id,num_classes,mask,note\n"
                             "T1,3,2,x\nT1,3,,7\n")
    (d / "b.csv").write_text("task_id,num_classes,x_min\nT4,1,1.5\nT4,1,NA\n")
    rows = read_index(sorted(str(p) for p in d.iterdir()))
    import pandas as pd

    df = pd.concat([pd.read_csv(p) for p in sorted(d.iterdir())],
                   ignore_index=True)
    for i, row in enumerate(rows):
        for col in df.columns:
            ref = df.iloc[i][col]
            got = row.get(col)
            if pd.isna(ref):
                assert got is None, (i, col)
            else:
                assert got == ref and type(got) in (int, float, str), (i, col)


@pytest.fixture(scope="module")
def datasets(roots):
    return (JaxDataset(roots["port"], image_size=S),
            MultiTaskDataset(roots["port"], image_size=S))


def test_dataset_items_match_jax(datasets):
    jds, pds = datasets
    assert len(jds) == len(pds)
    assert jds.derive_task_configs() == pds.derive_task_configs()
    assert jds.max_reg_points == pds.max_reg_points
    for i in range(len(pds)):
        a, b = jds[i], pds[i]
        assert a["task_id"] == b["task_id"]
        assert a["source_index"] == b["source_index"] == i
        assert np.abs(a["image"].astype(int) - b["image"]).max() <= 1
        assert a["label"].dtype == b["label"].dtype
        if b["label"].dtype == np.float32 and b["label"].shape == (4,):
            np.testing.assert_allclose(b["label"], a["label"], rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(b["label"], a["label"])


def test_corrupt_image_takes_the_next_row(tmp_path):
    root = str(tmp_path)
    generate_synthetic_dataset(root, samples_per_task=3, seed=0)
    ds = MultiTaskDataset(root, image_size=S)
    path = os.path.join(ds.csv_path, ds.rows[0]["image_path"])
    with open(path, "r+b") as f:
        f.truncate(100)
    item = ds[0]
    assert item["source_index"] == 1
    np.testing.assert_array_equal(item["image"], ds[1]["image"])


def test_grayscale_and_cache_options(roots):
    ds = MultiTaskDataset(roots["port"], image_size=S, force_grayscale=True,
                          cache_samples=True)
    jd = JaxDataset(roots["port"], image_size=S, force_grayscale=True)
    a, b = jd[5], ds[5]
    assert np.abs(a["image"].astype(int) - b["image"]).max() <= 1
    assert ds[5] is b  # the second read comes from the cache
    # adaptive normalisation: f32 frames, within 1e-6 of the JAX package's
    # (the masks agree exactly; the f32 resize within a few ulps of cv2's)
    ads = MultiTaskDataset(roots["port"], image_size=S,
                           use_adaptive_norm=True, bg_threshold="auto")
    jads = JaxDataset(roots["port"], image_size=S, use_adaptive_norm=True,
                      bg_threshold="auto")
    a, b = jads[5], ads[5]
    assert b["image"].dtype == a["image"].dtype == np.float32
    np.testing.assert_allclose(b["image"], a["image"], rtol=0, atol=1e-6)


def test_sampler_matches_jax_with_advance():
    task_ids = ["a"] * 7 + ["b"] * 5 + ["c"] * 4
    for steps in (9, 30):
        ref = JaxSampler(task_ids, batch_size=3, steps_per_epoch=steps,
                         seed=11)
        got = MultiTaskUniformSampler(task_ids, batch_size=3,
                                      steps_per_epoch=steps, seed=11)
        ref_epochs = [list(ref) for _ in range(3)]
        assert [list(got) for _ in range(3)] == ref_epochs
        resumed = MultiTaskUniformSampler(task_ids, batch_size=3,
                                          steps_per_epoch=steps, seed=11)
        resumed.advance_epochs(2)
        assert list(resumed) == ref_epochs[2]


@pytest.mark.parametrize("val_split,seed", [(0.25, 42), (0.2, 0), (0.5, 7)])
def test_split_matches_jax(datasets, val_split, seed):
    jds, pds = datasets
    ref = jax_split(jds.dataframe, val_split, seed)
    got = split_train_val([r["task_id"] for r in pds.rows], val_split, seed)
    assert list(got) == list(ref)


def _configs(root, **over):
    d = copy.deepcopy(TINY_CONFIG)
    d["data"].update(root_path=root, batch_size=4, image_size=S,
                     num_workers=3)
    d["training"]["steps_per_epoch"] = 7
    for k, v in over.items():
        d["training"][k] = v
    return JaxConfig(config_dict=copy.deepcopy(d)), Config(config_dict=d)


def _same_batch(a, b):
    for k in ("task_id", "task_index", "task_type"):
        assert a[k] == b[k]
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert a["image"].shape == b["image"].shape
    assert a["image"].dtype == b["image"].dtype == np.uint8
    assert np.abs(a["image"].astype(int) - b["image"]).max() <= 1
    assert a["label"].dtype == b["label"].dtype
    np.testing.assert_allclose(b["label"], a["label"], rtol=0, atol=1e-6)


def test_engines_match_jax(roots):
    jcfg, pcfg = _configs(roots["port"])
    jtrain, jval, jreg = jax_engines(jcfg)
    ptrain, pval, preg = build_data_engines(pcfg)
    assert preg.task_ids == jreg.task_ids
    assert pcfg.tasks_from_dataset() and pcfg.get_task_configs() == \
        jcfg.get_task_configs()
    assert ptrain.indices == jtrain.indices and pval.indices == jval.indices
    assert len(ptrain) == len(jtrain) and len(pval) == len(jval)
    for _ in range(2):  # two epochs: the sampler's state carries over
        for a, b in zip(list(jtrain), list(ptrain), strict=True):
            _same_batch(a, b)
    for a, b in zip(list(jval), list(pval), strict=True):
        _same_batch(a, b)
    assert pval.stats["batches"] == len(pval)


def test_engine_producer_error_reaches_the_consumer(roots):
    _, pcfg = _configs(roots["port"])
    train, _, _ = build_data_engines(pcfg)

    def boom(batch):
        raise RuntimeError("put failed")

    train.put_fn = boom
    with pytest.raises(RuntimeError, match="put failed"):
        list(train)
    train.put_fn = None
    it = iter(train)
    next(it)
    it.close()  # an early stop leaves no producer blocked
    assert train.stats["batches"] <= 1 + train.prefetch_depth + 1


@pytest.mark.parametrize("over,match", [
    ({"task_id": "T4_syn_box", "task_name": ""}, None),
    ({"task_id": "", "task_name": "SEGMENTATION"}, None),
    ({"task_id": "nope", "task_name": ""}, "Unknown task_id"),
    ({"task_id": "", "task_name": "nope"}, "Unknown task_name"),
    ({"task_id": "T4_syn_box", "task_name": "detection"}, "only one"),
    ({"task_id": "", "task_name": ""}, "required"),
])
def test_single_task_filter_matches_jax(roots, over, match):
    jcfg, pcfg = _configs(roots["port"],
                          single_task=dict(enabled=True, **over))
    if match:
        with pytest.raises(ValueError, match=match):
            jax_engines(jcfg)
        with pytest.raises(ValueError, match=match):
            build_data_engines(pcfg)
        return
    jtrain, _, jreg = jax_engines(jcfg)
    ptrain, _, preg = build_data_engines(pcfg)
    assert preg.task_ids == jreg.task_ids
    assert ptrain.indices == jtrain.indices


def test_device_cache_and_mesh_raise(roots):
    """data.device_cache builds one cache that both engines share (here on
    the CPU); a mesh that is not a DeviceMesh raises a TypeError (the
    mesh engines: tests/test_torch_parallel_data.py)."""
    _, pcfg = _configs(roots["port"])
    pcfg.config["data"]["device_cache"] = True
    train, val, _ = build_data_engines(pcfg, device="cpu")
    assert train.device_cache is not None
    assert val.device_cache is train.device_cache
    assert train.device_cache.covers(train.indices + val.indices)
    _, pcfg = _configs(roots["port"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_data_engines(pcfg, mesh=object())
