"""Pretrained encoders from a local checkpoint (``model.encoder.pretrained``)
against the JAX package's ``load_pretrained_encoder``, through the weight
bridge.

Synthetic state dicts are built from the key/shape manifests
(``utils/timm_manifests.py``, the port's copy of the JAX package's) and
saved with ``torch.save``: timm Swin v1 (both PatchMerging layouts) at
window 12, loaded into swin_micro at window 12, 8 and 7; a timm plain ViT
at 224² / patch 16 (a 14² grid) into a narrow vit_b at 512² (32²); a
DINOv3 (facebookresearch naming, a ``teacher.backbone.`` wrapper, a
missing LayerScale) into a narrow DINOv3. Both packages start from the same
seeded weights (bridged into the port), load the file, and the port's
encoder is held against the JAX tree bridged to the port's layout.

Tolerances: bitwise where nothing is resampled. The resampling weights
equal ``jax.image.resize``'s bitwise; the resampled Swin relative-position
tables and ViT pos-embed are within 2e-6 of their largest value: JAX
contracts the weights in f32 (the port in f64, rounding once), and its own
rounding leaves it up to 1.22e-6 of the largest value off the exact
resample (measured over 54 seeded tables and grids, window 12 -> 7, 8 and
16 -> 12, grids 14 <-> 32, 16 -> 15, 37 -> 32), so 1e-6 is below the
reference's own error. The ``--verify`` CLI runs in a subprocess on the
CPU.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models import build_model as jax_build_model
from fmc_uia_tpu.models.encoders import vit as jvit
from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
from fmc_uia_tpu.utils import convert as J
from fmc_uia_tpu.utils import timm_manifests as JM
from fmc_uia_tpu_torch.config import Config
from fmc_uia_tpu_torch.data.synthetic import generate_synthetic_dataset
from fmc_uia_tpu_torch.fit import fit
from fmc_uia_tpu_torch.models import build_model
from fmc_uia_tpu_torch.models.encoders import vit as pvit
from fmc_uia_tpu_torch.utils import convert as P
from fmc_uia_tpu_torch.utils import timm_manifests as M
from helpers import TINY_CONFIG, make_tiny_config
from torch_port_utils import random_like_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(embed_dim=64, depth=2, num_heads=2)
SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))
RESAMPLED = ("rel_pos_bias", "pos_embed")
RESAMPLE_TOL = 2e-6


def synth_state_dict(manifest, seed):
    """Random tensors with the manifest's keys and shapes (the relative
    position index a long buffer, the RoPE periods positive)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, shape in manifest.items():
        if k.endswith("relative_position_index"):
            sd[k] = torch.zeros(shape, dtype=torch.long)
        elif k.endswith("rope_embed.periods"):
            sd[k] = torch.from_numpy(
                rng.uniform(1.0, 100.0, shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy(
                (0.1 * rng.standard_normal(shape)).astype(np.float32))
    return sd


def test_manifests_are_the_jax_packages():
    for fn, args in ((M.swin_manifest, (32, (2, 2, 2, 2), (2, 4, 8, 16), 12,
                                        5, "old")),
                     (M.swin_manifest, ()), (M.vit_manifest, ()),
                     (M.dinov3_manifest, ()), (M.resnet50_manifest, ())):
        assert fn(*args) == getattr(JM, fn.__name__)(*args)


@pytest.mark.parametrize("n_in,n_out", [(23, 13), (23, 15), (13, 23),
                                         (14, 32), (32, 14), (16, 15)])
def test_cubic_weights_are_jaxs(n_in, n_out):
    from jax._src.image import scale

    ref = scale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                   scale._fill_keys_cubic_kernel, True)
    np.testing.assert_array_equal(P._cubic_weights(n_in, n_out),
                                  np.asarray(ref))


@pytest.mark.parametrize("src,dst", [(12, 7), (12, 8), (7, 12)])
def test_rel_pos_resample_matches_jax(src, dst):
    t = np.random.RandomState(src * dst).standard_normal(
        ((2 * src - 1) ** 2, 8)).astype(np.float32)
    ref = J.interpolate_rel_pos_bias(t, dst)
    got = P.interpolate_rel_pos_bias(t, dst)
    assert got.shape == ref.shape == ((2 * dst - 1) ** 2, 8)
    assert np.abs(got - ref).max() <= RESAMPLE_TOL * np.abs(ref).max()


def pair(overrides, seed=3):
    """The JAX model's params (seeded, abstract init) and the port model
    with the same weights."""
    jcfg = make_tiny_config(**overrides)
    jmodel = jax_build_model(jcfg, JaxRegistry.from_config(jcfg))
    size = jcfg.image_size
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32),
        method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=seed)
    model = build_model(Config(config_dict=copy.deepcopy(jcfg.config)),
                        dtype=torch.float32, device="cpu")
    P.load_jax_params(model, params)
    return jcfg, params, model


def check_loaded(model, ref_encoder_tree, before, resampled=RESAMPLED):
    want = P.jax_leaves_to_port({"encoder": ref_encoder_tree})
    changed = 0
    for name, p in model.named_parameters():
        if not name.startswith("encoder."):
            continue
        got, ref = p.detach().numpy(), want[name]
        if name.rsplit(".", 1)[-1] in resampled:
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert err <= RESAMPLE_TOL, (name, err)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        changed += not np.array_equal(got, before[name])
    return changed


@pytest.mark.parametrize("window,layout,wrap", [
    (12, "new", None), (8, "old", "state_dict"), (7, "new", "model")])
def test_swin_checkpoint_matches_jax(tmp_path, window, layout, wrap):
    sd = synth_state_dict(M.swin_manifest(**SWIN, window=12, num_classes=5,
                                          layout=layout), seed=window)
    path = str(tmp_path / "swin.pth")
    torch.save(sd if wrap is None else {wrap: sd}, path)
    _, params, model = pair({"data": {"image_size": 64}, "model": {
        "encoder": {"name": "swin_micro", "window_size": window,
                    "pretrained": path}}})
    before = {k: v.detach().numpy().copy()
              for k, v in model.named_parameters()}
    ref = J.load_pretrained_encoder("swin_micro", path, params["encoder"])
    P.load_pretrained_into(model.encoder, "swin_micro", path)
    bias = model.encoder.stage0_block0.attn.rel_pos_bias
    assert bias.shape[0] == (2 * window - 1) ** 2
    # every encoder leaf but none of the others came from the file
    assert check_loaded(model, ref, before) == len(
        list(model.encoder.parameters()))


def vit_overrides(name, path, size, **enc):
    return {"data": {"image_size": size}, "model": {"encoder": dict(
        name=name, pretrained=path, out_indices=[0, 1],
        adapter={"type": "resize", "channels": 32}, **enc)}}


def test_vit_checkpoint_resamples_its_grid(tmp_path, monkeypatch):
    monkeypatch.setitem(jvit._VIT_VARIANTS, "vit_b", dict(NARROW))
    monkeypatch.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
    sd = synth_state_dict(M.vit_manifest(64, 2, 16, img_size=224,
                                         num_classes=3), seed=5)
    path = str(tmp_path / "vit.pth")
    torch.save(sd, path)
    _, params, model = pair(vit_overrides("vit_b", path, 512))
    bb = model.encoder.backbone
    assert bb.num_prefix == 1 and bb.pos_embed.shape == (1, 1 + 32 * 32, 64)
    before = {k: v.detach().numpy().copy()
              for k, v in model.named_parameters()}
    ref = J.load_pretrained_encoder("vit_b", path, params["encoder"])
    P.load_pretrained_into(model.encoder, "vit_b", path)
    check_loaded(model, ref, before)
    # the cls row of pos_embed is the checkpoint's, bitwise
    np.testing.assert_array_equal(bb.pos_embed.detach()[0, 0].numpy(),
                                  sd["pos_embed"][0, 0].numpy())


def test_dinov3_checkpoint_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(jvit._VIT_VARIANTS, "vit_b", dict(NARROW))
    monkeypatch.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
    sd = synth_state_dict(M.dinov3_manifest(64, 2, 2, 16, 4), seed=6)
    del sd["blocks.1.ls2.gamma"]  # missing: keeps its initial value
    path = str(tmp_path / "dino.pth")
    torch.save({f"teacher.backbone.{k}": v for k, v in sd.items()}, path)
    _, params, model = pair(vit_overrides(
        "dinov3", path, 64, timm_name="vit_base_patch16_dinov3",
        freeze_dino=True))
    bb = model.encoder.backbone
    assert bb.rope and bb.num_prefix == 5
    before = {k: v.detach().numpy().copy()
              for k, v in model.named_parameters()}
    ref = J.load_pretrained_encoder("dinov3", path, params["encoder"])
    P.load_pretrained_into(model.encoder, "dinov3", path)
    check_loaded(model, ref, before, resampled=())
    np.testing.assert_array_equal(bb.rope_periods.detach().numpy(),
                                  sd["rope_embed.periods"].numpy())
    np.testing.assert_array_equal(bb.block1.ls2.detach().numpy(),
                                  before["encoder.backbone.block1.ls2"])


def test_refusals_match_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(jvit._VIT_VARIANTS, "vit_b", dict(NARROW))
    monkeypatch.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
    sd = synth_state_dict(M.dinov3_manifest(64, 2, 2, 16, 4), seed=7)
    del sd["storage_tokens"]
    path = str(tmp_path / "nostorage.pth")
    torch.save(sd, path)
    _, params, model = pair(vit_overrides(
        "dinov3", path, 64, timm_name="vit_base_patch16_dinov3"))
    for fn in (lambda: J.load_pretrained_encoder("dinov3", path,
                                                 params["encoder"]),
               lambda: P.load_pretrained_into(model.encoder, "dinov3",
                                              path)):
        with pytest.raises(ValueError, match="storage tokens"):
            fn()
    # a checkpoint of another width: the shape check raises on both sides
    sd = synth_state_dict(M.swin_manifest(48, (2, 2, 2, 2), (2, 4, 8, 16),
                                          8, 0), seed=8)
    path = str(tmp_path / "wide.pth")
    torch.save(sd, path)
    _, params, model = pair({"data": {"image_size": 64}, "model": {
        "encoder": {"name": "swin_micro", "window_size": 8}}})
    with pytest.raises(ValueError, match="shape mismatch"):
        J.load_pretrained_encoder("swin_micro", path, params["encoder"])
    with pytest.raises(ValueError, match="shape mismatch"):
        P.load_pretrained_into(model.encoder, "swin_micro", path)
    with pytest.raises(FileNotFoundError):
        P.load_pretrained_into(model.encoder, "swin_micro",
                               str(tmp_path / "none.pth"))


@pytest.mark.parametrize("family", ["swin", "vit", "dinov3"])
def test_verify_cli(tmp_path, capsys, family):
    """``--verify`` on a file of each family: the CLI in a subprocess for
    the Swin file, ``verify_checkpoint`` in process for the others; a key
    missing from the file fails the manifest check."""
    manifest = {"swin": lambda: M.swin_manifest(**SWIN, window=7,
                                                num_classes=0),
                "vit": lambda: M.vit_manifest(64, 2, 16, num_classes=0),
                "dinov3": lambda: M.dinov3_manifest(64, 2, 2, 16, 4)}[family]
    sd = synth_state_dict(manifest(), seed=9)
    path = str(tmp_path / f"{family}.pth")
    torch.save(sd, path)
    np_sd = P.load_torch_state_dict(path)
    assert P._detect_family(np_sd) == J._detect_family(np_sd) == family
    assert P._infer_geometry(np_sd, family) == J._infer_geometry(np_sd,
                                                                 family)
    args = ["--verify", path, "--device", "cpu", "--image-size", "64"]
    if family == "swin":
        r = subprocess.run(
            [sys.executable, "-m", "fmc_uia_tpu_torch.utils.convert", *args],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        ok, out = r.returncode == 0, r.stdout + r.stderr
    else:
        ok = P.verify_checkpoint(path, image_size=64, device="cpu")
        out = capsys.readouterr().out
    assert ok, out
    assert "manifest OK" in out and "finite OK" in out
    assert "RESULT: PASS" in out
    first = next(k for k in sd if k.endswith("norm1.weight"))
    del sd[first]
    torch.save(sd, path)
    assert not P.verify_checkpoint(path, image_size=64, device="cpu")
    assert "missing-vs-manifest" in capsys.readouterr().out


def test_fit_from_a_dinov3_checkpoint_keeps_the_frozen_backbone(
        tmp_path, monkeypatch):
    """``fit`` loads the file after building the model; under freeze_dino
    the backbone after two steps is the checkpoint's, bitwise."""
    monkeypatch.setitem(pvit._VIT_VARIANTS, "vit_b", dict(NARROW))
    sd = synth_state_dict(M.dinov3_manifest(64, 2, 2, 16, 4), seed=10)
    path = str(tmp_path / "dino.pth")
    torch.save(sd, path)
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, samples_per_task=4, seed=1)
    d = copy.deepcopy(TINY_CONFIG)
    d["data"].update(root_path=root, batch_size=2, image_size=32)
    d["model"]["encoder"] = dict(
        name="dinov3", timm_name="vit_base_patch16_dinov3", pretrained=path,
        freeze_dino=True, out_indices=[0, 1],
        adapter={"type": "resize", "channels": 32})
    d["experiment"].update(output_dir=str(tmp_path / "out"),
                           save_checkpoints=True, checkpoint_freq=1)
    d["training"].update(num_epochs=1, steps_per_epoch=2)
    r = fit(config=Config(config_dict=d), device="cpu")
    ckpt = torch.load(os.path.join(r["experiment_dir"],
                                   "checkpoint_epoch_1.pt"),
                      map_location="cpu", weights_only=True)["model"]
    want = P.jax_leaves_to_port({"encoder": {"backbone": J.convert_dinov3(
        P.load_torch_state_dict(path))}})
    for name, a in want.items():
        assert np.array_equal(ckpt[name].numpy(), a), name
    # the adapter trained
    assert not np.array_equal(
        ckpt["encoder.adapter.proj0.kernel"].numpy(), 0)
