"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
seeded numpy weights in the shape of a JAX params tree, fed to both
packages."""

import numpy as np
import torch

# A whole-suite run puts six pytest workers (``-n 6``) on the host's
# cores, and a CPU ``fit``'s data-loader threads run torch ops beside the
# main thread: at torch's default of one intra-op thread a core, the
# workers' thread teams oversubscribe the cores and the fit tests slow
# down many times over. One thread a process: the port's test files
# import this module, so collection sets it in every worker before any
# test runs.
torch.set_num_threads(1)


def random_like_tree(shapes, seed: int):
    """A nested dict of f32 numpy arrays with the shapes of ``shapes`` (a
    JAX params tree of ShapeDtypeStructs or arrays), drawn from one seed:
    kernels ~ N(0, 1/fan_in) (fan_in = the input-channel axis times any
    spatial taps), LayerNorm/GroupNorm scales and FiLM gammas ~ 1 + N(0,
    0.1^2), everything else ~ N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)

    def leaf(path, shape):
        name = path[-1]
        if name == "kernel":
            # HWIO / [T,kh,kw,I,O] conv: taps * I; dense [I,O] / [T,I,O]: I
            fan_in = shape[-2]
            if len(shape) >= 4:
                fan_in *= shape[-3] * shape[-4]
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name in ("scale", "gammas"):
            return 1.0 + 0.1 * rng.standard_normal(shape)
        return 0.1 * rng.standard_normal(shape)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in sorted(node.items())}
        return leaf(path, tuple(node.shape)).astype(np.float32)

    return walk(shapes, ())


# ---------------------------------------------------------------------------
# a whole train step, JAX package vs port (tests/test_torch_train*.py)
# ---------------------------------------------------------------------------
# swin_micro 64², window 8, fused attention and MLP branches; augmentation,
# dropout and drop path off, so both sides are deterministic
TRAIN_OVERRIDES = {
    "model": {
        "encoder": {"name": "swin_micro", "window_size": 8,
                    "fused_block": True, "fused_mlp": True,
                    "scan_stages": [0, 1, 3], "ln_bf16": True,
                    "drop_path_rate": 0.0},
        "decoder": {"dropout": 0.0},
        "heads": {"classification": {"dropout": 0.0},
                  "regression": {"hidden_dims": [16, 8], "dropout": 0.0}}},
    "data": {"augmentation": {"train": {"random_brightness_contrast": 0.0,
                                        "gauss_noise": 0.0}}},
}
# TRAIN_OVERRIDES with the dense MoE on encoder stages 2 and 3 (C = 128 at
# 4², 256 at 2²): 4 experts, top-2, a task embedding, the balance loss
MOE_OVERRIDES = {
    "model": dict(TRAIN_OVERRIDES["model"], moe={
        "enabled": True, "num_experts": 4, "top_k": 2,
        "stage_indices": [2, 3], "expert_hidden": 8, "router_hidden": 16,
        "use_task_embedding": True, "task_embedding_dim": 8,
        "balance_loss_weight": 0.05, "use_residual": True,
        "dropout": 0.0}),
    "data": TRAIN_OVERRIDES["data"],
}
# MOE_OVERRIDES with baseline.yaml's separate cls and reg FPNs, which
# those heads read
SEPARATE_FPN_OVERRIDES = {
    "model": dict(MOE_OVERRIDES["model"], decoder=dict(
        TRAIN_OVERRIDES["model"]["decoder"],
        separate_classification_fpn=True, separate_regression_fpn=True,
        use_fpn_for_classification=True, use_fpn_for_regression=True)),
    "data": TRAIN_OVERRIDES["data"],
}
# the options of flagship.ablation_a_config_dict / ablation_b_config_dict
# at a tiny width: swin_nano 64² (window 8, fused branches), augmentation,
# dropout and drop path off. A: a deep-supervision seg head, the grid det
# head and loss, embedding FiLM on the FPN and every stage, an additive
# prompt on seg and det, SmoothL1, SGD, accumulation over 2 micro-steps.
# B: the baseline cls / grid det / reg heads, the UNet-like seg head,
# embedding FiLM, a multiplicative prompt on every type, L1, Adam.
_NANO = dict(TRAIN_OVERRIDES["model"]["encoder"], name="swin_nano",
             scan_stages=[])
_TINY_HEADS = TRAIN_OVERRIDES["model"]["heads"]
ABLATION_A_OVERRIDES = {
    "model": dict(TRAIN_OVERRIDES["model"], encoder=_NANO, heads=dict(
        _TINY_HEADS, segmentation={"use_deep_supervision": True},
        detection={"type": "grid"}),
        film={"use_task_embedding": True, "multi_stage": True,
              "embedding_dim": 16},
        task_prompt={"enabled": True, "inject_mode": "add",
                     "apply_to_task_names": ["segmentation", "detection"]}),
    "data": TRAIN_OVERRIDES["data"],
    "training": {"loss_configs": {"detection": {"type": "Detection"},
                                  "Regression": {"type": "SmoothL1Loss"}},
                 "optimizer": {"type": "SGD", "momentum": 0.9},
                 "accumulation_steps": 2},
}
ABLATION_B_OVERRIDES = {
    "model": dict(TRAIN_OVERRIDES["model"], encoder=_NANO, heads=dict(
        _TINY_HEADS, use_baseline=True,
        segmentation={"type": "unet_like"}),
        film={"use_task_embedding": True, "embedding_dim": 16},
        task_prompt={"enabled": True, "inject_mode": "mul"}),
    "data": TRAIN_OVERRIDES["data"],
    "training": {"loss_configs": {"detection": {"type": "Detection"},
                                  "Regression": {"type": "L1Loss"}},
                 "optimizer": {"type": "Adam"}},
}
TRAIN_TASKS = {"segmentation": "T2B_organ_b",
               "classification": "T1_planes", "detection": "T4_box",
               "Regression": "T5_points"}


def train_batch_np(rng, ttype, registry, B=2, S=64):
    """A batch as bench.py makes them, from a numpy RandomState."""
    image = rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    if ttype == "segmentation":
        label = rng.randint(0, 2, (B, S, S)).astype(np.int32)
    elif ttype == "classification":
        label = rng.randint(0, 3, (B,)).astype(np.int32)
    elif ttype == "detection":
        x1 = rng.uniform(0.1, 0.5, (B, 1))
        y1 = rng.uniform(0.1, 0.5, (B, 1))
        label = np.concatenate([x1, y1, x1 + 0.3, y1 + 0.3],
                               axis=1).astype(np.float32)
    else:
        label = rng.rand(B, 4).astype(np.float32)
    tid = TRAIN_TASKS[ttype]
    return {"image": image, "label": label, "task_id": tid,
            "task_index": registry[tid].global_index, "task_type": ttype}


def _host(v):
    """A log value on the host: a float for a scalar, else an f32 array
    (the MoE's per-expert importance and load)."""
    a = np.asarray(v.detach() if hasattr(v, "detach") else v, np.float32)
    return float(a) if a.ndim == 0 else a


def train_step_pair(ttypes, seed=5, overrides=None, size=64):
    """One train step per task type in ``ttypes`` on both sides, from the
    same bridged weights and batch. The JAX side is the package's own step
    (``train.make_train_step``) with an optax transformation that keeps the
    step's (clipped) grads as its state; the port side is
    ``Trainer.compute_grads``. The weights' seed is one where the step is
    well conditioned: no ReLU input of the FPN or the heads sits so near
    zero that the two sides' f32 rounding puts it on different sides of
    the kink (at seed 3 one input of the detection head sat 6.5e-7 of its
    std from zero, and the grads of every leaf before it jumped by up to 7%
    of the leaf's max). ``overrides`` (default ``TRAIN_OVERRIDES``) and
    ``size`` (the square image side) choose another model. Returns {type:
    {jlogs, jgrads (port names and layouts), jgrads_tree (the JAX tree),
    logs, grads, params (the shared numpy weights), jcfg, cfg, model}}."""
    import jax
    import jax.numpy as jnp
    import optax

    from fmc_uia_tpu import losses as jax_losses
    from fmc_uia_tpu.models import build_model as jax_build_model
    from fmc_uia_tpu.models.multitask import MultiTaskModel as JaxModel
    from fmc_uia_tpu.tasks import TaskRegistry as JaxRegistry
    from fmc_uia_tpu.train import TrainState, make_train_step
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.tasks import TaskRegistry
    from fmc_uia_tpu_torch.train import Trainer
    from fmc_uia_tpu_torch.utils.convert import (
        jax_leaves_to_port,
        load_jax_params,
    )
    from helpers import make_tiny_config

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def keep_grads(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    tx = optax.GradientTransformation(init, keep_grads)
    jcfg = make_tiny_config(**(TRAIN_OVERRIDES if overrides is None
                               else overrides))
    jreg = JaxRegistry.from_config(jcfg)
    jmodel = jax_build_model(jcfg, jreg)
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                            method=JaxModel.init_all))["params"]
    params = random_like_tree(shapes, seed=seed)
    loss_fns, loss_weights, _ = jax_losses.build_all_losses(jcfg, jreg)
    cfg = Config(config_dict=jcfg.config)
    reg = TaskRegistry.from_config(cfg)
    model = build_model(cfg, reg, device="cpu")
    load_jax_params(model, params)
    trainer = Trainer(cfg, model, reg, device="cpu", seed=0)
    out = {}
    for ttype in ttypes:
        batch = train_batch_np(np.random.RandomState(4), ttype, reg,
                               S=size)
        step = jax.jit(make_train_step(jmodel, tx, jcfg, jreg, ttype,
                                       loss_fns, loss_weights)[1])

        state = TrainState(step=jnp.asarray(0, jnp.int32),
                           params={"model": params},
                           opt_state=tx.init({"model": params}))
        new_state, jlogs = step(
            state, jnp.asarray(batch["image"]), jnp.asarray(batch["label"]),
            jnp.int32(batch["task_index"]), jnp.float32(1e-3),
            jnp.float32(1.0), jax.random.PRNGKey(0))
        jgrads_tree = jax.tree_util.tree_map(
            np.asarray, new_state.opt_state["model"])
        logs = trainer.compute_grads(batch)
        out[ttype] = dict(
            jlogs={k: _host(v) for k, v in jlogs.items()},
            jgrads=jax_leaves_to_port(jgrads_tree), jgrads_tree=jgrads_tree,
            logs={k: _host(v) for k, v in logs.items()},
            grads={n: p.grad.numpy().copy()
                   for n, p in model.named_parameters()},
            params=params, jcfg=jcfg, cfg=cfg, model=model)
    return out


def check_train_step(r, leaf_tol=lambda name: 1e-4):
    """The loss and the grad norm within 1e-5 relative, and every gradient
    leaf within ``leaf_tol(name)`` (default 1e-4) of its largest
    magnitude (None: the caller holds that leaf itself)."""
    for key in ("total_loss", "raw_loss", "grad_norm"):
        ref, got = r["jlogs"][key], r["logs"][key]
        assert abs(got - ref) <= 1e-5 * abs(ref), (key, got, ref)
    assert r["logs"]["task_weight"] == r["jlogs"]["task_weight"]
    assert set(r["grads"]) == set(r["jgrads"])
    bad = []
    for name, ref in r["jgrads"].items():
        got = r["grads"][name]
        assert got.shape == ref.shape, name
        err = float(np.abs(got - ref).max())
        tol = leaf_tol(name)
        if tol is not None and not err <= tol * float(np.abs(ref).max()):
            bad.append((name, err, float(np.abs(ref).max())))
    assert not bad, bad[:5]


ROUTER_LEAVES = ("router_fc1.", "router_fc2.", "task_embed")


def check_moe_logs(r, top_k=2):
    """The MoE step logs: ``moe_aux`` (the blocks' balance losses summed)
    within 1e-5 relative, ``moe_importance`` (mean over blocks) within
    1e-6, ``moe_load`` equal; importance sums to 1 and load to top_k."""
    ref, got = r["jlogs"], r["logs"]
    assert set(got) == set(ref), (set(got), set(ref))
    assert abs(got["moe_aux"] - ref["moe_aux"]) <= 1e-5 * abs(ref["moe_aux"])
    assert np.abs(got["moe_importance"] - ref["moe_importance"]).max() <= 1e-6
    np.testing.assert_array_equal(got["moe_load"], ref["moe_load"])
    assert abs(float(got["moe_importance"].sum()) - 1.0) <= 1e-5
    assert abs(float(got["moe_load"].sum()) - top_k) <= 1e-6


def check_moe_train_step(r, zero_blocks=()):
    """``check_train_step`` for a step with MoE blocks. The router leaves
    (``router_fc1/2``, ``task_embed``) are held to 1e-3 of their largest
    magnitude: their grad is a sum over B·H·W·C of the expert outputs
    times the output's grad, pulled back through the top-k renormalisation
    and the softmax, and it cancels, so f32 rounding moves it further than
    any other leaf's (the port's own router grads move by up to 8e-4 of
    their max when every weight is perturbed by 1e-7 relative; the other
    leaves by < 1e-4). In ``zero_blocks`` (``moe_stage{i}``) the router
    leaves' exact grad is zero, and both sides must be within 1e-8 of it:
    the step's head does not read that block's output, and every sample
    picked the same experts, so its balance loss is the constant E (the
    renormalised gates of the chosen experts sum to 1)."""
    def router(name):
        return name.startswith("moe_stage") and any(
            k in name for k in ROUTER_LEAVES)

    zero = [n for n in r["jgrads"]
            if router(n) and n.split(".")[0] in zero_blocks]
    for name in zero:
        top = max(np.abs(r["grads"][name]).max(),
                  np.abs(r["jgrads"][name]).max())
        assert top <= 1e-8, (name, top)
    check_train_step(r, lambda name: (None if name in zero else
                                      1e-3 if router(name) else 1e-4))


def constant_unread_blocks(r, ttype):
    """The MoE blocks of step ``r`` whose router grads are exactly zero
    (``check_moe_train_step``'s ``zero_blocks``): the head of ``ttype``
    reads the last encoder stage only (no FPN), and every sample of the
    step's batch picked the same experts in the block (its load all 0 or
    1), found by the port's forward on that batch."""
    import torch

    from fmc_uia_tpu_torch.ops.image import normalize_images

    model, cfg = r["model"], r["cfg"]
    if model._needs_fpn(ttype):
        return ()
    b = train_batch_np(np.random.RandomState(4), ttype, model.registry,
                       S=cfg.image_size)
    x = normalize_images(torch.from_numpy(b["image"]),
                         cfg.get("data.augmentation.normalize.mean"),
                         cfg.get("data.augmentation.normalize.std"))
    with torch.no_grad():
        _, inter = model(x, ttype, torch.tensor(b["task_index"]),
                         return_intermediates=True)
    last = len(model.encoder.out_channels) - 1
    return tuple(f"moe_stage{i}" for i, load in zip(model.moe_stages,
                                                   inter["moe_load"])
                 if i != last and set(load.tolist()) <= {0.0, 1.0})


def check_optimizer_update(r, lr=1e-3):
    """One grouped-AdamW update from the JAX step's (clipped) grads on both
    sides: optax ``build_optimizer`` on the JAX tree, the port's
    ``build_optimizer`` on the bridged model; every updated leaf within
    1e-6 of its largest magnitude, and every leaf with a nonzero grad
    moved."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from fmc_uia_tpu.train import build_optimizer as jax_build_optimizer
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.train import build_optimizer
    from fmc_uia_tpu_torch.utils.convert import (
        jax_leaves_to_port,
        load_jax_params,
    )

    tree = jax.tree_util.tree_map
    jparams = {"model": tree(jnp.asarray, r["params"])}
    tx = jax_build_optimizer(r["jcfg"], jparams)
    upd, _ = tx.update({"model": tree(jnp.asarray, r["jgrads_tree"])},
                       tx.init(jparams), jparams)
    new = optax.apply_updates(jparams, tree(lambda u: -lr * u, upd))
    ref = jax_leaves_to_port(tree(np.asarray, new["model"]))
    model = build_model(r["cfg"], r["model"].registry, device="cpu")
    load_jax_params(model, r["params"])
    opt = build_optimizer(r["cfg"], model)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(r["jgrads"][name].copy())
    opt.step(lr)
    old = jax_leaves_to_port(r["params"])
    bad = []
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        err = float(np.abs(got - ref[name]).max())
        if not err <= 1e-6 * float(np.abs(ref[name]).max()):
            bad.append((name, err))
        if np.abs(r["jgrads"][name]).max() > 0:
            assert not np.array_equal(got, old[name]), name
    assert not bad, bad[:5]
