"""The rank functions of the parallel-mode tests (tests/test_torch_parallel_
*.py), run by ``fmc_uia_tpu_torch.parallel.run_local`` in spawned
processes. This module imports numpy and torch only, and the port inside
the functions: a child never loads jax, flax or the JAX package (each
function checks). It holds no tests of its own."""

import copy
import sys

import numpy as np
import torch

FORBIDDEN = ("jax", "flax", "fmc_uia_tpu")


def forbidden_modules():
    return sorted(m for m in sys.modules if any(
        m == f or m.startswith(f + ".") for f in FORBIDDEN))


def _check_isolated():
    bad = forbidden_modules()
    assert not bad, bad


def _np(t):
    return t.detach().cpu().float().numpy().copy()


def _trainer(cfg_dict, params, mesh_spec, parallel=None, seed=0):
    """A port Trainer on the CPU from a config dict and port-named numpy
    weights, under a mesh of ``mesh_spec`` ({axis: size}, or None)."""
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.parallel import make_mesh
    from fmc_uia_tpu_torch.train import Trainer

    d = copy.deepcopy(cfg_dict)
    if parallel:
        d["parallel"] = dict(parallel)
    cfg = Config(config_dict=d)
    model = build_model(cfg, device="cpu")
    if params is not None:
        load_port_params(model, params)
    mesh = None
    if mesh_spec:
        mesh = make_mesh(axes=tuple(mesh_spec),
                         shape=tuple(mesh_spec.values()))
    return Trainer(cfg, model, device="cpu", seed=seed, mesh=mesh)


def load_port_params(model, params):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(params[name])))


def _logs(logs):
    return {k: _np(v) for k, v in logs.items()}


ROUTER = ("router_fc1.", "router_fc2.", "task_embed")


def check_step(got, ref, loss_keys=("total_loss", "raw_loss", "grad_norm"),
               floor=1e-4):
    """``got`` / ``ref``: {"logs", "grads"} of one step. The losses (and
    grad norm) within 1e-5 relative; each leaf within 1e-4 of its max
    (the MoE router's 1e-3, as ``check_moe_train_step`` holds them: their
    grads cancel), or of 1e-4 of the step's largest leaf max where its
    own grad cancels to nearly nothing (random weights leave some leaves,
    e.g. stage 3's relative-position table, at ~1e-7 while others are
    ~1: the f32 gap of a reordered sum scales with the terms summed, not
    with what is left of them); ``floor`` sets that share."""
    for k in loss_keys:
        a, b = float(got["logs"][k]), float(ref["logs"][k])
        assert abs(a - b) <= 1e-5 * abs(b), (k, a, b)
    assert set(got["grads"]) == set(ref["grads"])
    top = max(float(np.abs(v).max()) for v in ref["grads"].values())
    for n, v in ref["grads"].items():
        g = got["grads"][n]
        assert g.shape == v.shape, n
        err = float(np.abs(g - v).max())
        tol = 1e-3 if any(k in n for k in ROUTER) else 1e-4
        assert err <= tol * max(float(np.abs(v).max()), floor * top), (
            n, err)


def run_jobs(rank, world, jobs):
    """Each job ``(name, kwargs)`` of this module's ``*_job`` functions in
    turn, on one process group: their results in order."""
    _check_isolated()
    out = [globals()[name + "_job"](rank, world, **kw) for name, kw in jobs]
    _check_isolated()
    return out


def grads_job(rank, world, cfg_dict, params, batches, mesh_spec,
              parallel=None):
    """One ``compute_grads`` per batch (by type, in order); the logs and
    the whole grads (single-process names) of each, and the number of
    tensor-parallel leaves and parameter bytes of this rank."""
    _check_isolated()
    t = _trainer(cfg_dict, params, mesh_spec, parallel)
    out = {}
    for key, batch in batches.items():
        logs = t.compute_grads(batch)
        out[key] = {"logs": _logs(logs),
                    "grads": {n: _np(g) for n, g in t.whole_grads().items()}}
    nbytes = sum(p.numel() * p.element_size() for p in t.model.parameters())
    _check_isolated()
    return {"steps": out, "tp_dims": dict(t.tp_dims), "param_bytes": nbytes,
            "zero_dims": dict(t.zero_dims)}


def train_job(rank, world, cfg_dict, params, batches, mesh_spec,
              parallel=None):
    """``train_batch`` on each batch in order; the logs, the model state
    (single-process format) and the optimizer count; with ZeRO the
    sharded fraction of the optimizer state."""
    from fmc_uia_tpu_torch.parallel import zero_sharded_fraction

    _check_isolated()
    t = _trainer(cfg_dict, params, mesh_spec, parallel)
    logs = [_logs(t.train_batch(b, 0)) for b in batches]
    state = {k: _np(v) for k, v in t.model_state().items()}
    return {"logs": logs, "state": state, "count": t.optimizer.count,
            "zero_fraction": zero_sharded_fraction(t.optimizer),
            "opt": {k: [[_np(x) for x in g] for g in v]
                    for k, v in t.optimizer_state().items()
                    if k in ("mu", "nu", "trace")}}


def loss_job(rank, world, arrays):
    """Dice, CenterNet and cross entropy on this rank's rows: under the
    batch scope (global) and alone (the per-rank loss a DDP-style mean
    would average)."""
    import torch.distributed as dist

    from fmc_uia_tpu_torch import losses
    from fmc_uia_tpu_torch.parallel import comm

    _check_isolated()
    group = dist.group.WORLD
    B = arrays["logits"].shape[0]
    m = B // world
    rows = (rank * m, (rank + 1) * m, B)

    def mine(a):
        return torch.from_numpy(a[rank * m:(rank + 1) * m])

    def run():
        dice = losses.dice_loss_multiclass(
            mine(arrays["logits"]), mine(arrays["seg"]),
            num_valid_classes=torch.tensor(arrays["ncls"]))
        ce = losses.cross_entropy_loss(mine(arrays["logits"]),
                                       mine(arrays["seg"]))
        det = losses.centernet_loss(
            {k: mine(arrays["pred_" + k]) for k in
             ("heatmap", "size", "offset")},
            {k: mine(arrays["tgt_" + k]) for k in
             ("heatmap", "size", "offset", "mask")})
        return {"dice": dice, "ce": ce, "det": det}

    x = mine(arrays["logits"]).requires_grad_(True)
    with comm.batch_scope(group, rows):
        glob = run()
        # the grad of the global Dice w.r.t. this rank's logits
        gl = losses.dice_loss_multiclass(x, mine(arrays["seg"]),
                                         num_valid_classes=torch.tensor(
                                             arrays["ncls"]))
        gl.backward()
    alone = run()
    mean = {k: comm.all_reduce_(v.detach().clone(), group) / world
            for k, v in alone.items()}
    return {"global": {k: float(v) for k, v in glob.items()},
            "ddp_mean": {k: float(v) for k, v in mean.items()},
            "dice_grad": _np(x.grad)}


def ep_expert_fn(p, tokens):
    """The expert of the expert-parallel tests: tanh(tokens W_e) + b_e
    over the last dim (tests/test_torch_parallel_ep.py has JAX's twin)."""
    return torch.tanh(tokens @ p["w"]) + p["b"]


def ep_job(rank, world, arrays, cases):
    """``ragged_moe_apply`` over all ranks as the ``model`` axis, for each
    (top_k, capacity_factor) case: the output, and the grads of
    sum(out * cot) w.r.t. the expert params, x and probs (whole: every
    rank holds them); plus the dense reference."""
    from fmc_uia_tpu_torch.parallel import (
        dense_moe_reference,
        make_mesh,
        ragged_moe_apply,
    )

    mesh = make_mesh(axes=("model",), shape=(world,))
    out = []
    for top_k, cf in cases:
        x = torch.from_numpy(arrays["x"]).requires_grad_(True)
        probs = torch.from_numpy(arrays["probs"]).requires_grad_(True)
        params = {k: torch.from_numpy(arrays[k]).requires_grad_(True)
                  for k in ("w", "b")}
        y = ragged_moe_apply(ep_expert_fn, params, x, probs, mesh,
                             axis="model", top_k=top_k,
                             capacity_factor=cf)
        (y * torch.from_numpy(arrays["cot"])).sum().backward()
        dense = dense_moe_reference(ep_expert_fn, params, x.detach(),
                                    probs.detach(), top_k=top_k)
        out.append({"y": _np(y), "dense": _np(dense), "dx": _np(x.grad),
                    "dprobs": _np(probs.grad),
                    "dw": _np(params["w"].grad), "db": _np(params["b"].grad)})
    return out


def moe_block_job(rank, world, cfg_dict, params, batch):
    """The MoE model with ``dispatch: ragged`` on a {model: world} mesh:
    a forward of every MoE block inside the mesh's scope against the
    dense dispatch of the same weights, and one Trainer step (tensor
    parallelism off: the experts split by the dispatch alone); then the
    scope is gone: the mesh Trainer left nothing installed."""
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.parallel import (
        activation_mesh,
        activation_mesh_scope,
        comm,
        make_mesh,
    )

    mesh = make_mesh(axes=("model",), shape=(world,))
    d = copy.deepcopy(cfg_dict)
    d["model"]["moe"]["dispatch"] = "ragged"
    ragged = build_model(Config(config_dict=d), device="cpu")
    load_port_params(ragged, params)
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (4, 8, 8, 128)).astype(np.float32))
    block = ragged.moe_stage2
    with torch.no_grad(), activation_mesh_scope(mesh):
        y_rag = block(x, torch.tensor(0))[0]
    block.dispatch = "dense"
    with torch.no_grad():
        y_dense = block(x, torch.tensor(0))[0]
    block.dispatch = "ragged"
    t = _trainer(d, params, {"model": world},
                 parallel={"tensor_parallel": False})
    logs = _logs(t.compute_grads(batch))
    grads = {n: _np(g) for n, g in t.whole_grads().items()}
    left = (activation_mesh(), comm._SCOPE)
    try:
        with torch.no_grad():
            block(x, torch.tensor(0))
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"y_rag": _np(y_rag), "y_dense": _np(y_dense), "logs": logs,
            "grads": grads, "left": [v is None for v in left],
            "raised": raised}


def pipe_stage_fn(p, x):
    """The pipeline tests' stage: tanh(x W + b) (JAX's twin in
    tests/test_torch_parallel_pipeline.py)."""
    return torch.tanh(x @ p["w"] + p["b"])


SWIN_KW = dict(embed_dim=16, depths=(2, 2, 4, 2), num_heads=(1, 2, 4, 8),
               window_size=4, drop_path_rate=0.0)


def pipe_job(rank, world, arrays, swin):
    """``pipeline_apply`` over all ranks as the ``pipe`` axis (forward and
    the grads of sum(out * cot) w.r.t. the stacked params and the input),
    its sequential twin, ``pipeline_swin_stage`` on stage 2 of a small
    Swin (weights ``swin["params"]``, port names) against the blocks run
    in order, and the errors for stages and batches that do not divide."""
    from fmc_uia_tpu_torch.models.encoders.swin import SwinEncoder
    from fmc_uia_tpu_torch.parallel import make_mesh, pipeline_apply
    from fmc_uia_tpu_torch.parallel import pipeline_swin_stage

    mesh = make_mesh(axes=("pipe",), shape=(world,))
    out = {}
    stacked = {k: torch.from_numpy(arrays[k]).requires_grad_(True)
               for k in ("w", "b")}
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    y = pipeline_apply(pipe_stage_fn, stacked, x, mesh)
    (y * torch.from_numpy(arrays["cot"])).sum().backward()
    seq = x.detach()
    for s in range(world):
        seq = pipe_stage_fn({k: v.detach()[s] for k, v in stacked.items()},
                            seq)
    out["apply"] = {"y": _np(y), "seq": _np(seq), "dx": _np(x.grad),
                    "dw": _np(stacked["w"].grad),
                    "db": _np(stacked["b"].grad)}

    enc = SwinEncoder(fused_block=False, fused_mlp=False, **SWIN_KW)
    load_port_params(enc, swin["params"])
    xs = torch.from_numpy(swin["x"]).requires_grad_(True)
    ys = pipeline_swin_stage(enc, 2, xs, mesh, microbatches=swin["M"])
    (ys * torch.from_numpy(swin["cot"])).sum().backward()
    with torch.no_grad():
        ref = torch.from_numpy(swin["x"])
        for b in range(4):
            ref = getattr(enc, f"stage2_block{b}")(ref, False)
    grads = {n: _np(p.grad) for n, p in enc.named_parameters()
             if p.grad is not None}
    out["swin"] = {"y": _np(ys), "seq": _np(ref), "dx": _np(xs.grad),
                   "grads": grads}
    errors = []
    for kw, M in ((dict(SWIN_KW, depths=(2, 2, 6, 2)), 2), (SWIN_KW, 3)):
        e = SwinEncoder(fused_block=False, fused_mlp=False, **kw)
        try:
            pipeline_swin_stage(e, 2, torch.from_numpy(swin["x"]), mesh,
                                microbatches=M)
            errors.append(None)
        except ValueError as err:
            errors.append(str(err))
    out["errors"] = errors
    return out


def _batch_record(b):
    return {k: (_np(v) if torch.is_tensor(v) else np.asarray(v))
            for k, v in b.items() if k in ("image", "label", "valid")} | {
        "task_id": b["task_id"], "rows": b.get("rows")}


def data_job(rank, world, cfg_dict):
    """The train (one epoch) and val engines' batches on a {data: world}
    mesh, without and with the sharded device cache; the dataset rows
    each rank decoded, and the cache's bank rows."""
    from fmc_uia_tpu_torch.config import Config
    from fmc_uia_tpu_torch.data.dataset import MultiTaskDataset
    from fmc_uia_tpu_torch.data.pipeline import build_data_engines
    from fmc_uia_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes=("data",), shape=(world,))
    out = {}
    get = MultiTaskDataset.__getitem__
    for cached in (False, True):
        d = copy.deepcopy(cfg_dict)
        d["data"]["device_cache"] = cached
        decoded = []

        def counting(self, i):
            decoded.append(int(i))
            return get(self, i)

        MultiTaskDataset.__getitem__ = counting
        try:
            train, val, _ = build_data_engines(Config(config_dict=d),
                                               mesh=mesh, device="cpu")
            rec = {"train": [_batch_record(b) for b in train],
                   "val": [_batch_record(b) for b in val],
                   "decoded": sorted(decoded)}
        finally:
            MultiTaskDataset.__getitem__ = get
        if cached:
            c = train.device_cache
            rec["bank_rows"] = {t: int(v.shape[0])
                                for t, v in c._images.items()}
        train.close()
        val.close()
        out["cache" if cached else "host"] = rec
    return out


def fit_job(rank, world, cfg_dict, resume=False, sigterm_after=None):
    """``fit`` on the CPU over every rank (``parallel.mesh`` in the
    config): its result dict. ``sigterm_after``: rank 1 alone sees a
    SIGTERM after that many batch boundaries (its guard's flag), as one
    preempted rank would."""
    from fmc_uia_tpu_torch import fit as fit_mod
    from fmc_uia_tpu_torch.config import Config

    guard = fit_mod._PreemptionGuard
    if sigterm_after is not None:
        class OneRankGuard(guard):
            reads = 0

            @property
            def requested(self):
                OneRankGuard.reads += 1
                return rank == 1 and OneRankGuard.reads > sigterm_after

            @requested.setter
            def requested(self, value):
                pass

        fit_mod._PreemptionGuard = OneRankGuard
    try:
        res = fit_mod.fit(config=Config(config_dict=copy.deepcopy(
            cfg_dict)), device="cpu", resume=resume)
    finally:
        fit_mod._PreemptionGuard = guard
    return {k: res.get(k) for k in ("best_score", "best_epoch",
                                    "experiment_dir", "preempted")}


def isolation_job(rank, world):
    """Every module of the parallel package imported in a spawned child:
    the forbidden modules then loaded (none, the caller asserts)."""
    import importlib
    import pkgutil

    import fmc_uia_tpu_torch.parallel as par

    names = [m.name for m in pkgutil.walk_packages(par.__path__,
                                                   par.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    return {"modules": names, "forbidden": forbidden_modules()}
