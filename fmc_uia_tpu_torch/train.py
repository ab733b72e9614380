"""Training step, optimizer and schedule (port of ``fmc_uia_tpu/train.py``).

One train step per task type, as in the JAX package:

    photometric augmentation (+ flips) -> train-mode forward (drop path,
    dropout) -> CenterNet targets -> loss (+ the MoE balance loss) ->
    backward (the fused Swin branches and the ViT global attention
    through their backward kernels) -> clip model grads -> grouped-LR
    AdamW / Adam / SGD

A deep-supervision seg head adds its auxiliary losses (each aux map
resized bilinearly to the label, weighted by ``aux_loss_weights``); a
grid det head is scored at the GT box centre's cell.

Optimizer parity with the optax chains of ``build_optimizer``: AdamW is
``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)`` -> ``add_decayed_weights(wd)``
-> ``scale(group multiplier)``; Adam the same without the decay (whatever
``weight_decay`` says); SGD ``trace(momentum)`` -> ``add_decayed_weights``
-> ``scale`` (the decay added after the momentum trace, unlike
``torch.optim.SGD``); then ``params += -lr * update``, with one
multiplier per label (encoder x0.1, heads x1.0, adaptive log-vars
adaptive_lr / lr, frozen untouched: ``freeze_encoder``, ``freeze_dino``'s
backbone, DINOv3's ``rope_periods``). Every parameter is updated every step,
its grad zero when the step's task type does not reach it (``jax.grad``
returns zeros there too), so momentum and weight decay act as in JAX.
Clipping applies to the model's grads only, by ``max_norm / (norm +
1e-6)``; the adaptive log-vars' grads are zeroed during the adaptive
warmup epochs.

``training.accumulation_steps`` = n > 1: each micro-step's grads (the
adaptive log-vars' gated first) are divided by n and added to an f32
accumulator, whatever the batch's task type; every n-th micro-step (the
host's count, not saved in checkpoints, as in JAX) clips the accumulated
model grads, updates and zeroes the accumulator. The generator advances on
every micro-step, the optimizer's count on updates only.
``train_burst(batch, n)`` runs n steps on one batch with no host sync.

``Trainer(mesh=DeviceMesh)`` (``parallel/``): parameters are broadcast
from rank 0 and each rank takes its rows of the global batch, drawing the
global batch's per-row randomness from the shared generator and keeping
its rows; the losses' batch reductions are global (``parallel/comm.py``),
so every rank holds the single process's loss, and the grads are summed
over the batch axes (one flat buffer per dtype; the adaptive log-vars'
grads, already whole on every rank, are not). The clip uses the global
norm. With a ``model`` axis and ``parallel.tensor_parallel`` (default
on) the large kernels are sharded (``parallel/sharding.py``,
``parallel.tp_min_dim``, default 256); with ``parallel.zero_optimizer``
and a data axis above 1 each rank keeps the optimizer state of its slice
of the large leaves (ZeRO-1: reduce-scatter, update, all-gather). The
mesh is installed around the Trainer's own steps only.

AOT warm-compile has no counterpart and raises.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.utils import parametrize

from fmc_uia_tpu_torch import losses as losses_lib
from fmc_uia_tpu_torch.device import resolve_device
from fmc_uia_tpu_torch.ops.centernet import make_centernet_targets
from fmc_uia_tpu_torch.models.layers import resize_to
from fmc_uia_tpu_torch.ops.image import input_prep_fns, random_flips
from fmc_uia_tpu_torch.parallel import comm
from fmc_uia_tpu_torch.parallel.activation import activation_mesh_scope
from fmc_uia_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    axis_group,
    axis_size,
    check_mesh,
    replicate,
    shard_batch,
)
from fmc_uia_tpu_torch.parallel.sharding import (
    apply_param_sharding,
    make_param_specs,
    plain_name,
)
from fmc_uia_tpu_torch.parallel.zero import zero_dims
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    REGRESSION,
    SEGMENTATION,
    TaskRegistry,
)
from fmc_uia_tpu_torch.utils.profiling import span


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def label_params(model: nn.Module, freeze_encoder: bool = False,
                 freeze_backbone: bool = False) -> Dict[str, str]:
    """Parameter name -> ``encoder`` / ``head`` / ``frozen``, by path as
    the JAX package labels its tree: ``rope_periods`` (a DINOv3 buffer) is
    always frozen; ``freeze_backbone`` (``model.encoder.freeze_dino``)
    freezes ``encoder.backbone.*`` and leaves the adapter training. A
    frozen parameter gets no update and no weight decay; its grad is still
    computed and counts in the clip's global norm, as in JAX."""

    def label(name: str) -> str:
        if name.rsplit(".", 1)[-1] == "rope_periods":
            return "frozen"
        if not name.startswith("encoder."):
            return "head"
        if freeze_encoder or (freeze_backbone
                              and name.startswith("encoder.backbone.")):
            return "frozen"
        return "encoder"

    return {plain_name(name): label(plain_name(name))
            for name, _ in model.named_parameters()}


class GroupedOptimizer:
    """Optax's AdamW, Adam or SGD (``kind``) over groups of f32
    parameters, one LR multiplier per group (see the module docstring).
    State is f32, zero-initialised: ``mu`` and ``nu`` (Adam kinds) or
    ``trace`` (SGD); the step count is shared."""

    def __init__(self, groups: List[Tuple[float, List[nn.Parameter]]],
                 weight_decay: float, kind: str = "AdamW", b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 momentum: float = 0.9):
        if kind not in ("AdamW", "Adam", "SGD"):
            raise ValueError(f"Unknown optimizer type: {kind}")
        self.groups = [(float(m), list(ps)) for m, ps in groups if ps]
        self.kind = kind
        self.wd = 0.0 if kind == "Adam" else weight_decay
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum
        self.count = 0

        def zeros():
            return [[torch.zeros_like(p) for p in ps] for _, ps in
                    self.groups]

        self.buffers = ({"trace": zeros()} if kind == "SGD"
                        else {"mu": zeros(), "nu": zeros()})
        # per group, per leaf: None, or the ZeRO slice (dim, start, length,
        # whole length) this optimizer holds of the leaf (``shard``)
        self.slices = [[None] * len(ps) for _, ps in self.groups]

    def shard(self, slice_of) -> None:
        """Hold only a slice of some leaves: ``slice_of(param)`` gives
        (dim, start, length) or None. The group entries become views of
        those slices (an update writes into the parameter), the state
        buffers slice-shaped; ``step`` then needs the slices' grads."""
        for gi, (mult, ps) in enumerate(self.groups):
            for li, p in enumerate(ps):
                s = slice_of(p)
                if s is None:
                    continue
                d, start, n = s
                self.slices[gi][li] = (d, start, n, p.shape[d])
                ps[li] = p.detach().narrow(d, start, n)
                for bufs in self.buffers.values():
                    bufs[gi][li] = bufs[gi][li].narrow(d, start,
                                                       n).clone()

    def state_dict(self) -> Dict:
        return {"kind": self.kind, "count": int(self.count),
                **self.buffers}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if state.get("kind", "AdamW") != self.kind:
            raise ValueError(f"optimizer {state.get('kind')!r} in the "
                             f"checkpoint, {self.kind!r} configured")
        for key, dst in self.buffers.items():
            src = state[key]
            if [len(g) for g in dst] != [len(g) for g in src]:
                raise ValueError("optimizer state does not match the "
                                 "model's parameter groups")
            for d, s in zip(dst, src):
                torch._foreach_copy_(d, s)
        self.count = int(state["count"])

    def _adam(self, i, g):
        mu, nu = self.buffers["mu"][i], self.buffers["nu"][i]
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(torch._foreach_div(mu, bc1), den)

    def _sgd(self, i, g):
        trace = self.buffers["trace"][i]  # g + momentum * trace
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, g)
        return [t.clone() for t in trace]

    @torch.no_grad()
    def step(self, lr: float, grads=None) -> None:
        """One update; ``grads`` (per group, per leaf) defaults to the
        leaves' ``.grad``."""
        self.count += 1
        for i, (mult, ps) in enumerate(self.groups):
            g = [p.grad for p in ps] if grads is None else grads[i]
            upd = self._sgd(i, g) if self.kind == "SGD" else self._adam(i, g)
            if self.wd:
                torch._foreach_add_(upd, ps, alpha=self.wd)
            torch._foreach_mul_(upd, mult)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(ps, upd)


def build_optimizer(config, model: nn.Module,
                    adaptive: Optional[nn.ParameterDict] = None,
                    named=None) -> GroupedOptimizer:
    """The grouped optimizer of ``training.optimizer`` (``type`` AdamW,
    Adam or SGD with ``momentum``); ``named`` ((name, param) pairs,
    default the model's) fixes the leaves' order."""
    opt_cfg = config.get("training.optimizer", {}) or {}
    opt_type = str(opt_cfg.get("type", "AdamW"))
    base_lr = float(config.learning_rate)
    grouped = bool(opt_cfg.get("use_grouped_lr", True))
    enc_mult = (float(opt_cfg.get("encoder_lr_multiplier", 0.1))
                if grouped else 1.0)
    head_mult = (float(opt_cfg.get("head_lr_multiplier", 1.0))
                 if grouped else 1.0)
    labels = label_params(
        model, bool(config.get("model.encoder.freeze_encoder", False)),
        bool(config.get("model.encoder.freeze_dino", False)))
    by_label = {"encoder": [], "head": []}
    for name, p in (named or model.named_parameters()):
        label = labels[plain_name(name)]
        if label != "frozen":
            by_label[label].append(p)
    groups = [(enc_mult, by_label["encoder"]), (head_mult, by_label["head"])]
    if adaptive is not None:
        adaptive_lr = float(config.get("training.adaptive_loss.learning_rate",
                                       base_lr))
        groups.append((adaptive_lr / base_lr, list(adaptive.values())))
    return GroupedOptimizer(groups, float(config.weight_decay),
                            kind=opt_type,
                            momentum=float(opt_cfg.get("momentum", 0.9)))


class LRScheduler:
    """Epoch-granularity schedule: a multiplicative scale on the base LR
    (``CosineAnnealingLR``, ``StepLR``, ``ReduceLROnPlateau`` or None).
    ``step(score)`` ends an epoch; plateau mode reads the score."""

    def __init__(self, config):
        sch = config.get("training.scheduler", {}) or {}
        self.kind = sch.get("type", "CosineAnnealingLR")
        self.base_lr = float(config.learning_rate)
        self.epoch = 0
        self.scale = 1.0
        if self.kind == "CosineAnnealingLR":
            self.t_max = int(sch.get("T_max", config.num_epochs))
            self.eta_min = float(sch.get("eta_min", 1e-6))
        elif self.kind == "StepLR":
            self.step_size = int(sch.get("step_size", 20))
            self.gamma = float(sch.get("gamma", 0.1))
        elif self.kind == "ReduceLROnPlateau":
            self.mode = sch.get("mode", "max")
            self.factor = float(sch.get("factor", 0.5))
            self.patience = int(sch.get("patience", 5))
            self._best = -np.inf if self.mode == "max" else np.inf
            self._bad = 0
        elif self.kind in ("None", None):
            self.kind = None
        else:
            raise ValueError(f"Unknown scheduler type: {self.kind}")

    def current_scale(self) -> float:
        return self.scale

    def state_dict(self) -> Dict:
        """The schedule's state as Python numbers (a resumed run loads it
        instead of replaying the epochs, so plateau mode resumes too)."""
        return {k: float(v) if isinstance(v, float) else v
                for k, v in vars(self).items()}

    def load_state_dict(self, state: Dict) -> None:
        if state.get("kind") != self.kind:
            raise ValueError(f"scheduler {state.get('kind')!r} in the "
                             f"checkpoint, {self.kind!r} configured")
        vars(self).update(state)

    def current_lr(self) -> float:
        return self.base_lr * self.scale

    def step(self, score: Optional[float] = None) -> None:
        self.epoch += 1
        if self.kind == "CosineAnnealingLR":
            e = min(self.epoch, self.t_max)
            lr = self.eta_min + (self.base_lr - self.eta_min) * (
                1 + np.cos(np.pi * e / self.t_max)) / 2
            self.scale = lr / self.base_lr
        elif self.kind == "StepLR":
            self.scale = self.gamma ** (self.epoch // self.step_size)
        elif self.kind == "ReduceLROnPlateau" and score is not None:
            improved = (score > self._best) if self.mode == "max" else (
                score < self._best)
            if improved:
                self._best = score
                self._bad = 0
            else:
                self._bad += 1
                if self._bad > self.patience:
                    self.scale *= self.factor
                    self._bad = 0


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
class Trainer:
    """The per-type train steps of one model, with its optimizer state,
    schedule and random generator (on the model's device).

    ``registry`` defaults to the model's. ``seed`` (default
    ``experiment.seed``) seeds the generator of augmentation, dropout and
    drop path. ``train_batch(batch, epoch)`` takes a batch dict (``image``
    uint8 [B, H, W, 3], ``label``, ``task_id``, ``task_index``,
    ``task_type``), numpy or tensors, and returns ``total_loss``,
    ``raw_loss``, ``task_weight`` and ``grad_norm`` as device tensors:
    nothing in a step waits for the device. With MoE blocks it also
    returns ``moe_importance`` / ``moe_load`` (per expert, the mean over
    blocks) and, when ``model.moe.balance_loss_weight`` > 0, ``moe_aux``
    (the blocks' balance losses summed, added to the total times that
    weight), as the JAX step logs them. Under gradient accumulation it
    returns ``total_loss``, ``raw_loss`` and ``task_weight`` only, as the
    JAX accumulation step does. ``mesh``: a DeviceMesh (the module
    docstring), each rank's steps given its rows of the global batch or
    the whole batch to slice; ``model_state`` / ``optimizer_state`` give
    the single process's format."""

    def __init__(self, config, model: nn.Module,
                 registry: Optional[TaskRegistry] = None, device="cuda",
                 seed: Optional[int] = None, mesh=None):
        self.mesh = None if mesh is None else check_mesh(mesh)
        dev = resolve_device(device)
        p0 = next(model.parameters())
        if p0.device.type != dev.type:
            raise ValueError(f"model is on {p0.device}, Trainer on {dev}: "
                             "build the model there")
        self.device = p0.device  # with its index: cuda -> cuda:0
        registry = registry or model.registry
        self.config = config
        self.model = model
        self.registry = registry
        check_det_head_loss(config, registry)
        loss_fns, loss_weights, adaptive_init = losses_lib.build_all_losses(
            config, registry)
        self.loss_fns = loss_fns
        self.aux_weights = [float(w) for w in config.get(
            "model.heads.segmentation.aux_loss_weights", [0.5, 0.3, 0.2])]
        self.adaptive = None
        if adaptive_init is not None:
            self.adaptive = nn.ParameterDict({
                t: nn.Parameter(torch.tensor(v, device=p0.device))
                for t, v in adaptive_init.items()})
        self.adaptive_warmup = int(
            config.get("training.adaptive_loss.warmup_epochs", 0))
        self.fixed_weights = {}
        for t in registry.present_types():
            key = "regression" if t == REGRESSION else t
            w = (loss_weights or {}).get(key, (loss_weights or {}).get(t))
            self.fixed_weights[t] = torch.tensor(
                1.0 if w is None else float(w), device=p0.device)
        self.grad_clip = float(config.get("training.gradient_clip", 0) or 0)
        self.moe_balance_w = float(config.get(
            "model.moe.balance_loss_weight", 0.0) or 0.0)
        # (single-process name, parameter) in the single process's order:
        # the optimizer's, the accumulator's and the checkpoints' order
        self._named = list(model.named_parameters())
        self._setup_mesh(config)
        self.optimizer = build_optimizer(config, model, self.adaptive,
                                         named=self._named)
        # the optimizer's leaves by name, per group (the checkpoints' and
        # ZeRO's key)
        index = {id(p): n for n, p in self._named}
        if self.adaptive is not None:
            index.update({id(p): f"adaptive.{t}"
                          for t, p in self.adaptive.items()})
        self._opt_names = [[index[id(p)] for p in ps]
                           for _, ps in self.optimizer.groups]
        if self.zero_dims:
            r, k = comm.group_rank(self.zero_group), axis_size(
                self.mesh, "data")

            def slice_of(p):
                d = self.zero_dims.get(index[id(p)])
                if d is None:
                    return None
                n = p.shape[d] // k
                return d, r * n, n
            self.optimizer.shard(slice_of)
        self.scheduler = LRScheduler(config)
        self.generator = torch.Generator(device=p0.device)
        self.generator.manual_seed(int(config.seed if seed is None
                                       else seed))
        self.host_step = 0  # train steps taken (the profiler's step index)
        self.train_prep, _ = input_prep_fns(config, model.dtype)
        aug = config.get("data.augmentation.train", {}) or {}
        self.flip_h = float(aug.get("horizontal_flip", 0.0) or 0.0)
        self.flip_v = float(aug.get("vertical_flip", 0.0) or 0.0)
        self.nc_table = torch.as_tensor(registry.num_classes_table,
                                        dtype=torch.long, device=p0.device)
        self._task_index: Dict[str, torch.Tensor] = {}
        # every parameter carries a grad buffer, zeroed each step: a
        # parameter the step's type does not reach gets zero, as jax.grad
        # gives it
        self._params = [p for _, p in self._named]
        self._adaptive_params = ([] if self.adaptive is None
                                 else list(self.adaptive.values()))
        for p in self._params + self._adaptive_params:
            p.grad = torch.zeros_like(p)
        self.accum_steps = int(config.get("training.accumulation_steps", 1)
                               or 1)
        self._micro_step = 0  # host count, not saved (as in JAX)
        self.grad_accum = (None if self.accum_steps <= 1 else
                           [torch.zeros_like(p, dtype=torch.float32)
                            for p in self._params + self._adaptive_params])

    # -- batches -------------------------------------------------------------
    def put_batch(self, batch: Dict) -> Dict:
        """Start the host->device copies of a batch (pinned host memory,
        non-blocking); integer labels (uint8 seg masks on the wire) are
        widened to int64 on the device. Under a mesh only this rank's rows
        are copied (``shard_batch``)."""
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        out = dict(batch)
        for key in ("image", "label"):
            v = batch[key]
            if not torch.is_tensor(v):
                v = torch.from_numpy(np.ascontiguousarray(v))
            if v.device != self.device:
                if self.device.type == "cuda":
                    v = v.pin_memory().to(self.device, non_blocking=True)
                else:
                    v = v.to(self.device)
            out[key] = v
        label = out["label"]
        if not label.is_floating_point() and label.dtype != torch.long:
            out["label"] = label.long()
        return out

    def _index(self, batch) -> torch.Tensor:
        tid = batch["task_id"]
        t = self._task_index.get(tid)
        if t is None:
            t = torch.tensor(int(batch["task_index"]), dtype=torch.long,
                             device=self.device)
            self._task_index[tid] = t
        return t

    # -- the step ------------------------------------------------------------
    def _raw_loss(self, outputs, labels, task_type: str,
                  task_index: torch.Tensor) -> torch.Tensor:
        """The task type's loss of the model's outputs (f32 scalar)."""
        ncls = self.nc_table.index_select(0, task_index.reshape(1))[0]
        fn = self.loss_fns[task_type]
        if task_type == SEGMENTATION and isinstance(outputs, tuple):
            # deep supervision: main + sum_i w_i loss(aux_i at label size)
            main, auxs = outputs
            loss = fn(main, labels, num_valid_classes=ncls)
            th, tw = labels.shape[1:3]
            for w, aux in zip(self.aux_weights, auxs):
                loss = loss + w * fn(resize_to(aux.float(), th, tw), labels,
                                     num_valid_classes=ncls)
            return loss
        if task_type in (SEGMENTATION, CLASSIFICATION):
            return fn(outputs, labels, num_valid_classes=ncls)
        if task_type == DETECTION and isinstance(outputs, dict):
            H, W = outputs["heatmap"].shape[1:3]
            targets = make_centernet_targets(labels, H, W)
            return fn({k: v.float() for k, v in outputs.items()}, targets)
        if task_type == DETECTION:
            # grid head: the prediction at the GT box centre's cell,
            # targets [box (zeros when the box is invalid), valid]
            B, H, W, _ = outputs.shape
            cx = (labels[:, 0] + labels[:, 2]) * 0.5
            cy = (labels[:, 1] + labels[:, 3]) * 0.5
            gw = torch.clamp(torch.floor(cx * W).long(), 0, W - 1)
            gh = torch.clamp(torch.floor(cy * H).long(), 0, H - 1)
            picked = outputs[torch.arange(B, device=outputs.device), gh,
                             gw].float()
            valid = (labels >= 0).all(dim=1)
            clean = torch.where(valid[:, None], labels, 0.0)
            return fn(picked, torch.cat([clean, valid.float()[:, None]], 1))
        return fn(outputs.float(), labels, num_valid_cols=2 * ncls)

    def _backward(self, batch: Dict) -> Dict:
        """Augment, forward in train mode, loss and backward: the step's
        grads in ``.grad`` (zeroed first), unclipped; returns the logs.
        Spans ``train.prep``, ``train.forward`` and ``train.backward``."""
        with contextlib.ExitStack() as stack:
            with span("train.prep"):
                b = self.put_batch(batch)
                torch._foreach_zero_([p.grad for p in self._params
                                      + self._adaptive_params])
                stack.enter_context(self._scope(b))
                images, labels = self._prep(b)
            with span("train.forward"):
                total, logs = self._forward_loss(b, images, labels)
            with span("train.backward"):
                total.backward()
        return logs

    def _scope(self, b: Dict):
        """Under a mesh: the batch scope (global loss sums, per-row
        draws), the mesh installed, the sharded kernels gathered once."""
        if self.mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(comm.batch_scope(self.dp_group, b["rows"]))
        stack.enter_context(activation_mesh_scope(self.mesh))
        if self.tp_dims:
            stack.enter_context(parametrize.cached())
        return stack

    def _prep(self, b: Dict):
        """The flips and the photometric prep: (model input, labels)."""
        images, labels = b["image"], b["label"]
        if self.flip_h > 0 or self.flip_v > 0:
            images, labels = random_flips(images, labels, b["task_type"],
                                          self.flip_h, self.flip_v,
                                          generator=self.generator)
        return self.train_prep(images, generator=self.generator), labels

    def _forward_loss(self, b: Dict, x: torch.Tensor, labels):
        """The train-mode forward and the loss: (total, the logs)."""
        task_type = b["task_type"]
        task_index = self._index(b)
        outputs, inter = self.model(x, task_type, task_index, train=True,
                                    generator=self.generator,
                                    return_intermediates=True)
        raw = self._raw_loss(outputs, labels, task_type, task_index)
        if self.adaptive is not None:
            total, _, weights = losses_lib.adaptive_weighted_loss(
                dict(self.adaptive), {task_type: raw})
            weight = weights[task_type]
        else:
            weight = self.fixed_weights[task_type]
            total = raw * weight
        moe_logs = {}
        if self.moe_balance_w > 0 and inter["moe_aux"]:
            moe_aux = torch.stack(inter["moe_aux"]).float().sum()
            total = total + self.moe_balance_w * moe_aux
            moe_logs["moe_aux"] = moe_aux.detach()
        if inter["moe_importance"]:
            for key in ("moe_importance", "moe_load"):
                moe_logs[key] = torch.stack(inter[key]).float().mean(
                    0).detach()
        return total, {"total_loss": total.detach(), "raw_loss": raw.detach(),
                       "task_weight": weight.detach(), **moe_logs}

    def _gate_adaptive(self, epoch: int) -> None:
        """Zero the adaptive log-vars' grads in the warmup epochs."""
        if self.adaptive is not None and epoch < self.adaptive_warmup:
            torch._foreach_zero_([p.grad for p in self._adaptive_params])

    def compute_grads(self, batch: Dict, epoch: int = 0) -> Dict:
        """Augment, forward in train mode, loss, backward, the grads'
        reduction over the mesh and the clip: leaves the step's grads in
        ``.grad`` (under ZeRO, the sharded leaves' reduced slices in
        ``zero_grads``) and returns the logs."""
        logs = self._backward(batch)
        self._clip(logs, epoch)
        return logs

    def _clip(self, logs: Dict, epoch: int) -> None:
        """The grads' reduction and clip (the norm into ``logs``), then
        the adaptive gate."""
        norm = self._reduce_and_clip()
        if norm is not None:
            logs["grad_norm"] = norm
        self._gate_adaptive(epoch)

    def _accumulate(self, batch: Dict, epoch: int) -> Dict:
        """One micro-step of gradient accumulation (module docstring);
        under a mesh the summed micro-grads are reduced once, at the
        update."""
        logs = self._backward(batch)
        with span("train.update"):
            self._gate_adaptive(epoch)
            grads = [p.grad for p in self._params + self._adaptive_params]
            torch._foreach_add_(self.grad_accum, torch._foreach_div(
                grads, float(self.accum_steps)))
            self._micro_step += 1
            if self._micro_step % self.accum_steps == 0:
                torch._foreach_copy_(grads, self.grad_accum)
                self._reduce_and_clip()
                self._optimizer_step()
                torch._foreach_zero_(self.grad_accum)
        return {k: logs[k] for k in ("total_loss", "raw_loss",
                                     "task_weight")}

    def train_batch(self, batch: Dict, epoch: int) -> Dict:
        """One step (or micro-step): span ``train.step`` over the phases'
        spans (``utils/profiling.py``)."""
        with span("train.step", step=self.host_step):
            if self.accum_steps > 1:
                logs = self._accumulate(batch, epoch)
            else:
                logs = self._backward(batch)
                with span("train.update"):
                    self._clip(logs, epoch)
                    self._optimizer_step()
        self.host_step += 1
        return logs

    # -- the mesh ------------------------------------------------------------
    def _setup_mesh(self, config) -> None:
        """Broadcast the parameters from rank 0, shard the tensor-parallel
        kernels and plan ZeRO (module docstring)."""
        self.dp_group = self.tp_group = self.zero_group = None
        self.dcn_group = None
        self.tp_dims: Dict[str, int] = {}
        self.zero_dims: Dict[str, int] = {}
        self.zero_grads = None
        self._world_group = None
        if self.mesh is None:
            return
        mesh = self.mesh
        replicate(self.model)
        if self.adaptive is not None:
            replicate(list(self.adaptive.values()))
        self._world_group = dist.group.WORLD
        self.dp_group = axis_group(mesh, BATCH_AXES)
        whole = {n: tuple(p.shape) for n, p in self._named}
        if (axis_size(mesh, "model") > 1
                and bool(config.get("parallel.tensor_parallel", True))):
            specs = make_param_specs(self.model, min_shard_dim=int(
                config.get("parallel.tp_min_dim", 256)))
            self.tp_dims = apply_param_sharding(self.model, mesh, specs)
            self.tp_group = axis_group(mesh, "model")
            params = {plain_name(n): p for n, p in
                      self.model.named_parameters()}
            self._named = [(n, params[n]) for n, _ in self._named]
        if (bool(config.get("parallel.zero_optimizer", False))
                and axis_size(mesh, "data") > 1):
            self.zero_dims = zero_dims(whole, mesh)
            self.zero_group = axis_group(mesh, "data")
            if axis_size(mesh, "dcn_data") > 1:
                self.dcn_group = axis_group(mesh, "dcn_data")

    def _reduce_and_clip(self) -> Optional[torch.Tensor]:
        """Sum the model grads over the batch axes (ZeRO leaves:
        reduce-scattered into ``zero_grads``), then clip by the global
        norm; returns the norm (None without a clip)."""
        if self.mesh is None:
            if self.grad_clip > 0:
                return torch.nn.utils.clip_grad_norm_(self._params,
                                                      self.grad_clip)
            return None
        zero = [(n, p) for n, p in self._named if n in self.zero_dims]
        comm.all_reduce_flat([p.grad for n, p in self._named
                              if n not in self.zero_dims], self.dp_group)
        self.zero_grads = {}
        for n, p in zero:
            g = comm.reduce_scatter_dim(p.grad, self.zero_dims[n],
                                        self.zero_group)
            if self.dcn_group is not None:
                comm.all_reduce_(g, self.dcn_group)
            self.zero_grads[n] = g
        if self.grad_clip <= 0:
            return None
        W = comm.group_size(self._world_group)
        if W == 1:  # one rank holds every piece: the plain clip
            return torch.nn.utils.clip_grad_norm_(self._params,
                                                  self.grad_clip)
        # norm^2: each piece counted once over the mesh (a leaf whole on
        # every rank divided by the world size, a shard by the ranks that
        # hold it)
        tp = comm.group_size(self.tp_group)
        dz = axis_size(self.mesh, "data")
        grads, reps = [], []
        for n, p in self._named:
            g = self.zero_grads.get(n, p.grad)
            grads.append(g)
            reps.append(W // (tp if n in self.tp_dims else 1)
                        // (dz if n in self.zero_dims else 1))
        sq = torch.stack([(g.float() * g.float()).sum() / r
                          for g, r in zip(grads, reps)]).sum()
        norm = comm.all_reduce_(sq, self._world_group).sqrt()
        coef = torch.clamp(self.grad_clip / (norm + 1e-6), max=1.0)
        torch._foreach_mul_(grads, coef)
        return norm

    @torch.no_grad()
    def _optimizer_step(self) -> None:
        """The update; under ZeRO on the slices, then the sharded leaves
        all-gathered over the data axis."""
        lr = self.scheduler.current_lr()
        if not self.zero_dims:
            self.optimizer.step(lr)
            return
        grads = [[p.grad if s is None else self.zero_grads[n]
                  for p, s, n in zip(ps, sl, names)]
                 for (_, ps), sl, names in zip(self.optimizer.groups,
                                               self.optimizer.slices,
                                               self._opt_names)]
        self.optimizer.step(lr, grads=grads)
        for n, p in self._named:
            d = self.zero_dims.get(n)
            if d is not None:
                k = p.shape[d] // axis_size(self.mesh, "data")
                r = comm.group_rank(self.zero_group)
                p.data.copy_(comm.all_gather_dim(
                    p.data.narrow(d, r * k, k), d, self.zero_group))


    def adaptive_snapshot(self) -> Optional[Dict[str, Dict[str, float]]]:
        """The adaptive loss weights 0.5 e^{-lv} and sigmas e^{lv/2} (lv
        bounded) per task type, read from the device; None when off."""
        if self.adaptive is None:
            return None
        with torch.no_grad():
            lv = {t: losses_lib.stable_log_var(v)
                  for t, v in self.adaptive.items()}
            return {"weights": {t: float(0.5 * torch.exp(-v))
                                for t, v in lv.items()},
                    "sigmas": {t: float(torch.exp(0.5 * v))
                               for t, v in lv.items()}}

    def train_burst(self, batch: Dict, n_steps: int, epoch: int = 0
                    ) -> Dict[str, torch.Tensor]:
        """``n_steps`` optimizer steps on the SAME batch of one task type
        (the generator advancing every step, as in ``train_batch``), the
        batch put on the device once; nothing waits for the device.
        Returns ``{"total_loss": the last step's, "losses": [n_steps]}``
        as device tensors. Raises under gradient accumulation, as JAX."""
        if self.accum_steps > 1:
            raise NotImplementedError(
                "burst mode with accumulation_steps > 1")
        b = self.put_batch(batch)
        losses = []
        for _ in range(int(n_steps)):
            losses.append(self.compute_grads(b, epoch)["total_loss"])
            self._optimizer_step()
        losses = torch.stack(losses)
        return {"total_loss": losses[-1], "losses": losses}

    # -- state in the single process's format (checkpoints) ------------------
    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.tp_dims.get(name)
        return t if d is None else comm.all_gather_dim(t, d, self.tp_group)

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.tp_dims.get(name)
        if d is None:
            return t
        k = t.shape[d] // comm.group_size(self.tp_group)
        return t.narrow(d, comm.group_rank(self.tp_group) * k, k)

    def whole_grads(self) -> Dict[str, torch.Tensor]:
        """The model's step grads by single-process name, whole (after
        ``compute_grads``: reduced and clipped; every rank calls it)."""
        out = {}
        for n, p in self._named:
            g = p.grad
            if n in self.zero_dims:
                g = comm.all_gather_dim(self.zero_grads[n],
                                        self.zero_dims[n], self.zero_group)
            out[n] = self._whole(n, g)
        return out

    def model_state(self) -> Dict[str, torch.Tensor]:
        """The model's state dict as one process holds it (tensor
        parallel shards gathered; a collective under a mesh: every rank
        calls it)."""
        return {plain_name(k): self._whole(plain_name(k), v)
                for k, v in self.model.state_dict().items()}

    @torch.no_grad()
    def load_model_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a single-process state dict (this rank's shards cut)."""
        if not self.tp_dims:
            self.model.load_state_dict(state)
            return
        self.model.load_state_dict({
            k: self._local(plain_name(k), state[plain_name(k)])
            for k in self.model.state_dict()})

    def optimizer_state(self) -> Dict:
        """The optimizer's state as one process holds it (ZeRO slices and
        tensor-parallel shards gathered; every rank calls it)."""
        state = self.optimizer.state_dict()
        for key in self.optimizer.buffers:
            state[key] = [[self._whole(n, t if s is None else
                                       comm.all_gather_dim(t, s[0],
                                                           self.zero_group))
                           for t, s, n in zip(ts, sl, names)]
                          for ts, sl, names in zip(state[key],
                                                   self.optimizer.slices,
                                                   self._opt_names)]
        return state

    @torch.no_grad()
    def load_optimizer_state(self, state: Dict) -> None:
        state = dict(state)
        for key in self.optimizer.buffers:
            if key not in state:
                continue
            state[key] = [[(lambda t: t if s is None else t.narrow(*s[:3]))(
                self._local(n, t)) for t, s, n in zip(ts, sl, names)]
                for ts, sl, names in zip(state[key], self.optimizer.slices,
                                         self._opt_names)]
        self.optimizer.load_state_dict(state)

    def accum_state(self) -> Optional[List[torch.Tensor]]:
        if self.grad_accum is None:
            return None
        names = [n for n, _ in self._named] + [
            f"adaptive.{t}" for t in (self.adaptive or {})]
        return [self._whole(n, t) for n, t in zip(names, self.grad_accum)]

    @torch.no_grad()
    def load_accum_state(self, acc: List[torch.Tensor]) -> None:
        names = [n for n, _ in self._named] + [
            f"adaptive.{t}" for t in (self.adaptive or {})]
        torch._foreach_copy_(self.grad_accum, [
            self._local(n, t) for n, t in zip(names, acc)])

    def warm_compile(self, example_batches, parallel: bool = True,
                     aot_dir=None):
        raise NotImplementedError(
            "AOT warm-compile has no counterpart: PyTorch runs eagerly; the "
            "CUDA kernels build at first use (ROADMAP.md, 'These need no "
            "counterpart')")


def check_det_head_loss(config, registry: TaskRegistry) -> None:
    """The JAX Trainer's guided error: a CenterNet loss needs the
    CenterNet head, a grid loss a grid head (baseline or ``type`` other
    than centernet)."""
    if registry.num_of_type(DETECTION) == 0:
        return
    loss_cfg = (config.get("training.loss_configs", {}) or {}).get(
        "detection", {}) or {}
    det_loss = str(loss_cfg.get("type", "CenterNet")).lower()
    det_head = str(config.get("model.heads.detection.type",
                              "centernet")).lower()
    use_baseline = bool(config.get("model.heads.use_baseline", False))
    head_is_centernet = det_head == "centernet" and not use_baseline
    if head_is_centernet != (det_loss in ("centernet", "")):
        raise ValueError(
            f"Detection head/loss mismatch: head type {det_head!r} vs loss "
            f"type {det_loss!r}. Fix: set "
            "training.loss_configs.detection.type='Detection' for a grid "
            "head, or model.heads.detection.type='centernet' for the "
            "CenterNet loss.")
