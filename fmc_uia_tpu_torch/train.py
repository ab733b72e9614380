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

AOT warm-compile has no counterpart and raises; device meshes raise and
name their ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from fmc_uia_tpu_torch import losses as losses_lib
from fmc_uia_tpu_torch.device import resolve_device
from fmc_uia_tpu_torch.ops.centernet import make_centernet_targets
from fmc_uia_tpu_torch.models.layers import resize_to
from fmc_uia_tpu_torch.ops.image import input_prep_fns, random_flips
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    REGRESSION,
    SEGMENTATION,
    TaskRegistry,
)

_NOT_PORTED = ("{what} is not ported to fmc_uia_tpu_torch yet (ROADMAP.md, "
               "port queue item '{item}')")
_ITEM_PARALLEL = "Parallel modes"


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

    return {name: label(name) for name, _ in model.named_parameters()}


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
    def step(self, lr: float) -> None:
        self.count += 1
        for i, (mult, ps) in enumerate(self.groups):
            g = [p.grad for p in ps]
            upd = self._sgd(i, g) if self.kind == "SGD" else self._adam(i, g)
            if self.wd:
                torch._foreach_add_(upd, ps, alpha=self.wd)
            torch._foreach_mul_(upd, mult)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(ps, upd)


def build_optimizer(config, model: nn.Module,
                    adaptive: Optional[nn.ParameterDict] = None
                    ) -> GroupedOptimizer:
    """The grouped optimizer of ``training.optimizer`` (``type`` AdamW,
    Adam or SGD with ``momentum``)."""
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
    for name, p in model.named_parameters():
        if labels[name] != "frozen":
            by_label[labels[name]].append(p)
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
    JAX accumulation step does."""

    def __init__(self, config, model: nn.Module,
                 registry: Optional[TaskRegistry] = None, device="cuda",
                 seed: Optional[int] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                what="data/tensor-parallel meshes", item=_ITEM_PARALLEL))
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
        self.optimizer = build_optimizer(config, model, self.adaptive)
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
        self._params = list(model.parameters())
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
        widened to int64 on the device."""
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
        grads in ``.grad`` (zeroed first), unclipped; returns the logs."""
        b = self.put_batch(batch)
        task_type = b["task_type"]
        task_index = self._index(b)
        images, labels = b["image"], b["label"]
        torch._foreach_zero_([p.grad for p in self._params
                              + self._adaptive_params])
        if self.flip_h > 0 or self.flip_v > 0:
            images, labels = random_flips(images, labels, task_type,
                                          self.flip_h, self.flip_v,
                                          generator=self.generator)
        x = self.train_prep(images, generator=self.generator)
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
        total.backward()
        return {"total_loss": total.detach(), "raw_loss": raw.detach(),
                "task_weight": weight.detach(), **moe_logs}

    def _gate_adaptive(self, epoch: int) -> None:
        """Zero the adaptive log-vars' grads in the warmup epochs."""
        if self.adaptive is not None and epoch < self.adaptive_warmup:
            torch._foreach_zero_([p.grad for p in self._adaptive_params])

    def compute_grads(self, batch: Dict, epoch: int = 0) -> Dict:
        """Augment, forward in train mode, loss, backward and clip: leaves
        the step's grads in ``.grad`` and returns the logs."""
        logs = self._backward(batch)
        if self.grad_clip > 0:
            logs["grad_norm"] = torch.nn.utils.clip_grad_norm_(
                self._params, self.grad_clip)
        self._gate_adaptive(epoch)
        return logs

    def _accumulate(self, batch: Dict, epoch: int) -> Dict:
        """One micro-step of gradient accumulation (module docstring)."""
        logs = self._backward(batch)
        self._gate_adaptive(epoch)
        grads = [p.grad for p in self._params + self._adaptive_params]
        torch._foreach_add_(self.grad_accum, torch._foreach_div(
            grads, float(self.accum_steps)))
        self._micro_step += 1
        if self._micro_step % self.accum_steps == 0:
            torch._foreach_copy_(grads, self.grad_accum)
            if self.grad_clip > 0:
                torch.nn.utils.clip_grad_norm_(self._params, self.grad_clip)
            self.optimizer.step(self.scheduler.current_lr())
            torch._foreach_zero_(self.grad_accum)
        return {k: logs[k] for k in ("total_loss", "raw_loss",
                                     "task_weight")}

    def train_batch(self, batch: Dict, epoch: int) -> Dict:
        if self.accum_steps > 1:
            logs = self._accumulate(batch, epoch)
        else:
            logs = self.compute_grads(batch, epoch)
            self.optimizer.step(self.scheduler.current_lr())
        self.host_step += 1
        return logs

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
            self.optimizer.step(self.scheduler.current_lr())
        losses = torch.stack(losses)
        return {"total_loss": losses[-1], "losses": losses}

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
