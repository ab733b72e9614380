"""The reference train step and eval forward, in plain PyTorch.

``RefTrainer`` follows the port's ``Trainer.train_batch`` for one process
without gradient accumulation: photometric augmentation (+ flips) ->
train-mode forward (drop path, dropout) -> CenterNet targets -> loss
times the type's fixed weight -> backward -> clip of the model's grads by
``max_norm / (norm + 1e-6)`` -> optax-style grouped AdamW / Adam (encoder
x ``encoder_lr_multiplier``, heads x ``head_lr_multiplier``, frozen
leaves untouched, every other leaf updated every step). Its random draws
come from one generator on the model's device, made in the port's order,
so the same seed gives the same masks and noise on both sides.

``predict_raw`` is the port's ``Predictor`` forward without the decode:
normalize, eval forward, the head's outputs as f32.

``Fp8Forward`` is the control of the comparisons: inside it every matrix
product and convolution of the forward reads its operands rounded to
float8 e4m3 (one scale per tensor, its largest magnitude mapped to 448),
the backward passing the rounding straight through.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from . import losses as losses_lib
from .centernet import make_centernet_targets
from .image import input_prep_fns, normalize_images, random_flips
from .layers import resize_to
from .tasks import CLASSIFICATION, DETECTION, SEGMENTATION


def label_params(model: nn.Module, freeze_encoder: bool = False,
                 freeze_backbone: bool = False) -> Dict[str, str]:
    """Parameter name -> ``encoder`` / ``head`` / ``frozen``, as the port
    labels them (``rope_periods`` always frozen; ``freeze_backbone``
    freezes ``encoder.backbone.*``)."""

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


class RefAdam:
    """optax ``scale_by_adam(0.9, 0.999, 1e-8)`` -> ``add_decayed_weights``
    (AdamW only) -> ``scale(multiplier)`` -> ``params += -lr * update``,
    per group of leaves; state f32, zero at the start."""

    def __init__(self, groups: List[Tuple[float, List[nn.Parameter]]],
                 weight_decay: float, kind: str = "AdamW"):
        if kind not in ("AdamW", "Adam"):
            raise ValueError(f"the reference has no optimizer {kind!r}")
        self.groups = [(float(m), list(ps)) for m, ps in groups if ps]
        self.wd = 0.0 if kind == "Adam" else float(weight_decay)
        self.count = 0
        self.mu = [[torch.zeros_like(p) for p in ps] for _, ps in self.groups]
        self.nu = [[torch.zeros_like(p) for p in ps] for _, ps in self.groups]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for i, (mult, ps) in enumerate(self.groups):
            for p, mu, nu in zip(ps, self.mu[i], self.nu[i]):
                g = p.grad
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (mu / (1.0 - b1 ** self.count)) / (
                    torch.sqrt(nu / (1.0 - b2 ** self.count)) + eps)
                if self.wd:
                    upd = upd + self.wd * p
                p.add_(upd * mult, alpha=-lr)


class RefTrainer:
    """The port's train step, plainly (module docstring). ``seed`` seeds
    the generator on the model's device, as the port's Trainer does."""

    def __init__(self, config, model: nn.Module, registry, seed: int):
        self.config, self.model, self.registry = config, model, registry
        dev = next(model.parameters()).device
        self.device = dev
        if config.get("training.adaptive_loss.enabled", False):
            raise ValueError("the reference has no adaptive loss weights")
        if int(config.get("training.accumulation_steps", 1) or 1) > 1:
            raise ValueError("the reference has no gradient accumulation")
        self.loss_fns, weights, _ = losses_lib.build_all_losses(config,
                                                                registry)
        self.weights = {}
        for t in registry.present_types():
            key = "regression" if t == "Regression" else t
            w = (weights or {}).get(key, (weights or {}).get(t))
            self.weights[t] = 1.0 if w is None else float(w)
        self.aux_weights = [float(w) for w in config.get(
            "model.heads.segmentation.aux_loss_weights", [0.5, 0.3, 0.2])]
        self.grad_clip = float(config.get("training.gradient_clip", 0) or 0)
        opt = config.get("training.optimizer", {}) or {}
        grouped = bool(opt.get("use_grouped_lr", True))
        mults = {"encoder": float(opt.get("encoder_lr_multiplier", 0.1))
                 if grouped else 1.0,
                 "head": float(opt.get("head_lr_multiplier", 1.0))
                 if grouped else 1.0}
        labels = label_params(
            model, bool(config.get("model.encoder.freeze_encoder", False)),
            bool(config.get("model.encoder.freeze_dino", False)))
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        by = {"encoder": [], "head": []}
        self.opt_names = {"encoder": [], "head": []}
        for n, p in model.named_parameters():
            if labels[n] != "frozen":
                by[labels[n]].append(p)
                self.opt_names[labels[n]].append(n)
        self.optimizer = RefAdam(
            [(mults[k], by[k]) for k in ("encoder", "head")],
            float(config.weight_decay), kind=str(opt.get("type", "AdamW")))
        self.opt_leaf_names = self.opt_names["encoder"] + self.opt_names[
            "head"]
        self.lr = float(config.learning_rate)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(int(seed))
        self.train_prep, _ = input_prep_fns(config, model.dtype)
        aug = config.get("data.augmentation.train", {}) or {}
        self.flip_h = float(aug.get("horizontal_flip", 0.0) or 0.0)
        self.flip_v = float(aug.get("vertical_flip", 0.0) or 0.0)
        self.nc = registry.num_classes_table
        for p in self.params:
            p.grad = torch.zeros_like(p)

    def _raw_loss(self, outputs, labels, task_type, task_index: int):
        ncls = int(self.nc[task_index])
        fn = self.loss_fns[task_type]
        if task_type == SEGMENTATION and isinstance(outputs, tuple):
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
            raise ValueError("the reference has no grid detection head")
        return fn(outputs.float(), labels, num_valid_cols=2 * ncls)

    def step(self, batch: Dict) -> Dict:
        """One train step on ``batch`` (tensors on the model's device).
        Returns the total loss (a float), each leaf's grad norm as the
        optimizer got it, clipped (f32 tensor over ``names``), and the
        whole gradient's norm before the clip."""
        images, labels = batch["image"], batch["label"]
        if not labels.is_floating_point():
            labels = labels.long()
        task_type, tidx = batch["task_type"], int(batch["task_index"])
        for p in self.params:
            p.grad.zero_()
        if self.flip_h > 0 or self.flip_v > 0:
            images, labels = random_flips(images, labels, task_type,
                                          self.flip_h, self.flip_v,
                                          generator=self.generator)
        x = self.train_prep(images, generator=self.generator)
        outputs = self.model(x, task_type, tidx, train=True,
                             generator=self.generator)
        total = self._raw_loss(outputs, labels, task_type, tidx) * (
            self.weights[task_type])
        total.backward()
        del outputs, x
        norm = math.nan
        if self.grad_clip > 0:
            norm = float(torch.nn.utils.clip_grad_norm_(self.params,
                                                        self.grad_clip))
        norms = torch.stack([p.grad.float().norm() for p in self.params])
        self.optimizer.step(self.lr)
        return {"total_loss": float(total.detach()), "grad_norms": norms,
                "norm": norm}


@torch.no_grad()
def predict_raw(model: nn.Module, config, images_u8: torch.Tensor,
                task_type: str, task_index: int):
    """The eval forward of uint8 [B, S, S, 3] images on the model's
    device: the head's output (a dict of maps for CenterNet), in f32."""
    mean = config.get("data.augmentation.normalize.mean")
    std = config.get("data.augmentation.normalize.std")
    x = normalize_images(images_u8, mean, std, dtype=torch.float32)
    out = model(x, task_type, task_index)
    if isinstance(out, tuple):
        out = out[0]
    if isinstance(out, dict):
        return {k: v.float() for k, v in out.items()}
    return out.float()


E4M3_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale per tensor (its
    largest magnitude to 448), back in its dtype; the gradient passes
    the rounding unchanged (autograd does not differentiate a float8
    cast)."""
    with torch.no_grad():
        amax = t.abs().amax().float().clamp(min=1e-30)
        scale = E4M3_MAX / amax
        q = ((t.float() * scale).to(torch.float8_e4m3fn).float()
             / scale).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


_FP8_OPS = {F.linear, F.conv2d, torch.matmul, torch.Tensor.matmul,
            torch.Tensor.__matmul__, torch.bmm, torch.mm, torch.einsum}


class Fp8Forward(TorchFunctionMode):
    """Inside it, the floating operands of every linear, convolution and
    matrix product are rounded to e4m3 first (the control)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FP8_OPS:
            args = tuple(round_fp8(a) if torch.is_tensor(a)
                         and a.is_floating_point() else a for a in args)
        return func(*args, **kwargs)
