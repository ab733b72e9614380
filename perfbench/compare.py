"""How ``correct`` is decided: the numbers compared between the program
and the reference, each held to its limit (``limits/<cell>.json``).

Training (the same steps from the same weights, batches and seed):

* ``grad_gap``: over every leaf that carries a gradient (the optimizer's
  leaves, their first gradient as the optimizer got it, clipped; the
  frozen leaves, whose gradient the step computes and the clip counts,
  from their ``.grad``), the widest gap between the shares of the
  program's and the reference's first gradient that fall on the leaf
  (its norm over the norm of all the leaves), over the reference's share
  of that leaf or of the median leaf, whichever is larger;
* ``update_gap``: over the optimizer's leaves, the widest gap of the
  same kind (plain norms) of each leaf's change over the compared steps.

A leaf whose reference gradient is nought to rounding in every compared
step (under ``NOUGHT`` of the median leaf's largest) is left out of both.
Of the other leaves' changes, an element whose reference gradient stays
under ``NOUGHT`` of its leaf's largest in every step (a key's bias under
softmax, which Adam moves by round-off alone) is left out on both sides.
``counted`` says how many leaves are held.

* ``grad_gap_frozen_own``: the gradient's widest gap over the frozen
  leaves alone, as shares of their own norm, over their own median leaf
  at the least (a frozen backbone's gradient, computed only to be
  dropped, is far smaller than the trained leaves', and so lies below
  ``grad_gap``'s floor).

Beside them, for the record: the first step's and the widest step's loss
gaps, the worst optimizer leaf and the worst frozen leaf of the gradient,
the medians over the leaves, the change's widest gap without the element
rule, and the clip's global norm on both sides with their gap.

Serving (each sampled answer against the reference's forward of the same
image and task): ``class_gap``, over every choice an answer makes (a
segmentation pixel's class, a classification's class, a detection's peak
cell), the widest amount by which the reference's logit of the served
choice lies below its best; ``coord_err``, the largest distance of a
served coordinate (a detection box's corner, at the cell whose reference
box lies nearest the served one; a keypoint) from the reference's, in
units of the image's side.

Faults planted for the tests and the calibration (``plant``):
``frozen_state`` (the optimizer step does nothing), ``half_batch`` (the
step sees the first half of the batch, its mean over those rows),
``altered_answer`` (a served answer changed where it is produced), and
one kernel's backward output scaled by 1.1: ``K1b_dw`` (the attention
branch's projection weight grad), ``K2b_dw`` (the MLP branch's fc2 weight
grad), ``K4b_dv`` (global attention's dv).
"""

from __future__ import annotations

import contextlib
import importlib
import math
from typing import Dict, List

import torch

NOUGHT = 1e-3
# a kernel's backward output scaled: (module, autograd Function, index)
KERNEL_FAULTS = {
    "K1b_dw": ("fmc_uia_tpu_torch.ops.swin_block", "_AttentionBranchFn", 5),
    "K2b_dw": ("fmc_uia_tpu_torch.ops.swin_block", "_MlpBranchFn", 5),
    "K4b_dv": ("fmc_uia_tpu_torch.ops.vit_attention", "_GlobalAttentionFn",
               2)}
FAULTS = ("frozen_state", "half_batch", "altered_answer", *KERNEL_FAULTS)


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32: TF32 off for matmuls and cuDNN inside."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _scale_kernel_output(fault: str):
    """Patch the kernel's autograd Function so that its backward returns
    output ``index`` times 1.1; returns what undoes it."""
    mod, name, index = KERNEL_FAULTS[fault]
    fn_cls = getattr(importlib.import_module(mod), name)
    orig = fn_cls.__dict__["backward"]

    def backward(ctx, *grads):
        out = list(orig.__func__(ctx, *grads))
        out[index] = out[index] * 1.1
        return tuple(out)

    fn_cls.backward = staticmethod(backward)

    def undo():
        fn_cls.backward = orig

    return undo


def plant(fault, target):
    """Break the timed path underneath (tests and calibration only):
    ``target`` is the Trainer (``frozen_state``, ``half_batch``) or the
    StreamingPredictor's Predictor (``altered_answer``); a kernel fault
    patches the kernel's autograd Function for the whole process. Returns
    what undoes the fault."""
    if fault is None:
        return lambda: None
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault in KERNEL_FAULTS:
        return _scale_kernel_output(fault)
    if fault == "frozen_state":
        target._optimizer_step = lambda: None
    elif fault == "half_batch":
        put = target.put_batch

        def half(batch):
            b = put(batch)
            n = b["image"].shape[0] // 2
            return dict(b, image=b["image"][:n], label=b["label"][:n])

        target.put_batch = half
    elif fault == "altered_answer":
        predict = target.predict_device

        def altered(images, task_id):
            out = predict(images, task_id)
            return out + 1 if out.dtype != torch.float32 else out + 0.05

        target.predict_device = altered
    return lambda: None


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep: List[str]) -> Dict[str, float]:
    med = sorted(ref[n] for n in keep)[len(keep) // 2]
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in keep}


def _worst(gaps: Dict[str, float]):
    """(the largest gap, its leaf); a gap that is not a number is the
    largest."""
    if not gaps:
        return math.nan, ""
    bad = [n for n, v in gaps.items() if not math.isfinite(v)]
    if bad:
        return math.inf, bad[0]
    n = max(gaps, key=gaps.get)
    return gaps[n], n


def _median(values) -> float:
    v = sorted(values)
    if not v:
        return math.nan
    if any(not math.isfinite(x) for x in v):
        return math.inf
    return v[len(v) // 2]


def _shares(values: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's norm over the norm of all the leaves together."""
    total = math.sqrt(sum(v ** 2 for v in values.values()))
    return {n: v / total if total > 0 else math.nan
            for n, v in values.items()}


def _moved(deltas: Dict[str, torch.Tensor], gabs: Dict[str, torch.Tensor],
           names: List[str], rule: bool = True) -> Dict[str, float]:
    """Each leaf's change's norm; with ``rule``, over the elements whose
    reference gradient reached ``NOUGHT`` of the leaf's largest."""
    out = {}
    for n in names:
        d = deltas[n]
        if rule:
            g = gabs[n]
            d = d[g >= NOUGHT * g.max()]
        out[n] = float(d.float().norm())
    return out


def _own_gaps(prog: Dict[str, float], ref: Dict[str, float],
              group: List[str]) -> Dict[str, float]:
    """The gradient's leaf gaps within ``group`` alone: shares of the
    group's norm, over the group's median leaf at the least."""
    if not group:
        return {}
    g_prog = _shares({n: prog[n] for n in group})
    g_ref = _shares({n: ref[n] for n in group})
    return _leaf_gaps(g_prog, g_ref, [n for n in group if g_ref[n] > 0])


def train_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """The training numbers (module docstring) of one run, and beside
    them, for the record, the others and the worst leaf of each.

    Both sides hold ``names`` (every leaf), ``g1`` (name -> the first
    gradient's norm), ``loss`` (each step's), ``opt`` (the optimizer's
    leaves) and ``delta`` (name -> an optimizer leaf's change over the
    steps); the reference also ``gmax`` (name -> the leaf's largest
    gradient norm over the steps) and ``gabs`` (name -> each element's
    largest gradient magnitude)."""
    names, opt = list(reference["names"]), list(reference["opt"])
    if (sorted(program["names"]) != sorted(names)
            or sorted(program["opt"]) != sorted(opt)):
        raise ValueError("the program's and the reference's leaves differ")
    gmax = reference["gmax"]
    top = sorted(gmax.values())[len(gmax) // 2]
    keep = {n for n in names if gmax[n] >= NOUGHT * top}
    g_ref, g_prog = _shares(reference["g1"]), _shares(program["g1"])
    g_gaps = _leaf_gaps(g_prog, g_ref,
                        [n for n in names if n in keep and g_ref[n] > 0])
    in_opt = set(opt)
    u_keep = [n for n in opt if n in keep]
    gabs = reference["gabs"]
    u_gaps = _leaf_gaps(_moved(program["delta"], gabs, u_keep),
                        _moved(reference["delta"], gabs, u_keep), u_keep)
    u_all = _leaf_gaps(_moved(program["delta"], gabs, u_keep, False),
                       _moved(reference["delta"], gabs, u_keep, False),
                       u_keep)
    steps = [abs(p - r) / max(abs(r), 1e-6) if math.isfinite(p)
             else math.inf
             for p, r in zip(program["loss"], reference["loss"])]
    g_max, g_leaf = _worst(g_gaps)
    u_max, u_leaf = _worst(u_gaps)
    out = {"grad_gap": g_max, "update_gap": u_max,
           "loss1_gap": steps[0], "loss_gap_max": max(steps),
           "grad_gap_opt": _worst({n: v for n, v in g_gaps.items()
                                   if n in in_opt})[0],
           "grad_gap_frozen": _worst({n: v for n, v in g_gaps.items()
                                      if n not in in_opt})[0],
           "grad_gap_frozen_own": _worst(_own_gaps(
               program["g1"], reference["g1"],
               [n for n in names if n in keep and n not in in_opt]))[0],
           "grad_gap_median": _median(g_gaps.values()),
           "update_gap_median": _median(u_gaps.values()),
           "update_gap_all": _worst(u_all)[0],
           "counted": float(len(keep)), "grad_leaf": g_leaf,
           "update_leaf": u_leaf}
    if "norm1" in program and "norm1" in reference:
        out["norm1_gap"] = (abs(program["norm1"] - reference["norm1"])
                            / abs(reference["norm1"]))
        out["norm1"] = program["norm1"]
        out["norm1_ref"] = reference["norm1"]
    return out


def judge(numbers: Dict[str, float], limits: Dict) -> Dict:
    """(correct, the checks line): each number with its limit, in the
    limits file's order; a number above its limit, or not a number,
    fails."""
    checks, ok = {}, True
    for name, spec in limits["limits"].items():
        v = float(numbers.get(name, math.nan))
        good = math.isfinite(v) and v <= spec["limit"]
        ok = ok and good
        checks[name] = {"value": v, "limit": spec["limit"]}
    return ok, checks


# -- serving ----------------------------------------------------------------
SERVE_NUMBERS = ("class_gap", "coord_err")


def _masked(logits: torch.Tensor, nc: int) -> torch.Tensor:
    valid = torch.arange(logits.shape[-1], device=logits.device) < nc
    return torch.where(valid, logits, torch.full_like(logits, -math.inf))


def decode(out, task_type: str, nc: int) -> List[torch.Tensor]:
    """A reference output decoded as the program's Predictor decodes it
    (the control's answers)."""
    from perfbench.reference.centernet import decode_centernet

    if task_type in ("segmentation", "classification"):
        return list(torch.argmax(_masked(out, nc), -1).int())
    if task_type == "detection":
        return list(decode_centernet(out["heatmap"], out["size"],
                                     out["offset"]))
    return list(out)


def _centernet_boxes(out) -> torch.Tensor:
    """[b, H*W, 4]: the box the reference decodes at every cell."""
    hm = out["heatmap"]
    b, H, W, _ = hm.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=hm.device),
                            torch.arange(W, device=hm.device), indexing="ij")
    cx = (xs.float() + out["offset"][..., 0]) / W
    cy = (ys.float() + out["offset"][..., 1]) / H
    bw, bh = out["size"][..., 0] / W, out["size"][..., 1] / H
    boxes = torch.stack([cx - bw * 0.5, cy - bh * 0.5, cx + bw * 0.5,
                         cy + bh * 0.5], -1).clamp(0.0, 1.0)
    return boxes.reshape(b, H * W, 4)


def serve_gaps(ref, got: List[torch.Tensor], task_type: str, nc: int
               ) -> Dict[str, float]:
    """The serving numbers (module docstring) of a block of answers
    ``got`` against the reference's outputs ``ref`` of the same images."""
    class_gap, coord_err = 0.0, 0.0
    dev = ref["heatmap"].device if isinstance(ref, dict) else ref.device
    for i, g in enumerate(got):
        g = torch.as_tensor(g).to(dev)
        if task_type in ("segmentation", "classification"):
            lv = _masked(ref[i], nc)
            c = g.long()
            if bool(((c < 0) | (c >= nc)).any()):
                return {"class_gap": math.inf}
            picked = torch.gather(lv, -1, c.unsqueeze(-1)).squeeze(-1)
            class_gap = max(class_gap,
                            float((lv.max(-1).values - picked).max()))
        elif task_type == "detection":
            one = {k: t[i:i + 1] for k, t in ref.items()}
            hm = one["heatmap"].reshape(-1)
            d = (_centernet_boxes(one)[0] - g.float().view(1, 4)).abs()
            cell = int(torch.argmin(d.amax(-1)))  # the served peak
            class_gap = max(class_gap, float(hm.max() - hm[cell]))
            coord_err = max(coord_err, float(d[cell].max()))
        else:
            coord_err = max(coord_err, float(
                (ref[i][:2 * nc] - g.float()[:2 * nc]).abs().max()))
    out = {"class_gap": class_gap, "coord_err": coord_err}
    if task_type in ("segmentation", "classification"):
        del out["coord_err"]
    if task_type == "Regression":
        del out["class_gap"]
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
