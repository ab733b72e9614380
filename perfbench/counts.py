"""Operations and bytes: the least work of each hand-written kernel at one
launch's shapes, and the operations of one image's forward (and backward)
counted on the plain reference.

A kernel's bound is ``max(operations / peak, bytes / HBM bandwidth)`` (K4
also against its exponentials on the special-function units), counting
the math of the function the kernel computes, each input read once and
each output written once. Peaks are those of ``peaks.json`` (the H100 SXM
data sheet).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from perfbench.core import HERE, load_json

PEAKS = load_json(os.path.join(HERE, "peaks.json"))


def bound_s(ops: float, nbytes: float, exps: float = 0.0,
            dtype_bytes: int = 2) -> float:
    """Least seconds for ``ops`` tensor-core operations (bf16 at 2-byte
    activations, else f32), ``nbytes`` moved and ``exps`` exponentials."""
    peak = PEAKS["bf16_flops"] if dtype_bytes == 2 else PEAKS["f32_flops"]
    return max(ops / peak, nbytes / PEAKS["hbm_bytes_per_s"],
               exps / PEAKS["sfu_exp_per_s"])


# -- the Swin kernels: one launch at (B, hp, wp, C, heads, ws, masked) -----
def k1f(B, hp, wp, C, H, ws, masked, esz=2) -> Tuple[float, float]:
    """Fused attention branch forward: qkv, scores, .v, proj (8 C^2 + 4 N C
    a token); x in and y out, weights and the bias table in f32, the mask."""
    T, N = B * hp * wp, ws * ws
    nw = (hp // ws) * (wp // ws)
    ops = T * (8 * C * C + 4 * N * C)
    nbytes = (2 * T * C * esz + 4 * (4 * C * C + 6 * C) + 4 * H * N * N
              + (4 * nw * N * N if masked else 0))
    return ops, nbytes


def k1b(B, hp, wp, C, H, ws, masked, esz=2) -> Tuple[float, float]:
    """Its pullback with the forward's recompute (22 C^2 + 12 N C a token);
    x and dy in, dx out, the weights in and their grads out."""
    T, N = B * hp * wp, ws * ws
    nw = (hp // ws) * (wp // ws)
    ops = T * (22 * C * C + 12 * N * C)
    nbytes = (3 * T * C * esz + 2 * 4 * (4 * C * C + 6 * C)
              + 2 * 4 * H * N * N + (4 * nw * N * N if masked else 0))
    return ops, nbytes


def k2f(B, hp, wp, C, esz=2) -> Tuple[float, float]:
    """Fused MLP branch forward (ratio 4: 16 C^2 a token)."""
    T = B * hp * wp
    return 16 * T * C * C, 2 * T * C * esz + 4 * (8 * C * C + 7 * C)


def k2b(B, hp, wp, C, esz=2) -> Tuple[float, float]:
    """Its pullback: fc1 recomputed and four products (40 C^2 a token)."""
    T = B * hp * wp
    return 40 * T * C * C, 3 * T * C * esz + 2 * 4 * (8 * C * C + 7 * C)


def k4f(B, H, N, dh, esz=2) -> Tuple[float, float, float]:
    """Global attention forward: q k^T and p v, one exponential a score;
    q, k, v in, o out, the f32 log-sum-exp out."""
    elems = B * H * N * dh
    return (4 * B * H * N * N * dh, 4 * elems * esz + 4 * B * H * N,
            B * H * N * N)


def k4b(B, H, N, dh, esz=2) -> Tuple[float, float, float]:
    """Its backward: S, dP, dV, dK, dQ, one exponential a score; q, k, v,
    o, do in, dq, dk, dv out, the log-sum-exp in."""
    elems = B * H * N * dh
    return (10 * B * H * N * N * dh, 8 * elems * esz + 4 * B * H * N,
            B * H * N * N)


def swin_stages(config) -> List[Dict]:
    """Per stage of a swin encoder at ``data.image_size``: grid, padded
    grid, width, heads, window, block count and which blocks are shifted
    (and so masked)."""
    from perfbench.reference.swin import _SWIN_VARIANTS

    name = str(config.get("model.encoder.name"))
    v = _SWIN_VARIANTS[name]
    ws = int(config.get("model.encoder.window_size", 7))
    S = int(config.get("data.image_size")) // 4
    out = []
    for s, depth in enumerate(v["depths"]):
        g = S // 2 ** s
        shift_ok = g > ws
        hp = -(-g // ws) * ws
        out.append(dict(stage=s, grid=g, hp=hp, C=v["embed_dim"] * 2 ** s,
                        heads=v["num_heads"][s], ws=ws, depth=depth,
                        masked=[shift_ok and b % 2 == 1 or hp != g
                                for b in range(depth)]))
    return out


def kernel_launch_bounds(kernel: str, config, B: int) -> List[Tuple[int,
                                                                   float]]:
    """[(stage or block group, bound seconds of one launch)] for every
    launch one forward (K1f, K2f, K4f) or one backward (K1b, K2b, K4b)
    of a batch of ``B`` could make, per stage: a caller keeps the stages
    whose launch counts explain what the counters read."""
    out = []
    name = str(config.get("model.encoder.name"))
    if kernel in ("K1f", "K1b", "K2f", "K2b"):
        if not name.startswith("swin_"):
            return []
        for st in swin_stages(config):
            for masked in st["masked"]:
                if kernel in ("K1f", "K1b"):
                    fn = k1f if kernel == "K1f" else k1b
                    ops, nb = fn(B, st["hp"], st["hp"], st["C"], st["heads"],
                                 st["ws"], masked)
                else:
                    fn = k2f if kernel == "K2f" else k2b
                    ops, nb = fn(B, st["grid"], st["grid"], st["C"])
                out.append((st["stage"], bound_s(ops, nb)))
        return out
    if kernel in ("K4f", "K4b"):
        from perfbench.reference.vit import _VIT_VARIANTS

        if not name.startswith(("vit_", "dinov3")):
            return []
        v = _VIT_VARIANTS["vit_b" if name.startswith("dinov3") else
                          name.split(":")[-1]]
        timm = str(config.get("model.encoder.timm_name", "") or "")
        p = 8 if "patch8" in timm or "patch8" in name else 16
        g = int(config.get("data.image_size")) // p
        prefix = 1 + int(config.get("model.encoder.num_storage_tokens", 4))
        N = g * g + prefix
        dh = v["embed_dim"] // v["num_heads"]
        fn = k4f if kernel == "K4f" else k4b
        for _ in range(v["depth"]):
            ops, nb, ex = fn(B, v["num_heads"], N, dh)
            out.append((0, bound_s(ops, nb, ex)))
        return out
    raise ValueError(f"unknown kernel {kernel!r}")


def explained_bound_s(kernel: str, config, batches: Dict[int, int],
                      launches: int):
    """Sum of the bounds of ``launches`` launches of ``kernel`` over calls
    at the batch sizes ``batches`` ({B: calls}), both read between two
    calls: the stages whose launches a call makes are the smallest-first
    prefix of stages (K2: the gate is a width) or all (K1, K4) that
    explain the count exactly. The count decides, not a copy of the
    program's gate, so a gate that a later change moves is still
    measured. None when no set explains it."""
    calls = sum(batches.values())
    if calls == 0 or launches == 0:
        return None
    per = {B: kernel_launch_bounds(kernel, config, B) for B in batches}
    any_b = next(iter(per))
    stages = sorted({s for s, _ in per[any_b]})
    for k in range(len(stages), 0, -1):
        keep = stages[:k]
        n = sum(1 for s, _ in per[any_b] if s in keep)
        if n * calls == launches:
            return sum(c * sum(b for s, b in per[B] if s in keep)
                       for B, c in batches.items())
    return None


def model_flops(config, registry, task_type: str, train: bool) -> float:
    """Operations of one image's forward (``train``: and backward, with
    weight grads of the leaves the configuration trains only: a frozen
    leaf, such as ``freeze_dino``'s backbone, gets none, whatever the
    program computes) of a task type, counted on the reference on the
    meta device (matrix products, convolutions and attention; no
    recomputation)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference import vit as ref_vit
    from perfbench.reference.multitask import build_model
    from perfbench.reference.step import label_params

    S = int(config.get("data.image_size"))
    spec = next(s for s in registry if s.task_name == task_type)
    model = build_model(config, registry, dtype=torch.float32, device="meta")
    labels = label_params(
        model, bool(config.get("model.encoder.freeze_encoder", False)),
        bool(config.get("model.encoder.freeze_dino", False)))
    for name, p in model.named_parameters():
        p.requires_grad_(train and labels[name] != "frozen")
    x = torch.zeros(1, S, S, 3, device="meta")
    was = ref_vit.COUNT_MODE
    ref_vit.COUNT_MODE = True
    try:
        with FlopCounterMode(display=False) as fc:
            out = model(x, task_type, spec.global_index, train=False)
            if train:
                leaves = (list(out.values()) if isinstance(out, dict)
                          else [out[0]] if isinstance(out, tuple) else [out])
                total = sum(t.float().sum() for t in leaves)
                total.backward()
    finally:
        ref_vit.COUNT_MODE = was
    return float(fc.get_total_flops())
