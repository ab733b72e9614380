"""Weights from outside the port: the JAX package's ``params`` tree (the
weight bridge) and pretrained timm / DINOv3 checkpoints (``.pth``/``.bin``
files on local disk).

**The bridge** fills the port's parameters from the JAX package's
``params`` tree (nested dicts of numpy arrays).

The port names its parameters by the JAX paths (``encoder.stage0_block1.
attn.qkv.kernel`` <-> ``encoder/stage0_block1/attn/qkv/kernel``), so the
bridge only has to

  * unstack scanned stages: ``stage{s}_scan/block{j}`` leaves carry a
    leading ``[n_pairs]`` axis, and pair ``p`` goes to block ``2p + j``
    (an unrolled stage arrives as ``stage{s}_block{b}`` already);
  * re-lay ``kernel`` leaves, by rank: dense ``[in, out]`` -> ``[out, in]``,
    banked dense ``[T, in, out]`` -> ``[T, out, in]``, conv HWIO -> OIHW,
    banked conv ``[T, kh, kw, I, O]`` -> ``[T, O, I, kh, kw]``.

Every other leaf keeps its name and layout: LayerNorm scales and biases,
the ViT/DINOv3 ``cls_token``, ``storage_tokens``, ``prefix_tokens``,
``pos_embed``, ``rope_periods`` (a parameter in JAX, so one here) and
LayerScale ``ls1``/``ls2``. It raises on any leaf left unmatched on either
side, and on a shape mismatch.

**Pretrained encoders** (``model.encoder.pretrained``: a local path; the
port's counterparts of ``fmc_uia_tpu/utils/convert.py``): a timm Swin v1
(both PatchMerging layouts), a timm plain ViT or a DINOv3 checkpoint
(the facebookresearch naming, or timm's Eva repackaging) is converted
into the JAX package's encoder tree, with the same rules (torch Linear
[out, in] -> [in, out]; Conv OIHW -> HWIO; LayerNorm weight/bias ->
scale/bias; timm's PatchMerging chunk order -> ours; the Swin
relative-position tables and the ViT pos-embed grid resampled as
``jax.image.resize(method='cubic')`` resamples them), merged over the
port encoder's own parameters read in that layout (the port's stages
are unrolled, so the Swin blocks stay ``stage{s}_block{b}``; the
window, grid and prefix tokens come from their shapes; entries the
checkpoint lacks keep their values; a shape mismatch raises), and
written back through the bridge. So the
bridge is the one place that knows the two layouts. The ResNet-50
converter waits for the port's ResNet encoder (ROADMAP.md, port queue
item 'Other encoders').

``python -m fmc_uia_tpu_torch.utils.convert --verify FILE [--device cpu]``
checks a checkpoint file against the manifests of ``timm_manifests.py``,
converts and loads it into a port encoder of its geometry and runs a
forward (on the card unless ``--device cpu``); where timm is installed it
also holds the forward against timm's.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

_SCAN = re.compile(r"^(.*)stage(\d+)_scan/block([01])/(.*)$")
_KERNEL_PERM = {2: (1, 0), 3: (0, 2, 1), 4: (3, 2, 0, 1), 5: (0, 4, 3, 1, 2)}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def jax_leaves_to_port(tree: Mapping) -> Dict[str, np.ndarray]:
    """The JAX tree as ``{port parameter name: array in port layout}``."""
    leaves = {}
    for path, arr in _flatten(tree).items():
        m = _SCAN.match(path)
        if m:
            pre, s, j, rest = m.groups()
            parts = [(f"{pre}stage{s}_block{2 * p + int(j)}/{rest}", arr[p])
                     for p in range(arr.shape[0])]
        else:
            parts = [(path, arr)]
        for name, a in parts:
            if name.rsplit("/", 1)[-1] == "kernel":
                a = np.transpose(a, _KERNEL_PERM[a.ndim])
            key = name.replace("/", ".")
            if key in leaves:
                raise ValueError(f"two JAX leaves map to {key!r}")
            # (ascontiguousarray alone would make a 0-d leaf 1-d)
            leaves[key] = np.ascontiguousarray(a, np.float32).reshape(
                a.shape)
    return leaves


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy every leaf of the JAX ``params`` tree into ``model``."""
    leaves = jax_leaves_to_port(tree)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"JAX tree does not match the port: port params "
                         f"without a JAX leaf {missing[:8]} "
                         f"({len(missing)}), JAX leaves without a port "
                         f"param {extra[:8]} ({len(extra)})")
    with torch.no_grad():
        for name, p in params.items():
            a = leaves[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {a.shape} != port "
                                 f"shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a))


def _unflatten(leaves: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, a in leaves.items():
        *parents, leaf = path.split(".")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def port_params_as_jax_tree(module: torch.nn.Module) -> Dict:
    """``module``'s parameters as a JAX-layout tree (the bridge's inverse,
    unrolled stages): ``kernel`` leaves re-laid, every other leaf as is."""
    leaves = {}
    for name, p in module.named_parameters():
        a = p.detach().cpu().float().numpy()
        if name.rsplit(".", 1)[-1] == "kernel":
            a = np.transpose(a, np.argsort(_KERNEL_PERM[a.ndim]))
        leaves[name] = np.ascontiguousarray(a).reshape(a.shape)
    return _unflatten(leaves)


# ---------------------------------------------------------------------------
# pretrained checkpoints -> the JAX-layout encoder tree
# ---------------------------------------------------------------------------
def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint file as ``{key: numpy array}`` (f32 for half
    types), unwrapping a ``state_dict`` or ``model`` entry. Loaded with
    ``weights_only=True``: tensors and plain containers only, no code."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(
            obj["model"], dict):
        obj = obj["model"]
    out = {}
    for k, v in obj.items():
        if torch.is_tensor(v):
            v = v.detach().cpu()
            if v.dtype in (torch.bfloat16, torch.float16):
                v = v.float()
            out[k] = v.numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _linear(sd, key):
    return {"kernel": sd[f"{key}.weight"].T.astype(np.float32),
            "bias": sd[f"{key}.bias"].astype(np.float32)}


def _linear_nobias(sd, key):
    return {"kernel": sd[f"{key}.weight"].T.astype(np.float32)}


def _conv(sd, key, bias=True):
    out = {"kernel": sd[f"{key}.weight"].transpose(2, 3, 1, 0)
           .astype(np.float32)}
    if bias and f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"].astype(np.float32)
    return out


def _norm(sd, key):
    return {"scale": sd[f"{key}.weight"].astype(np.float32),
            "bias": sd[f"{key}.bias"].astype(np.float32)}


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of ``jax.image.resize(method='cubic')``
    along one axis, built as ``jax._src.image.scale.compute_weight_mat``
    builds them (and as ``models/encoders/adapters.antialias_weights``
    builds the linear ones): Keys' kernel (a = -0.5) at half-pixel
    centres, widened by 1/scale when shrinking (antialias), each output's
    weights normalised to sum 1 (summed row by row, as XLA reduces), zero
    where the sample lies outside the input."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = f32(max(float(inv_scale), 1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
    x = x / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0,
                 ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w)
    total = np.zeros(n_out, f32)
    for row in w:
        total = total + row
    eps = 1000.0 * float(np.finfo(f32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def _resize_grid_cubic(grid: np.ndarray, side: int) -> np.ndarray:
    """``jax.image.resize(grid, (side, side, C), method='cubic')`` of an
    f32 [g, g, C] grid, from the same f32 weights, contracted in f64 and
    rounded to f32 once (JAX contracts in f32: the two differ by JAX's
    rounding, about 1e-6 of the largest value)."""
    w = _cubic_weights(grid.shape[0], side).astype(np.float64)
    out = np.einsum("hwc,hi,wj->ijc", np.asarray(grid, np.float64), w, w,
                    optimize=True)
    return out.astype(np.float32)


def interpolate_rel_pos_bias(table: np.ndarray,
                             target_window: int) -> np.ndarray:
    """A relative-position-bias table [(2 ws - 1)^2, H] resampled to
    [(2 tw - 1)^2, H] (bicubic, as the JAX package)."""
    src_side = int(np.sqrt(table.shape[0]))
    tgt_side = 2 * target_window - 1
    if src_side == tgt_side:
        return table
    grid = table.reshape(src_side, src_side, -1)
    return _resize_grid_cubic(grid, tgt_side).reshape(tgt_side * tgt_side,
                                                      -1)


def interpolate_pos_embed(grid_pos: np.ndarray,
                          target_grid: int) -> np.ndarray:
    """A [1, g*g, C] patch pos-embed resampled to a side of
    ``target_grid`` (bicubic)."""
    g = int(np.sqrt(grid_pos.shape[1]))
    if g == target_grid:
        return grid_pos
    grid = grid_pos.reshape(g, g, -1)
    return _resize_grid_cubic(grid, target_grid).reshape(
        1, target_grid * target_grid, -1)


def _swin_block_params(sd, base: str,
                       target_window: Optional[int] = None) -> Dict:
    bias = sd[f"{base}.attn.relative_position_bias_table"].astype(np.float32)
    if target_window is not None:
        bias = interpolate_rel_pos_bias(bias, target_window)
    return {
        "norm1": _norm(sd, f"{base}.norm1"),
        "attn": {
            "qkv": _linear(sd, f"{base}.attn.qkv"),
            "proj": _linear(sd, f"{base}.attn.proj"),
            "rel_pos_bias": bias,
        },
        "norm2": _norm(sd, f"{base}.norm2"),
        "mlp_fc1": _linear(sd, f"{base}.mlp.fc1"),
        "mlp_fc2": _linear(sd, f"{base}.mlp.fc2"),
    }


# timm's PatchMerging concatenates the 2x2 neighbourhood (w, h)-major:
# chunks [(h0,w0), (h1,w0), (h0,w1), (h1,w1)]; ours is (h, w)-major:
# [(h0,w0), (h0,w1), (h1,w0), (h1,w1)]. Chunks 1 and 2 swap.
_MERGE_CHUNK_PERM = (0, 2, 1, 3)


def _permute_merge_chunks(arr: np.ndarray, axis: int = 0) -> np.ndarray:
    """Reorder an array's 4C axis from timm's chunk order to ours."""
    chunks = np.split(arr, 4, axis=axis)
    return np.concatenate([chunks[i] for i in _MERGE_CHUNK_PERM], axis=axis)


def _merge_params(sd, base: str) -> Dict:
    """One timm PatchMerging (norm over 4C, reduction 4C -> 2C)."""
    norm = _norm(sd, f"{base}.norm")
    red = _linear_nobias(sd, f"{base}.reduction")
    return {
        "norm": {"scale": _permute_merge_chunks(norm["scale"]),
                 "bias": _permute_merge_chunks(norm["bias"])},
        "reduction": {"kernel": _permute_merge_chunks(red["kernel"],
                                                      axis=0)},
    }


def convert_swin(sd: Dict[str, np.ndarray],
                 depths: Sequence[int] = (2, 2, 18, 2),
                 target_window: Optional[int] = None) -> Dict:
    """timm Swin v1 state dict -> the JAX ``SwinEncoder`` tree, its stages
    unrolled (``stage{s}_block{b}``, the JAX package's ``scan_blocks=False``
    form, which the port's modules share). ``target_window`` resamples the
    relative-position tables to another window."""
    params: Dict = {"patch_embed": _conv(sd, "patch_embed.proj"),
                    "patch_norm": _norm(sd, "patch_embed.norm")}

    def block(stage, b):
        return _swin_block_params(sd, f"layers.{stage}.blocks.{b}",
                                  target_window)

    # the old layout (Microsoft's release, timm < 0.9) keeps PatchMerging
    # at the end of the stage before (layers.0.downsample exists); timm >=
    # 0.9 puts it at the start of the stage it feeds
    old_layout = "layers.0.downsample.reduction.weight" in sd
    for stage, depth in enumerate(depths):
        if stage > 0:
            ds = (f"layers.{stage - 1}.downsample" if old_layout
                  else f"layers.{stage}.downsample")
            params[f"merge{stage}"] = _merge_params(sd, ds)
        for b in range(depth):
            params[f"stage{stage}_block{b}"] = block(stage, b)
    return params


def convert_vit(sd: Dict[str, np.ndarray], depth: int = 12,
                keep_prefix_tokens: bool = True,
                target_grid: Optional[int] = None) -> Dict:
    """timm plain-ViT state dict -> the JAX ``ViTBackbone`` tree.
    ``keep_prefix_tokens``: the cls (and register) tokens become
    ``prefix_tokens`` with their pos-embed rows (registers without rows get
    zero rows); else both are dropped. ``target_grid``: the patch
    pos-embed resampled to this side."""
    params: Dict = {"patch_embed": {
        "kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0)
        .astype(np.float32),
        "bias": sd["patch_embed.proj.bias"].astype(np.float32)}}
    pos = sd["pos_embed"].astype(np.float32)
    n_rows = pos.shape[1]
    side = int(np.sqrt(n_rows))
    n_prefix = 0 if side * side == n_rows else n_rows - side * side
    prefix_pos, grid_pos = pos[:, :n_prefix, :], pos[:, n_prefix:, :]
    if target_grid is not None:
        grid_pos = interpolate_pos_embed(grid_pos, target_grid)
    tokens = []
    if keep_prefix_tokens:
        for key in ("cls_token", "reg_token", "register_tokens",
                    "storage_tokens"):
            if key in sd:
                tokens.append(sd[key].astype(np.float32))
    if tokens:
        prefix_tokens = np.concatenate(tokens, axis=1)
        P = prefix_tokens.shape[1]
        if n_prefix < P:
            prefix_pos = np.concatenate(
                [prefix_pos,
                 np.zeros((1, P - n_prefix, pos.shape[-1]), np.float32)],
                axis=1)
        params["prefix_tokens"] = prefix_tokens
        params["pos_embed"] = np.concatenate([prefix_pos, grid_pos], axis=1)
    else:
        params["pos_embed"] = grid_pos
    for i in range(depth):
        b = f"blocks.{i}"
        params[f"block{i}"] = {
            "norm1": _norm(sd, f"{b}.norm1"),
            "qkv": _linear(sd, f"{b}.attn.qkv"),
            "proj": _linear(sd, f"{b}.attn.proj"),
            "norm2": _norm(sd, f"{b}.norm2"),
            "mlp_fc1": _linear(sd, f"{b}.mlp.fc1"),
            "mlp_fc2": _linear(sd, f"{b}.mlp.fc2"),
        }
    return params


def convert_dinov3(sd: Dict[str, np.ndarray], depth: Optional[int] = None
                   ) -> Dict:
    """DINOv3 state dict -> the JAX ``ViTBackbone(rope=True)`` tree. Takes
    the facebookresearch naming (``storage_tokens``, ``rope_embed.periods``,
    ``blocks.N.ls1.gamma``) and timm's Eva repackaging (``reg_token``,
    ``gamma_1``, split ``q_proj/k_proj/v_proj``); wrappers such as
    ``module.`` or ``teacher.backbone.`` are stripped. ``mask_token``, the
    final ``norm`` and any head are dropped (the features are taken at
    intermediate blocks); ``rope_embed.periods`` becomes ``rope_periods``
    as it is."""
    for wrap in ("module.", "teacher.backbone.", "student.backbone.",
                 "teacher.", "backbone."):
        if any(k.startswith(wrap) for k in sd) and not any(
                k.startswith("blocks.") or k == "cls_token" for k in sd):
            sd = {k[len(wrap):]: v for k, v in sd.items()
                  if k.startswith(wrap)}

    def first(*keys):
        for k in keys:
            if k in sd:
                return sd[k]
        return None

    if depth is None:
        depth = 1 + max(
            (int(k.split(".")[1]) for k in sd
             if k.startswith("blocks.") and k.split(".")[1].isdigit()),
            default=-1)
        if depth <= 0:
            raise ValueError("no 'blocks.N.*' keys — not a ViT state_dict")
    if any(".mlp.fc1_g." in k or ".mlp.w1." in k or ".mlp.w12." in k
           for k in sd):
        raise ValueError(
            "checkpoint uses a SwiGLU FFN (DINOv3 H+/7B variants); only the "
            "MLP variants (S/B/L) are supported — pick a vit_*_dinov3 "
            "S/B/L checkpoint")
    params: Dict = {
        "patch_embed": {
            "kernel": sd["patch_embed.proj.weight"]
            .transpose(2, 3, 1, 0).astype(np.float32),
            "bias": sd["patch_embed.proj.bias"].astype(np.float32)},
        "cls_token": sd["cls_token"].astype(np.float32),
    }
    storage = first("storage_tokens", "reg_token", "register_tokens")
    if storage is not None:
        params["storage_tokens"] = storage.astype(np.float32)
    periods = first("rope_embed.periods", "rope.periods")
    if periods is not None:
        params["rope_periods"] = periods.astype(np.float32)
    for i in range(depth):
        b = f"blocks.{i}"
        if f"{b}.attn.qkv.weight" in sd:
            qkv = _linear(sd, f"{b}.attn.qkv")
        else:  # timm Eva: split projections
            w = np.concatenate([sd[f"{b}.attn.{p}.weight"]
                                for p in ("q_proj", "k_proj", "v_proj")], 0)
            bias = np.concatenate(
                [sd.get(f"{b}.attn.{p}.bias",
                        np.zeros(w.shape[0] // 3, w.dtype))
                 for p in ("q_proj", "k_proj", "v_proj")], 0)
            qkv = {"kernel": w.T.astype(np.float32),
                   "bias": bias.astype(np.float32)}
        entry = {
            "norm1": _norm(sd, f"{b}.norm1"),
            "qkv": qkv,
            "proj": _linear(sd, f"{b}.attn.proj"),
            "norm2": _norm(sd, f"{b}.norm2"),
            "mlp_fc1": _linear(sd, f"{b}.mlp.fc1"),
            "mlp_fc2": _linear(sd, f"{b}.mlp.fc2"),
        }
        ls1 = first(f"{b}.ls1.gamma", f"{b}.gamma_1", f"{b}.ls1.weight")
        ls2 = first(f"{b}.ls2.gamma", f"{b}.gamma_2", f"{b}.ls2.weight")
        if ls1 is not None:
            entry["ls1"] = ls1.astype(np.float32)
        if ls2 is not None:
            entry["ls2"] = ls2.astype(np.float32)
        params[f"block{i}"] = entry
    return params


def merge_params(current: Dict, incoming: Dict, path: str = "") -> Dict:
    """``incoming`` overlaid on ``current``, every leaf's shape checked;
    a key ``current`` lacks raises."""
    out = dict(current)
    for k, v in incoming.items():
        here = f"{path}/{k}"
        if k not in current:
            raise KeyError(f"converted param {here} not in model tree "
                           f"(have: {sorted(current)[:8]}...)")
        if isinstance(v, dict):
            out[k] = merge_params(current[k], v, here)
        else:
            cur = np.asarray(current[k])
            if cur.shape != v.shape:
                raise ValueError(
                    f"shape mismatch at {here}: model {cur.shape} vs "
                    f"checkpoint {v.shape}")
            out[k] = v.astype(cur.dtype)
    return out


def _find_leaf(tree, key: str):
    """The first leaf named ``key``, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if str(k) == key and not isinstance(v, dict):
                return v
            found = _find_leaf(v, key)
            if found is not None:
                return found
    return None


def _swin_depths(sd) -> list:
    depths, stage = [], 0
    while any(k.startswith(f"layers.{stage}.blocks.") for k in sd):
        depths.append(1 + max(int(k.split(".")[3]) for k in sd
                              if k.startswith(f"layers.{stage}.blocks.")))
        stage += 1
    return depths


def load_pretrained_encoder(encoder_name: str, checkpoint_path: str,
                            current_params: Dict) -> Dict:
    """A local checkpoint converted and merged into an encoder tree in the
    JAX layout (``current_params``, e.g. ``port_params_as_jax_tree``'s);
    the Swin window, the ViT pos-embed grid and prefix tokens are read
    from its shapes."""
    sd = load_torch_state_dict(checkpoint_path)
    if encoder_name.startswith("swin") or (
            encoder_name.startswith("timm:") and "swin" in encoder_name):
        depths = _swin_depths(sd)
        if not depths:
            raise ValueError(
                f"{checkpoint_path}: no 'layers.N.blocks.*' keys — not a "
                "timm-format Swin state_dict")
        target_window = None
        bias = _find_leaf(current_params, "rel_pos_bias")
        if bias is not None:
            side = int(np.sqrt(np.asarray(bias).shape[-2]))
            target_window = (side + 1) // 2
        converted = convert_swin(sd, depths, target_window=target_window)
        return merge_params(current_params, converted)

    if encoder_name.startswith("vit") or "dino" in encoder_name or (
            encoder_name.startswith("timm:")):
        depth = sum(1 for k in sd if k.endswith(".norm1.weight")
                    and k.startswith("blocks."))
        target = current_params.get("backbone", current_params)
        if "cls_token" in target:  # the DINOv3 regime (RoPE, LayerScale)
            converted = convert_dinov3(sd, depth=depth or None)
            if "storage_tokens" in target and (
                    "storage_tokens" not in converted):
                raise ValueError(
                    "model has storage tokens but the checkpoint carries "
                    "none (storage_tokens/reg_token missing) — set "
                    "model.encoder.num_storage_tokens: 0 or pick a DINOv3 "
                    "checkpoint")
        else:
            keep_prefix = "prefix_tokens" in target
            pos = np.asarray(target["pos_embed"])
            n_prefix = (np.asarray(target["prefix_tokens"]).shape[1]
                        if keep_prefix else 0)
            converted = convert_vit(
                sd, depth=depth, keep_prefix_tokens=keep_prefix,
                target_grid=int(np.sqrt(pos.shape[1] - n_prefix)))
        if "backbone" in current_params:
            return dict(current_params, backbone=merge_params(
                current_params["backbone"], converted))
        return merge_params(current_params, converted)

    if encoder_name.startswith("resnet"):
        raise NotImplementedError(
            "loading a pretrained ResNet-50 is not ported to "
            "fmc_uia_tpu_torch yet: the port has no ResNet encoder "
            "(ROADMAP.md, port queue item 'Other encoders')")
    raise ValueError(f"No converter for encoder {encoder_name!r}")


def load_pretrained_into(encoder: torch.nn.Module, encoder_name: str,
                         checkpoint_path: str) -> None:
    """Load a local checkpoint into a port encoder, in place: its
    parameters read as a JAX-layout tree, the checkpoint merged over them
    (``load_pretrained_encoder``) and the result written back through the
    bridge."""
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(
            f"model.encoder.pretrained={checkpoint_path!r} not found; "
            "expect a local timm-format torch checkpoint (.pth/.bin)")
    tree = load_pretrained_encoder(encoder_name, checkpoint_path,
                                   port_params_as_jax_tree(encoder))
    leaves = jax_leaves_to_port(tree)
    with torch.no_grad():
        for name, p in encoder.named_parameters():
            p.copy_(torch.from_numpy(leaves[name]))


# ---------------------------------------------------------------------------
# checkpoint verification (python -m fmc_uia_tpu_torch.utils.convert --verify)
# ---------------------------------------------------------------------------
def _detect_family(sd: Dict[str, np.ndarray]) -> str:
    keys = set(sd)
    if any(k.startswith("layers.") and ".blocks." in k for k in keys):
        return "swin"
    if ("rope_embed.periods" in keys or "storage_tokens" in keys
            or "reg_token" in keys
            or any(k.endswith(("ls1.gamma", "gamma_1")) for k in keys)):
        return "dinov3"
    if any(k.startswith("blocks.") for k in keys):
        return "vit"
    if "layer1.0.conv1.weight" in keys:
        return "resnet50"
    raise ValueError(f"cannot detect model family from keys like "
                     f"{sorted(keys)[:6]}")


def _infer_geometry(sd: Dict[str, np.ndarray], family: str) -> Dict:
    if family == "swin":
        depths = _swin_depths(sd)
        embed = sd["patch_embed.proj.weight"].shape[0]
        heads = []
        for s in range(len(depths)):
            tbl = sd.get(f"layers.{s}.blocks.0.attn."
                         "relative_position_bias_table")
            heads.append(int(tbl.shape[1]) if tbl is not None
                         else max(1, (embed * 2 ** s) // 32))
        n_bias = sd["layers.0.blocks.0.attn."
                    "relative_position_bias_table"].shape[0]
        return dict(embed_dim=embed, depths=tuple(depths),
                    num_heads=tuple(heads),
                    window=(int(np.sqrt(n_bias)) + 1) // 2)
    if family in ("vit", "dinov3"):
        depth = 1 + max(int(k.split(".")[1]) for k in sd
                        if k.startswith("blocks.")
                        and k.split(".")[1].isdigit())
        w = sd["patch_embed.proj.weight"]
        embed, patch = w.shape[0], w.shape[-1]
        if "rope_embed.periods" in sd:  # head_dim = 4 * len(periods)
            heads = embed // (4 * sd["rope_embed.periods"].shape[0])
        else:
            heads = max(1, embed // 64)
        storage = 0
        for k in ("storage_tokens", "reg_token", "register_tokens"):
            if k in sd:
                storage = sd[k].shape[1]
        return dict(embed_dim=embed, depth=depth, patch=patch,
                    num_heads=heads, num_storage_tokens=storage)
    return {}


def _manifest_check(sd, family: str, geo: Dict) -> bool:
    """The checkpoint's keys and shapes against the manifest of its
    family; prints the differences."""
    from fmc_uia_tpu_torch.utils import timm_manifests as M

    if family == "swin":
        layout = ("old" if any(k.startswith("layers.0.downsample")
                               for k in sd) else "new")
        head = sd.get("head.fc.weight", sd.get("head.weight"))
        manifest = M.swin_manifest(
            geo["embed_dim"], geo["depths"], geo["num_heads"], geo["window"],
            num_classes=int(head.shape[0]) if head is not None else 0,
            layout=layout)
    elif family == "vit":
        g = int(np.sqrt(sd["pos_embed"].shape[1] - 1))
        head = sd.get("head.weight")
        manifest = M.vit_manifest(
            geo["embed_dim"], geo["depth"], geo["patch"],
            img_size=g * geo["patch"],
            num_classes=int(head.shape[0]) if head is not None else 0)
    elif family == "dinov3":
        manifest = M.dinov3_manifest(
            geo["embed_dim"], geo["depth"], geo["num_heads"], geo["patch"],
            geo["num_storage_tokens"])
    else:
        manifest = M.resnet50_manifest(
            num_classes=int(sd["fc.weight"].shape[0]) if "fc.weight" in sd
            else 1000)
    missing = sorted(set(manifest) - set(sd))
    extra = sorted(set(sd) - set(manifest))
    mismatched = sorted(k for k in set(manifest) & set(sd)
                        if tuple(sd[k].shape) != tuple(manifest[k]))
    if missing and all(k.startswith(("head.", "fc.")) for k in missing):
        print(f"[verify] headless checkpoint (no {missing}) — fine for "
              "backbone import")
        missing = []
    ok = True
    for label, diff in (("missing-vs-manifest", missing),
                        ("shape-mismatch", mismatched)):
        if diff:
            ok = False
            print(f"[verify] FAIL {label}: {diff[:12]}"
                  f"{' ...' if len(diff) > 12 else ''}")
    if extra:
        print(f"[verify] note: {len(extra)} checkpoint keys outside the "
              f"manifest (first: {extra[:6]}) — dropped by conversion")
    if ok:
        print(f"[verify] manifest OK: {len(manifest)} keys matched")
    return ok


def verify_checkpoint(path: str, encoder_name: Optional[str] = None,
                      image_size: int = 224, device="cuda") -> bool:
    """Check a checkpoint file end to end on the port: (1) its family and
    geometry, (2) its keys and shapes against the manifest, (3) convert
    and load it into a port encoder of that geometry (every shape
    checked), (4) a forward on ``device`` (finite outputs), (5) where timm
    is installed, the forward against timm's. True when every step
    passes."""
    from fmc_uia_tpu_torch.device import resolve_device
    from fmc_uia_tpu_torch.models.encoders.swin import SwinEncoder
    from fmc_uia_tpu_torch.models.encoders.vit import ViTBackbone
    from fmc_uia_tpu_torch.models.layers import init_weights
    from fmc_uia_tpu_torch.ops.swin_block import MAX_WINDOW

    dev = resolve_device(device)
    sd = load_torch_state_dict(path)
    family = _detect_family(sd)
    geo = _infer_geometry(sd, family)
    print(f"[verify] {path}: family={family} geometry={geo}")
    if family == "resnet50":
        print("[verify] FAIL: the ResNet-50 converter is not ported "
              "(ROADMAP.md, port queue item 'Other encoders')")
        return False
    ok = _manifest_check(sd, family, geo)

    name = encoder_name or {"swin": "swin_custom", "vit": "vit_b",
                            "dinov3": "dinov3"}[family]
    window = geo.get("window")
    if family == "swin":
        if dev.type == "cuda" and window > MAX_WINDOW:
            window = MAX_WINDOW
            print(f"[verify] window {geo['window']} > "
                  f"{MAX_WINDOW}, the largest the Swin kernels "
                  f"take: the encoder is built at window {window}, the "
                  f"relative-position tables resampled")
        enc = SwinEncoder(embed_dim=geo["embed_dim"], depths=geo["depths"],
                          num_heads=geo["num_heads"], window_size=window,
                          drop_path_rate=0.0)
    else:
        rope = family == "dinov3"
        enc = ViTBackbone(
            embed_dim=geo["embed_dim"], depth=geo["depth"],
            num_heads=geo["num_heads"], patch_size=geo["patch"],
            out_indices=(geo["depth"] - 1,), rope=rope,
            num_prefix_tokens=0 if rope else 1,
            num_storage_tokens=geo["num_storage_tokens"], layerscale=rope)
        g = image_size // geo["patch"]
        enc.make_pos_embed(g, g)
    init_weights(enc, torch.Generator().manual_seed(0))
    try:
        load_pretrained_into(enc, name, path)
        print("[verify] convert+merge OK")
    except Exception as e:  # noqa: BLE001 — report, don't crash the CLI
        print(f"[verify] FAIL convert+merge: {e}")
        return False
    enc = enc.to(dev).eval()
    x = np.random.RandomState(0).rand(
        1, image_size, image_size, 3).astype(np.float32)
    with torch.no_grad():
        outs = enc(torch.from_numpy(x).to(dev))
    outs = [o.float().cpu() for o in outs]
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    print(f"[verify] forward with loaded weights on {dev}: "
          f"{'finite OK' if finite else 'FAIL (non-finite outputs)'} "
          f"shapes={[tuple(o.shape) for o in outs]}")
    ok = ok and finite

    import importlib.util

    if importlib.util.find_spec("timm") is not None and family in (
            "swin", "vit") and window == geo.get("window"):
        import timm

        tname = {"swin": f"swin_base_patch4_window{geo['window']}_224",
                 "vit": f"vit_base_patch{geo['patch']}_224"}[family]
        try:
            tm = timm.create_model(tname, pretrained=False,
                                   features_only=(family == "swin"))
            tm.load_state_dict({k: torch.from_numpy(v)
                                for k, v in sd.items()}, strict=False)
            with torch.no_grad():
                tout = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
            t_last = (tout[-1] if isinstance(tout, (list, tuple))
                      else tout).numpy()
            o_last = outs[-1].numpy()
            if t_last.ndim == 4 and t_last.shape[1] == o_last.shape[-1]:
                t_last = t_last.transpose(0, 2, 3, 1)
            close = np.allclose(o_last.reshape(-1), t_last.reshape(-1),
                                atol=1e-3, rtol=5e-3)
            print(f"[verify] timm oracle: "
                  f"{'parity OK' if close else 'FAIL (diverged)'}")
            ok = ok and close
        except Exception as e:  # noqa: BLE001
            print(f"[verify] timm oracle skipped ({e})")
    else:
        print("[verify] timm not installed — structural + finite checks "
              "only (re-run where timm exists for full numeric parity)")
    print(f"[verify] RESULT: {'PASS' if ok else 'FAIL'}")
    return ok


def _main() -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Pretrained-checkpoint utilities of the port")
    ap.add_argument("--verify", metavar="FILE",
                    help="check a checkpoint file against the manifests, "
                         "load it into a port encoder and run a forward")
    ap.add_argument("--encoder", default=None,
                    help="override the detected encoder name")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if not args.verify:
        ap.error("nothing to do: pass --verify FILE")
    return 0 if verify_checkpoint(args.verify, args.encoder,
                                  args.image_size, args.device) else 1


if __name__ == "__main__":
    raise SystemExit(_main())
