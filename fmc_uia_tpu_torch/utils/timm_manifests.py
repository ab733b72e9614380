"""timm ``state_dict`` key/shape manifests (the port's copy of
``fmc_uia_tpu/utils/timm_manifests.py``; numpy-free, no import of the JAX
package).

These are the parameter names and shapes of the timm models the presets
start from, transcribed from timm's module definitions
(``timm/models/swin_transformer.py``, ``timm/models/vision_transformer.py``)
and from the facebookresearch/dinov3 release naming. They pin the naming
contract of ``utils/convert.py`` independently of the converters, and
``python -m fmc_uia_tpu_torch.utils.convert --verify FILE`` diffs a
checkpoint file against them. The tests and ``chip_smoke.py`` build
synthetic state dicts from them.

Two Swin layouts exist and both are covered:
  * ``old`` (before timm 0.9, and the original Microsoft release):
    PatchMerging at the END of the stage it follows ->
    ``layers.{0,1,2}.downsample``.
  * ``new`` (timm >= 0.9): PatchMerging at the START of the stage it
    feeds -> ``layers.{1,2,3}.downsample``.

DINOv3 (``vit_large_patch16_dinov3.lvd1689m``): ``dinov3_manifest`` pins
the facebookresearch/dinov3 naming (cls_token / storage_tokens /
rope_embed.periods / blocks.N.{ls1,ls2}.gamma); ``convert_dinov3`` also
takes timm's Eva aliases (reg_token, gamma_1/2, split q/k/v projections).
"""

from __future__ import annotations

from typing import Dict, Tuple

Shape = Tuple[int, ...]


def swin_manifest(embed_dim: int = 128,
                  depths=(2, 2, 18, 2),
                  num_heads=(4, 8, 16, 32),
                  window: int = 7,
                  num_classes: int = 1000,
                  layout: str = "new") -> Dict[str, Shape]:
    """timm SwinTransformer state_dict manifest.

    Defaults = ``swin_base_patch4_window7_224``.
    """
    assert layout in ("old", "new")
    m: Dict[str, Shape] = {
        "patch_embed.proj.weight": (embed_dim, 3, 4, 4),
        "patch_embed.proj.bias": (embed_dim,),
        "patch_embed.norm.weight": (embed_dim,),
        "patch_embed.norm.bias": (embed_dim,),
    }
    n_bias = (2 * window - 1) ** 2
    for s, depth in enumerate(depths):
        c = embed_dim * (2 ** s)
        h = num_heads[s]
        for b in range(depth):
            base = f"layers.{s}.blocks.{b}"
            m[f"{base}.norm1.weight"] = (c,)
            m[f"{base}.norm1.bias"] = (c,)
            m[f"{base}.attn.relative_position_bias_table"] = (n_bias, h)
            # registered buffer, present in saved checkpoints
            m[f"{base}.attn.relative_position_index"] = (
                window * window, window * window)
            m[f"{base}.attn.qkv.weight"] = (3 * c, c)
            m[f"{base}.attn.qkv.bias"] = (3 * c,)
            m[f"{base}.attn.proj.weight"] = (c, c)
            m[f"{base}.attn.proj.bias"] = (c,)
            m[f"{base}.norm2.weight"] = (c,)
            m[f"{base}.norm2.bias"] = (c,)
            m[f"{base}.mlp.fc1.weight"] = (4 * c, c)
            m[f"{base}.mlp.fc1.bias"] = (4 * c,)
            m[f"{base}.mlp.fc2.weight"] = (c, 4 * c)
            m[f"{base}.mlp.fc2.bias"] = (c,)
        # PatchMerging between stage s and s+1: norm over 4*C_s then
        # Linear(4*C_s -> 2*C_s, bias=False)
        if s < len(depths) - 1:
            ds = (f"layers.{s}.downsample" if layout == "old"
                  else f"layers.{s + 1}.downsample")
            m[f"{ds}.norm.weight"] = (4 * c,)
            m[f"{ds}.norm.bias"] = (4 * c,)
            m[f"{ds}.reduction.weight"] = (2 * c, 4 * c)
    c_last = embed_dim * (2 ** (len(depths) - 1))
    m["norm.weight"] = (c_last,)
    m["norm.bias"] = (c_last,)
    if layout == "old":
        m["head.weight"] = (num_classes, c_last)
        m["head.bias"] = (num_classes,)
    else:
        m["head.fc.weight"] = (num_classes, c_last)
        m["head.fc.bias"] = (num_classes,)
    return m


def vit_manifest(embed_dim: int = 768, depth: int = 12,
                 patch: int = 16, img_size: int = 224,
                 num_classes: int = 1000) -> Dict[str, Shape]:
    """timm VisionTransformer state_dict manifest.

    Defaults = ``vit_base_patch16_224``: cls token + learned pos-embed over
    (img/patch)^2 + 1 rows, 12 pre-norm blocks, final LayerNorm, linear head.
    """
    g = img_size // patch
    m: Dict[str, Shape] = {
        "cls_token": (1, 1, embed_dim),
        "pos_embed": (1, g * g + 1, embed_dim),
        "patch_embed.proj.weight": (embed_dim, 3, patch, patch),
        "patch_embed.proj.bias": (embed_dim,),
    }
    for i in range(depth):
        base = f"blocks.{i}"
        m[f"{base}.norm1.weight"] = (embed_dim,)
        m[f"{base}.norm1.bias"] = (embed_dim,)
        m[f"{base}.attn.qkv.weight"] = (3 * embed_dim, embed_dim)
        m[f"{base}.attn.qkv.bias"] = (3 * embed_dim,)
        m[f"{base}.attn.proj.weight"] = (embed_dim, embed_dim)
        m[f"{base}.attn.proj.bias"] = (embed_dim,)
        m[f"{base}.norm2.weight"] = (embed_dim,)
        m[f"{base}.norm2.bias"] = (embed_dim,)
        m[f"{base}.mlp.fc1.weight"] = (4 * embed_dim, embed_dim)
        m[f"{base}.mlp.fc1.bias"] = (4 * embed_dim,)
        m[f"{base}.mlp.fc2.weight"] = (embed_dim, 4 * embed_dim)
        m[f"{base}.mlp.fc2.bias"] = (embed_dim,)
    m["norm.weight"] = (embed_dim,)
    m["norm.bias"] = (embed_dim,)
    m["head.weight"] = (num_classes, embed_dim)
    m["head.bias"] = (num_classes,)
    return m


def dinov3_manifest(embed_dim: int = 1024, depth: int = 24,
                    num_heads: int = 16, patch: int = 16,
                    num_storage_tokens: int = 4,
                    mlp_ratio: int = 4) -> Dict[str, Shape]:
    """facebookresearch/dinov3 backbone state_dict manifest.

    Defaults = ``dinov3_vitl16`` (the reference's flagship encoder,
    reference configs/config.yaml:17-21 via timm
    ``vit_large_patch16_dinov3.lvd1689m``). Architecture: patch embed,
    cls token + ``num_storage_tokens`` storage (register) tokens, NO
    absolute pos-embed (axial RoPE only — the realized rotation periods
    ship as the ``rope_embed.periods`` buffer, head_dim//4 entries),
    pre-norm blocks with LayerScale on both branches, plain MLP FFN for
    the S/B/L sizes, final LayerNorm, ``mask_token`` for masked-image
    modeling. See module docstring for offline-provenance caveats.
    """
    dh = embed_dim // num_heads
    m: Dict[str, Shape] = {
        "cls_token": (1, 1, embed_dim),
        "storage_tokens": (1, num_storage_tokens, embed_dim),
        "mask_token": (1, embed_dim),
        "patch_embed.proj.weight": (embed_dim, 3, patch, patch),
        "patch_embed.proj.bias": (embed_dim,),
        "rope_embed.periods": (dh // 4,),
    }
    hidden = mlp_ratio * embed_dim
    for i in range(depth):
        base = f"blocks.{i}"
        m[f"{base}.norm1.weight"] = (embed_dim,)
        m[f"{base}.norm1.bias"] = (embed_dim,)
        m[f"{base}.attn.qkv.weight"] = (3 * embed_dim, embed_dim)
        m[f"{base}.attn.qkv.bias"] = (3 * embed_dim,)
        m[f"{base}.attn.proj.weight"] = (embed_dim, embed_dim)
        m[f"{base}.attn.proj.bias"] = (embed_dim,)
        m[f"{base}.ls1.gamma"] = (embed_dim,)
        m[f"{base}.norm2.weight"] = (embed_dim,)
        m[f"{base}.norm2.bias"] = (embed_dim,)
        m[f"{base}.mlp.fc1.weight"] = (hidden, embed_dim)
        m[f"{base}.mlp.fc1.bias"] = (hidden,)
        m[f"{base}.mlp.fc2.weight"] = (embed_dim, hidden)
        m[f"{base}.mlp.fc2.bias"] = (embed_dim,)
        m[f"{base}.ls2.gamma"] = (embed_dim,)
    m["norm.weight"] = (embed_dim,)
    m["norm.bias"] = (embed_dim,)
    return m


def resnet50_manifest(num_classes: int = 1000) -> Dict[str, Shape]:
    """torchvision/timm ResNet-50 state_dict manifest (BatchNorm layout).

    Note the conversion caveat: our encoder is GroupNorm (batch-independent
    under single-task round-robin batches); ``convert_resnet50`` folds BN
    affine into GN scale/bias and DROPS running statistics, which changes
    normalization semantics — load_pretrained_encoder warns loudly.
    """
    m: Dict[str, Shape] = {
        "conv1.weight": (64, 3, 7, 7),
        "bn1.weight": (64,), "bn1.bias": (64,),
        "bn1.running_mean": (64,), "bn1.running_var": (64,),
    }
    widths = (64, 128, 256, 512)
    for stage, blocks in enumerate((3, 4, 6, 3)):
        w = widths[stage]
        c_in = 64 if stage == 0 else widths[stage - 1] * 4
        for b in range(blocks):
            base = f"layer{stage + 1}.{b}"
            cin_b = c_in if b == 0 else w * 4
            m[f"{base}.conv1.weight"] = (w, cin_b, 1, 1)
            m[f"{base}.conv2.weight"] = (w, w, 3, 3)
            m[f"{base}.conv3.weight"] = (w * 4, w, 1, 1)
            for i, ch in ((1, w), (2, w), (3, w * 4)):
                m[f"{base}.bn{i}.weight"] = (ch,)
                m[f"{base}.bn{i}.bias"] = (ch,)
                m[f"{base}.bn{i}.running_mean"] = (ch,)
                m[f"{base}.bn{i}.running_var"] = (ch,)
            if b == 0:
                m[f"{base}.downsample.0.weight"] = (w * 4, cin_b, 1, 1)
                m[f"{base}.downsample.1.weight"] = (w * 4,)
                m[f"{base}.downsample.1.bias"] = (w * 4,)
                m[f"{base}.downsample.1.running_mean"] = (w * 4,)
                m[f"{base}.downsample.1.running_var"] = (w * 4,)
    m["fc.weight"] = (num_classes, 2048)
    m["fc.bias"] = (num_classes,)
    return m
