"""The flagship configuration as a Python dict: ``configs/config.yaml``
with the overrides of ``bench.py`` (build_bench) and ``bench_serving.py``
— swin_b at 512², window 8, bf16 compute with f32 params, ``ln_bf16``,
``scan_stages [0, 1, 3]``, fused attention and MLP branches, separate det
FPN, TaskFiLM, 27 tasks.

``dino_patch8_config_dict`` is the DINOv3 ViT-B patch-8 preset
(``configs/Dino_resize_patch8.yaml``) with the train batch of 24.
``submit_config_dict`` and ``baseline_config_dict`` are
``configs/submit.yaml`` and ``configs/baseline.yaml`` as they stand: swin_b
at 224², window 7, B = 64, the MoE at stages 2-3, adaptive loss weights.
``dinov3_spm_config_dict`` is ``configs/vit_large_patch16_dinov3.yaml`` as
it stands: DINOv3 ViT-L/16 at 224² with the SPM-interaction adapter.
``ablation_a_config_dict`` and ``ablation_b_config_dict`` are the
flagship with its off-main-path options turned on (every width, depth
and the image size kept): deep supervision, the grid head, multi-stage
embedding FiLM, an additive task prompt, SmoothL1, SGD and accumulation
(A); the baseline heads, the UNet-like seg head, embedding FiLM, a
multiplicative prompt, L1 and Adam (B).
``flagship_with_encoder`` is the flagship with another ``model.encoder``
(every other key kept); ``ENCODER_PRESETS`` holds the encoders of ROADMAP
queue 1 item 8 at full width: ResNet-50, ConvNeXt-B (``timm:`` name),
EfficientNet-B4, and the flagship's swin_b with the fused attention on
stages 0-1 only or on none (``fused_block: false``).

Dicts and not the YAML files, because the GPU machine may lack PyYAML
(tests/test_torch_isolation.py and tests/test_torch_moe.py hold them
equal).
"""

from __future__ import annotations

import copy

_TASKS = [
    ("T2A_fetal_abdomen", "segmentation", 2),
    ("T2A_fetal_brain", "segmentation", 2),
    ("T2A_fetal_femur", "segmentation", 2),
    ("T2A_fetal_thorax", "segmentation", 2),
    ("T2B_adult_liver_segment_2", "segmentation", 2),
    ("T2B_adult_liver_segment_3", "segmentation", 2),
    ("T2B_adult_liver_segment_4a", "segmentation", 2),
    ("T2B_adult_liver_segment_5", "segmentation", 2),
    ("T2B_adult_liver_segment_6", "segmentation", 2),
    ("T2B_adult_liver_segment_7", "segmentation", 2),
    ("T2B_adult_liver_segment_8", "segmentation", 2),
    ("T2C_fetal_head", "segmentation", 2),
    ("T1_fetal_planes", "classification", 6),
    ("T3A_breast_lymph_nodes", "classification", 2),
    ("T3A_breast_tumor", "classification", 2),
    ("T3B_liver_injury", "classification", 2),
    ("T3B_liver_steatosis", "classification", 2),
    ("T3C_thyroid_nodule", "classification", 2),
    ("T3D_liver_cirrhosis", "classification", 2),
    ("T3D_liver_fibrosis", "classification", 2),
    ("T3E_thyroid_cancer", "classification", 2),
    ("T4A_fetal_abdomen", "detection", 1),
    ("T4A_fetal_brain", "detection", 1),
    ("T4A_fetal_femur", "detection", 1),
    ("T5_fetal_abdomen", "Regression", 4),
    ("T5_fetal_brain", "Regression", 4),
    ("T5_fetal_femur", "Regression", 4),
]

# one task of each type, as bench_serving.py sends them
SERVING_TASKS = ("T2A_fetal_abdomen", "T1_fetal_planes", "T4A_fetal_brain",
                 "T5_fetal_femur")

_FLAGSHIP = {
    "experiment": {"name": "swin_b_multitask_tpu", "seed": 42,
                   "output_dir": "outputs/swin_b_multitask_tpu",
                   "save_checkpoints": True, "checkpoint_freq": 10},
    "data": {
        "root_path": "data/train", "val_split": 0.2, "batch_size": 24,
        "num_workers": 4, "pin_memory": True, "image_size": 512,
        "augmentation": {
            "train": {"random_brightness_contrast": 0.2,
                      "gauss_noise": 0.1, "horizontal_flip": 0.0,
                      "vertical_flip": 0.0},
            "normalize": {"mean": [0.330189, 0.330189, 0.330189],
                          "std": [0.178211, 0.178211, 0.178211]}},
        "fused_preprocess": False},
    "model": {
        "moe": {"enabled": False, "num_experts": 8, "top_k": 2,
                "stage_indices": [2, 3], "expert_hidden": 256,
                "router_hidden": 256, "balance_loss_weight": 0.05,
                "use_task_embedding": True, "task_embedding_dim": 64,
                "use_residual": True, "dropout": 0.0},
        "encoder": {"name": "swin_b", "pretrained": None,
                    "drop_path_rate": 0.1, "window_size": 8,
                    "softmax_bf16": True, "ln_bf16": True,
                    "scan_stages": [0, 1, 3], "remat": False,
                    "remat_policy": "full", "fused_block": True,
                    "fused_mlp": True},
        "decoder": {"type": "fpn", "pyramid_channels": 256,
                    "segmentation_channels": 128, "dropout": 0.1,
                    "merge_policy": "cat", "separate_detection_fpn": True,
                    "separate_classification_fpn": False,
                    "separate_regression_fpn": False,
                    "use_fpn_for_classification": False,
                    "use_fpn_for_regression": False},
        "use_film": True,
        "film": {"use_task_embedding": False, "embedding_dim": 64,
                 "use_affine": True},
        "task_prompt": {"enabled": False, "channels": 1, "prompt_size": 32,
                        "inject_mode": "add", "init_scale": 0.1,
                        "use_tanh": True},
        "heads": {
            "segmentation": {"type": "default", "upsampling": 4,
                             "mid_channels": 128, "num_blocks": 2,
                             "use_deep_supervision": False,
                             "num_aux_outputs": 3,
                             "aux_loss_weights": [0.5, 0.3, 0.2]},
            "classification": {"mid_channels": 256, "dropout": 0.3},
            "detection": {"mid_channels": 128, "type": "centernet",
                          "num_anchors": 1},
            "regression": {"hidden_dims": [256, 128], "use_tanh": True,
                           "mid_channels": 256, "dropout": 0.3}}},
    "training": {
        "num_epochs": 50, "steps_per_epoch": None,
        "single_task": {"enabled": False, "task_id": "", "task_name": ""},
        "optimizer": {"type": "AdamW", "learning_rate": 1.0e-4,
                      "weight_decay": 1.0e-4, "use_grouped_lr": True,
                      "encoder_lr_multiplier": 0.1,
                      "head_lr_multiplier": 1.0},
        "scheduler": {"type": "CosineAnnealingLR", "T_max": 50,
                      "eta_min": 1.0e-6},
        "loss_weights": {"segmentation": 1.0, "classification": 1.0,
                         "detection": 2.0, "regression": 1.0},
        "adaptive_loss": {"enabled": False, "init_log_vars": -1.0,
                          "learning_rate": 1.0e-4, "warmup_epochs": 15},
        "loss_configs": {
            "segmentation": {"type": "DiceLoss", "mode": "multiclass"},
            "classification": {"type": "CrossEntropyLoss"},
            "detection": {"type": "CenterNet", "heatmap_alpha": 2.0,
                          "heatmap_gamma": 4.0, "size_weight": 1.0,
                          "offset_weight": 1.0,
                          "classification_weight": 2.0,
                          "box_regression_weight": 1.0},
            "regression": {"type": "MSELoss"}},
        "gradient_clip": 1.0, "print_freq": 50, "log_metrics": True},
    "validation": {"enabled": True, "freq": 1, "save_best_model": True,
                   "metric_for_best": "mean_score"},
    "device": {"use_cuda": True, "multi_gpu": True, "device_ids": [],
               "mixed_precision": True},
    "parallel": {"mesh_axes": ["data"], "data_axis": "data"},
    "tasks": [{"task_id": t, "task_name": n, "num_classes": c}
              for t, n, c in _TASKS],
}


def flagship_config_dict() -> dict:
    """A fresh copy of the flagship configuration."""
    return copy.deepcopy(_FLAGSHIP)


def dino_patch8_config_dict() -> dict:
    """``configs/Dino_resize_patch8.yaml`` as a dict (the DINOv3 ViT-B
    patch-8 preset at 512²: 4,101 tokens, RoPE, LayerScale, 'resize'
    adapter, frozen backbone; the flagship's FPN, TaskFiLM and 27 heads),
    with two overrides: ``data.batch_size`` 24, the flagship's train batch
    (the YAML's 64 would need more memory for saved activations than the
    card's 80 GB), and ``data.fused_preprocess`` false."""
    d = flagship_config_dict()
    d["experiment"].update(name="dinov3_resize_patch8_512",
                           output_dir="outputs/dino_resize_patch8")
    d["model"]["encoder"] = {
        "name": "dinov3", "timm_name": "vit_base_patch8_dinov3",
        "pretrained": None, "freeze_dino": True,
        "out_indices": [2, 5, 8, 11],
        "adapter": {"type": "resize", "channels": 256}}
    return d


def submit_config_dict() -> dict:
    """``configs/submit.yaml`` as a dict: the flagship's model with the
    dense MoE (8 experts, top-2, ``expert_hidden`` and ``router_hidden``
    256, a 64-wide task embedding, stages 2 and 3, balance weight 0.05),
    swin_b at its defaults (window 7, no TPU overrides) at 224², B = 64,
    adaptive loss weights, 100 epochs."""
    d = flagship_config_dict()
    d["experiment"].update(name="submit_swin_b", output_dir="outputs/submit",
                           checkpoint_freq=5)
    d["data"].update(batch_size=64, image_size=224)
    del d["data"]["fused_preprocess"]
    d["model"]["moe"]["enabled"] = True
    d["model"]["encoder"] = {"name": "swin_b", "pretrained": None,
                             "drop_path_rate": 0.1}
    d["training"]["num_epochs"] = 100
    d["training"]["scheduler"]["T_max"] = 100
    d["training"]["adaptive_loss"]["enabled"] = True
    return d


def baseline_config_dict() -> dict:
    """``configs/baseline.yaml`` as a dict: ``submit_config_dict`` with
    separate cls and reg FPNs that those heads read."""
    d = submit_config_dict()
    d["experiment"].update(name="baseline_swin_b_moe_adaptive",
                           output_dir="outputs/baseline", checkpoint_freq=10)
    d["model"]["decoder"].update(
        separate_classification_fpn=True, separate_regression_fpn=True,
        use_fpn_for_classification=True, use_fpn_for_regression=True)
    return d


def dinov3_spm_config_dict() -> dict:
    """``configs/vit_large_patch16_dinov3.yaml`` as a dict, with no
    override: DINOv3 ViT-L/16 (1024 wide, depth 24, 16 heads, out_indices
    5/11/17/23; RoPE, LayerScale, 4 storage tokens), ``freeze_dino``, the
    'spm_interaction' adapter (256 channels, stem 64, 8 heads, 4 points,
    offset range 0.25), the flagship's FPN (separate det FPN), TaskFiLM
    and 27 heads, B = 64 at 224² (14² patches + 5 prefix tokens = 201
    tokens: below ``FLASH_MIN_TOKENS``, so the einsum attention path).
    ``data.fused_preprocess`` is absent (off), as in the YAML; a caller
    that trains with K3 sets it."""
    d = flagship_config_dict()
    d["experiment"].update(name="dinov3_large_spm_interaction",
                           output_dir="outputs/dinov3_spm")
    d["data"].update(batch_size=64, image_size=224)
    del d["data"]["fused_preprocess"]
    d["model"]["encoder"] = {
        "name": "dinov3", "timm_name": "vit_large_patch16_dinov3.lvd1689m",
        "pretrained": None, "freeze_dino": True,
        "out_indices": [5, 11, 17, 23],
        "adapter": {"type": "spm_interaction", "channels": 256,
                    "spm_stem_channels": 64, "interaction_heads": 8,
                    "interaction_points": 4,
                    "interaction_offset_range": 0.25}}
    return d


def ablation_a_config_dict() -> dict:
    """The flagship with: a deep-supervision seg head (3 aux outputs,
    weights 0.5/0.3/0.2), the grid detection head with its loss
    (``Detection``), ``TaskEmbeddingFiLM`` on the FPN and on every encoder
    stage (``film.multi_stage``), an additive task prompt on the seg and
    det inputs, the SmoothL1 regression loss, SGD with momentum 0.9 and
    ``training.accumulation_steps`` 2. The regression loss is set under
    ``loss_configs.Regression``, the key the loss lookup reads (the task
    type; the lower-case ``regression`` key is not read, in the JAX
    package either), and mirrored under ``regression``."""
    d = flagship_config_dict()
    d["experiment"].update(name="swin_b_ablation_a",
                           output_dir="outputs/ablation_a")
    m = d["model"]
    m["heads"]["segmentation"]["use_deep_supervision"] = True
    m["heads"]["detection"]["type"] = "grid"
    m["film"].update(use_task_embedding=True, multi_stage=True)
    m["task_prompt"].update(enabled=True, inject_mode="add",
                            apply_to_task_names=["segmentation",
                                                 "detection"])
    t = d["training"]
    t["loss_configs"]["detection"]["type"] = "Detection"
    t["loss_configs"]["regression"] = {"type": "SmoothL1Loss"}
    t["loss_configs"]["Regression"] = {"type": "SmoothL1Loss"}
    t["optimizer"].update(type="SGD", momentum=0.9)
    t["accumulation_steps"] = 2
    return d


def ablation_b_config_dict() -> dict:
    """The flagship with: ``model.heads.use_baseline`` (the baseline cls,
    grid det and reg banks; det loss ``Detection``), the UNet-like seg
    head, a single-stage ``TaskEmbeddingFiLM``, a multiplicative task
    prompt on every task type, the L1 regression loss (under
    ``Regression``, mirrored under ``regression``, as in
    ``ablation_a_config_dict``) and Adam (no weight decay, as optax's
    ``scale_by_adam``)."""
    d = flagship_config_dict()
    d["experiment"].update(name="swin_b_ablation_b",
                           output_dir="outputs/ablation_b")
    m = d["model"]
    m["heads"]["use_baseline"] = True
    m["heads"]["segmentation"]["type"] = "unet_like"
    m["film"].update(use_task_embedding=True, multi_stage=False)
    m["task_prompt"].update(enabled=True, inject_mode="mul")
    t = d["training"]
    t["loss_configs"]["detection"]["type"] = "Detection"
    t["loss_configs"]["regression"] = {"type": "L1Loss"}
    t["loss_configs"]["Regression"] = {"type": "L1Loss"}
    t["optimizer"]["type"] = "Adam"
    return d


def flagship_with_encoder(encoder: dict) -> dict:
    """The flagship dict (512², 27 tasks, bf16, TaskFiLM, B = 24) with
    ``model.encoder`` replaced by a copy of ``encoder``."""
    d = flagship_config_dict()
    d["model"]["encoder"] = copy.deepcopy(encoder)
    return d


_SWIN_B = _FLAGSHIP["model"]["encoder"]

# the encoders of the item-8 presets, by preset name
ENCODER_PRESETS = {
    "resnet50": {"name": "resnet50", "pretrained": None},
    "convnext_base": {"name": "timm:convnext_base", "pretrained": None,
                      "drop_path_rate": 0.1},
    "efficientnet_b4": {"name": "efficientnet-b4", "pretrained": None},
    "swin_b_fused01": dict(_SWIN_B, fused_stages=[0, 1]),
    "swin_b_unfused": dict(_SWIN_B, fused_block=False),
}
