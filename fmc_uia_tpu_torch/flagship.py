"""The flagship configuration as a Python dict: ``configs/config.yaml``
with the overrides of ``bench.py`` (build_bench) and ``bench_serving.py``
— swin_b at 512², window 8, bf16 compute with f32 params, ``ln_bf16``,
``scan_stages [0, 1, 3]``, fused attention and MLP branches, separate det
FPN, TaskFiLM, 27 tasks.

A dict and not the YAML file, because the GPU machine may lack PyYAML
(tests/test_torch_isolation.py holds the two equal).
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
