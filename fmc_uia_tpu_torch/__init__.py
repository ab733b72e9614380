"""fmc_uia_tpu_torch — the PyTorch/CUDA port of fmc_uia_tpu for NVIDIA
Hopper (H100).

A package of its own beside the JAX package, which stays the reference:
it imports ``torch`` and never ``jax``, ``flax`` or ``fmc_uia_tpu``. The
Pallas TPU kernels on its path are CUDA C++ kernels written by hand for
``sm_90a`` (``csrc/``), built by ``nvcc`` on first CUDA use
(``ops/build.py``). Entry points take ``device`` (default ``"cuda"``) and
raise when CUDA is asked for and absent.

Ported so far: the serving path — config, tasks, the Swin encoder with
the fused attention and MLP branches, the FPN decoders, TaskFiLM, the
default seg / GAP cls / CenterNet det / MLP reg head banks, the multi-task
model, the weight bridge from a JAX params tree, ``Predictor`` and
``StreamingPredictor`` — the train step: the branches' backward kernels,
drop path and dropout, augmentation, CenterNet targets, the losses and
``train.Trainer`` with its grouped-LR AdamW — and training from disk: the
fused photometric kernel (K3), the data pipeline (``data/``, with its own
PNG decoder and a host C++ helper, no pandas/cv2/PIL/PyYAML), metrics and
``evaluate``, the logger, checkpoints and ``fit`` with resume — and the
submission preset (``configs/submit.yaml``): the dense MoE conv block with
its balance loss and statistics, ``export_predictions`` and the
``predict`` CLI (``python -m fmc_uia_tpu_torch.predict``) — and the DINOv3
ViT-L/16 SPM-interaction preset (``configs/vit_large_patch16_dinov3.yaml``:
the spatial pyramid, the deformable cross-attention's bilinear gather,
the antialiased resize) and the HTTP front (``python -m
fmc_uia_tpu_torch.serve``) — and the off-main-path heads (UNet-like,
deep-supervision, grid, baseline), FiLM variants, the task prompt, the
grid / L1 / SmoothL1 losses, SGD and Adam, gradient accumulation and
``Trainer.train_burst``.
"""

__version__ = "0.1.0"
