"""fmc_uia_tpu_torch — the PyTorch/CUDA port of fmc_uia_tpu for NVIDIA
Hopper (H100).

A package of its own beside the JAX package, which stays the reference:
it imports ``torch`` and never ``jax``, ``flax`` or ``fmc_uia_tpu``. The
Pallas TPU kernels on its path are CUDA C++ kernels written by hand for
``sm_90a`` (``csrc/``), built by ``nvcc`` on first CUDA use
(``ops/build.py``). Entry points take ``device`` (default ``"cuda"``) and
raise when CUDA is asked for and absent.

Ported so far (serving path): config, tasks, the Swin encoder with the
fused attention and MLP branches, the FPN decoders, TaskFiLM, the default
seg / GAP cls / CenterNet det / MLP reg head banks, the multi-task model,
the weight bridge from a JAX params tree, ``Predictor`` and
``StreamingPredictor``.
"""

__version__ = "0.1.0"
