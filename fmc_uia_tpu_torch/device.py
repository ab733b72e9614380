"""Device resolution shared by the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``). Asking for CUDA on
a host without a GPU raises; the port never carries on on the CPU unless
the caller asked for ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA GPU; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
