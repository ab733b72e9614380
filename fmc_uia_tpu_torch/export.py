"""Batched inference over the 4 task types (port of
``fmc_uia_tpu/export.py`` ``Predictor``).

``export_predictions`` (file decoding, mask PNGs) waits for a later slice:
it needs an image decoder that the GPU machine may lack.
"""

from __future__ import annotations

import numpy as np
import torch

from fmc_uia_tpu_torch.device import resolve_device
from fmc_uia_tpu_torch.metrics import masked_argmax
from fmc_uia_tpu_torch.models.layers import take
from fmc_uia_tpu_torch.ops.centernet import decode_centernet
from fmc_uia_tpu_torch.ops.image import normalize_images
from fmc_uia_tpu_torch.tasks import (
    CLASSIFICATION,
    DETECTION,
    REGRESSION,
    SEGMENTATION,
    TaskRegistry,
)


class Predictor:
    """One forward + decode per task type, on ``device``.

    Outputs per image: seg a class-id mask [S, S], cls a class id, det a
    normalized corner box [4] (f32), reg 2P normalized coordinates (f32).
    """

    def __init__(self, model, registry: TaskRegistry, mean, std,
                 image_size: int, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.registry = registry
        self.image_size = image_size
        # on the device once: a per-call copy from host memory would
        # synchronize the stream and stall the serving dispatcher
        self.mean = torch.tensor([float(m) for m in mean],
                                 device=self.device)
        self.std = torch.tensor([float(s) for s in std], device=self.device)
        self.nc_table = torch.as_tensor(registry.num_classes_table,
                                        dtype=torch.long, device=self.device)
        # device-resident task indices: no host->device copy per batch
        self._task_index = {
            s.task_id: torch.tensor(s.global_index, dtype=torch.long,
                                    device=self.device) for s in registry}

    def _to_device(self, images_u8: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(images_u8, np.uint8))
        if self.device.type == "cuda":
            # pinned + async: the dispatcher does not wait on the stream
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def predict_device(self, images_u8: np.ndarray, task_id: str
                       ) -> torch.Tensor:
        """Run one batch; returns the decoded output still on the device
        (possibly in flight) — callers that overlap dispatch with readback
        (serving.py) bring it to the host themselves."""
        spec = self.registry[task_id]
        tidx = self._task_index[task_id]
        x = normalize_images(self._to_device(images_u8), self.mean,
                             self.std, dtype=torch.float32)
        out = self.model(x, spec.task_name, tidx)
        if spec.task_name in (SEGMENTATION, CLASSIFICATION):
            # int32 class ids, as jnp.argmax returns
            return masked_argmax(out, take(self.nc_table, tidx)).int()
        if spec.task_name == DETECTION:
            return decode_centernet(out["heatmap"].float(),
                                    out["size"].float(),
                                    out["offset"].float())
        assert spec.task_name == REGRESSION
        return out.float()

    def predict_images(self, images_u8: np.ndarray, task_id: str
                       ) -> np.ndarray:
        """images_u8: [B, S, S, 3] resized uint8 batch -> per-type output."""
        return self.predict_device(images_u8, task_id).cpu().numpy()
