from fmc_uia_tpu_torch.models.multitask import MultiTaskModel, build_model

__all__ = ["MultiTaskModel", "build_model"]
