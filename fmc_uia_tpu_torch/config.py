"""Configuration: the port's copy of ``fmc_uia_tpu.config.Config``.

Same YAML schema, dot-path ``get`` and derived attributes. Two differences:
no compute-platform resolution (the port's entry points take an explicit
``device`` instead), and ``yaml`` is imported only when a file is read, so
a config built from a dict needs no PyYAML.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional

_DEFAULT_CONFIG_NAME = "config.yaml"


def _builtin_config_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "configs"


class Config:
    """YAML- or dict-backed configuration with dot-path access."""

    def __init__(self, config_path: Optional[str] = None,
                 config_dict: Optional[Dict[str, Any]] = None):
        if config_dict is not None:
            self.config = copy.deepcopy(config_dict)
        else:
            import yaml

            if config_path is None:
                config_path = _builtin_config_dir() / _DEFAULT_CONFIG_NAME
            with open(config_path, "r", encoding="utf-8") as f:
                self.config = yaml.safe_load(f)
        self._set_attributes()

    def _set_attributes(self) -> None:
        self.exp_name = self.config["experiment"]["name"]
        self.seed = self.config["experiment"]["seed"]
        self.output_dir = Path(self.config["experiment"]["output_dir"])

        data = self.config["data"]
        self.data_root = data["root_path"]
        self.val_split = data["val_split"]
        self.batch_size = data["batch_size"]
        self.num_workers = data.get("num_workers", 0)
        self.image_size = data["image_size"]

        model = self.config["model"]
        self.encoder_name = model["encoder"]["name"]
        self.encoder_weights = model["encoder"].get("pretrained")
        self.use_deep_supervision = (
            model.get("heads", {})
            .get("segmentation", {})
            .get("use_deep_supervision", False)
        )
        self.separate_detection_fpn = model.get("decoder", {}).get(
            "separate_detection_fpn", False
        )

        training = self.config["training"]
        self.num_epochs = training["num_epochs"]
        self.learning_rate = training["optimizer"]["learning_rate"]
        self.weight_decay = training["optimizer"]["weight_decay"]
        self.print_freq = training.get("print_freq", 50)

        # bf16 compute with f32 params, as in the JAX package
        self.mixed_precision = bool(
            self.config.get("device", {}).get("mixed_precision", True)
        )

    def get(self, key: str, default: Any = None) -> Any:
        """Dot-separated nested lookup, e.g. ``get('model.encoder.name')``."""
        value: Any = self.config
        for k in key.split("."):
            try:
                value = value[k]
            except (KeyError, TypeError):
                return default
        return value

    def get_task_configs(self) -> List[Dict]:
        return self.config["tasks"]

    def __repr__(self) -> str:
        return f"Config(exp_name={self.exp_name}, encoder={self.encoder_name})"
