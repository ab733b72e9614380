"""Inference CLI: load a trained model, export challenge-format predictions
(port of ``fmc_uia_tpu/predict.py``):

    python -m fmc_uia_tpu_torch.predict --checkpoint outputs/exp_.../ \\
        --data /path/to/test --out preds/ [--device cuda|cpu]

``--checkpoint`` is the experiment dir that ``fit`` wrote: its
``config.yaml`` snapshot (JSON text, read without PyYAML; it records the
dataset-derived task universe the model was built with) and
``best_model.pt``. Predictions land as per-task JSON files and mask PNGs
(``export.export_predictions``). PyYAML is needed only for a ``--config``
YAML file.
"""

from __future__ import annotations

import argparse
import json
import os


def load_snapshot_config(path: str):
    """A config file as ``fit`` writes it (JSON text) or, failing JSON, as
    YAML."""
    from fmc_uia_tpu_torch.config import Config

    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        return Config(config_dict=json.loads(text))
    except json.JSONDecodeError:
        return Config(config_path=path)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run inference + export")
    parser.add_argument("--config", type=str, default=None,
                        help="config path; defaults to the experiment dir's "
                             "config.yaml snapshot (which records the "
                             "dataset-derived task universe the model was "
                             "actually built with)")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="experiment dir containing best_model.pt")
    parser.add_argument("--data", type=str, required=True,
                        help="dataset root with csv_files/")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from fmc_uia_tpu_torch import checkpoint as ckpt_lib
    from fmc_uia_tpu_torch.device import resolve_device
    from fmc_uia_tpu_torch.export import export_predictions
    from fmc_uia_tpu_torch.models import build_model
    from fmc_uia_tpu_torch.tasks import TaskRegistry

    dev = resolve_device(args.device)
    config_path = args.config
    if config_path is None:
        config_path = os.path.join(args.checkpoint, "config.yaml")
        if not os.path.exists(config_path):
            raise FileNotFoundError(
                f"No --config given and {config_path} not found")
    config = load_snapshot_config(config_path)
    registry = TaskRegistry.from_config(config)
    model = build_model(config, registry, device=dev, init=False)
    model.load_state_dict(ckpt_lib.load_best_params(args.checkpoint, dev))

    outputs = export_predictions(
        model, args.data, args.out, registry,
        config.get("data.augmentation.normalize.mean"),
        config.get("data.augmentation.normalize.std"),
        config.image_size, batch_size=args.batch_size, device=dev)
    for task_id, path in outputs.items():
        print(f"{task_id}: {path}")
    return outputs


if __name__ == "__main__":
    main()
