"""CLI: ``python -m fmc_uia_tpu_torch --config <yaml> [--resume]
[--device cuda|cpu]`` (the port of ``python -m fmc_uia_tpu``). Reading a
YAML file needs PyYAML; nothing else of the training path does.

Several ranks: ``torchrun --nproc_per_node N -m fmc_uia_tpu_torch --config
<yaml> [--device cpu]``, with ``parallel.mesh`` in the config (data
parallel over every rank without it); ``fit`` reads torchrun's
environment."""

import argparse


def main():
    parser = argparse.ArgumentParser(
        description="Train the multi-task ultrasound model (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to config file")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint in output_dir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args()

    from fmc_uia_tpu_torch.fit import fit

    fit(config_path=args.config, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
