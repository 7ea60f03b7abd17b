"""Training CLI of the PyTorch port, mirroring the repository's
``train_ln.py`` (and the reference's ``python train_ln.py --dataset
semantickitti``):

    python -m temporal_latticenet_tpu_torch.train_ln --dataset semantickitti \
        [--config seq_config/lnn_train_semantic_kitti.cfg] [--device cpu]

Runs on CUDA unless ``--device`` names another device; it raises when CUDA
is asked for and absent, and never falls back to the CPU."""

from __future__ import annotations

import argparse
import os
import sys

DEFAULT_CONFIGS = {
    "semantickitti": "seq_config/lnn_train_semantic_kitti.cfg",
    "parislille": "seq_config/lnn_train_paris_lille.cfg",
}


def config_path(dataset_name: str, config_file: str | None,
                defaults: dict) -> str:
    """``config_file``, or the dataset's default cfg under the working
    directory."""
    if config_file is not None:
        return config_file
    if dataset_name not in defaults:
        sys.exit(f"Dataset name not recognized. It is {dataset_name}. "
                 "Available options are semantickitti or parislille.")
    return os.path.join(os.getcwd(), defaults[dataset_name])


def run(dataset_name: str = "semantickitti", config_file: str | None = None,
        device=None):
    from .train.loop import run_training
    config_file = config_path(dataset_name, config_file, DEFAULT_CONFIGS)
    print("Config file:", config_file)
    return run_training(config_file, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train the network on a dataset.")
    parser.add_argument("--dataset", type=str, nargs="?",
                        const="semantickitti", default="semantickitti",
                        help="semantickitti OR parislille")
    parser.add_argument("--config", type=str, default=None,
                        help="override the config file path")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    run(args.dataset, args.config, args.device)


if __name__ == "__main__":
    main()
