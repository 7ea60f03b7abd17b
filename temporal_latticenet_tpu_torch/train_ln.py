"""Training CLI of the PyTorch port, mirroring the repository's
``train_ln.py`` (and the reference's ``python train_ln.py --dataset
semantickitti``):

    python -m temporal_latticenet_tpu_torch.train_ln --dataset semantickitti \
        [--config seq_config/lnn_train_semantic_kitti.cfg] [--device cpu]

Runs on CUDA unless ``--device`` names another device; it raises when CUDA
is asked for and absent, and never falls back to the CPU.

Data parallel, one process per rank (``train.batch_size`` is the global
count of sequences per step, split over the ranks):

    torchrun --nproc_per_node=N -m temporal_latticenet_tpu_torch.train_ln \
        --config ... [--dist-backend gloo]

A ``WORLD_SIZE`` above 1 makes the mesh: NCCL with one card per rank, or
``gloo`` when asked for (ranks that share a card, or ranks on the CPU with
``--device cpu``)."""

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
        device=None, dist_backend: str | None = None):
    from .parallel import mesh as pmesh
    from .train.loop import run_training
    config_file = config_path(dataset_name, config_file, DEFAULT_CONFIGS)
    print("Config file:", config_file)
    if int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return run_training(config_file, device=device)
    mesh = pmesh.make_mesh(backend=dist_backend, device=device)
    try:
        return run_training(config_file, mesh=mesh)
    finally:
        pmesh.close(mesh)


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
    parser.add_argument("--dist-backend", type=str, default=None,
                        choices=["nccl", "gloo"],
                        help="under torchrun: the process group's backend "
                             "(default nccl; gloo for ranks that share a "
                             "card or run on the CPU)")
    args = parser.parse_args(argv)
    run(args.dataset, args.config, args.device, args.dist_backend)


if __name__ == "__main__":
    main()
