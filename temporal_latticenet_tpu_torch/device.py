"""Device selection: the port runs on CUDA unless the caller asks for the
CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for and absent.

    On CUDA, float32 matrix products and convolutions are set to full
    float32 (no TF32), the precision of the JAX reference's float32
    accumulation."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device) but torch.cuda is not "
            "available; pass device='cpu' to run the plain CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe(device: torch.device) -> dict:
    """What a measurement on ``device`` was taken on: the backend, the
    device's name, ``nvidia-smi``'s name and power limit of the card
    (``card``; None on the CPU), and the torch and CUDA versions."""
    info = {"backend": device.type, "device": "cpu", "card": None,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type == "cuda":
        info["device"] = torch.cuda.get_device_name(device)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
        if out.returncode != 0:
            raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
        info["card"] = out.stdout.strip()
    return info
