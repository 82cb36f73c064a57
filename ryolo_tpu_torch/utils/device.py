"""Device choice and float32 math shared by the CLIs."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The device asked for; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def set_float32_math(device: torch.device):
    """On a card: float32 convolutions and matmuls in float32, not TF32
    (their default)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

