"""Device choice, compute dtypes and float32 math shared by the CLIs."""

from __future__ import annotations

import torch

# the compute dtype by --dtype; int8 is the bf16 deploy graph with the wide
# convs quantized (detect.py:64-69; train takes f32 and bf16)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "int8": torch.bfloat16}


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

