"""ryolo_tpu_torch — the PyTorch/CUDA port of ``ryolo_tpu`` for NVIDIA Hopper.

The JAX package ``ryolo_tpu`` stays the reference; every module here names
its counterpart there and is held against it by ``tests/test_torch_*.py``.
This package imports torch, numpy, cv2 and yaml only — never jax, flax,
optax or ``ryolo_tpu`` — and importing it needs no CUDA, ``nvcc`` or
``triton``: the hand-written kernels build on first use on the card.

Subpackages
-----------
- ``ryolo_tpu_torch.nn``    — YOLOv7 blocks, backbone, PAN neck, CSL head, deploy fusion
- ``ryolo_tpu_torch.ops``   — rotated IoU (plain PyTorch + CUDA kernel), rotated NMS
- ``ryolo_tpu_torch.eval``  — deferred-theta post-processing
- ``ryolo_tpu_torch.data``  — the detect letterbox
- ``ryolo_tpu_torch.utils`` — config, logging, ``.pth`` interop, plotting
- ``ryolo_tpu_torch.detect`` — the detect CLI (``python -m ryolo_tpu_torch.detect``)
"""

__version__ = "0.1.0"
