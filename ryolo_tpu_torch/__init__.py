"""ryolo_tpu_torch — the PyTorch/CUDA port of ``ryolo_tpu`` for NVIDIA Hopper.

The JAX package ``ryolo_tpu`` stays the reference; every module here names
its counterpart there and is held against it by ``tests/test_torch_*.py``.
This package imports torch, numpy, cv2 and yaml only — never jax, flax,
optax or ``ryolo_tpu`` — and importing it needs no CUDA, ``nvcc`` or
``triton``: the hand-written kernels build on first use on the card (the
host matcher with ``g++`` on first use).

Subpackages
-----------
- ``ryolo_tpu_torch.nn``    — YOLOv4/v5/v7 blocks, backbones, PAN necks, CSL and KFIoU heads, deploy fusion
- ``ryolo_tpu_torch.ops``   — rotated IoU, rotated NMS and the render (plain PyTorch + CUDA kernels), the host C++ matcher
- ``ryolo_tpu_torch.eval``  — deferred CSL and KFIoU post-processing, the mAP metrics, the evaluator
- ``ryolo_tpu_torch.data``  — datasets, render specs, the spec loader, device-side augmentation
- ``ryolo_tpu_torch.losses`` — target assignment, the CSL and KFIoU losses
- ``ryolo_tpu_torch.train`` — reference init, optimizer, the accumulating train step; the train CLI (``python -m ryolo_tpu_torch.train``)
- ``ryolo_tpu_torch.utils`` — config, logging, checkpoints and ``.pth`` interop, devices, plotting
- ``ryolo_tpu_torch.detect`` — the detect CLI (``python -m ryolo_tpu_torch.detect``)
- ``ryolo_tpu_torch.test``  — the eval CLI (``python -m ryolo_tpu_torch.test``)
"""

__version__ = "0.1.0"
