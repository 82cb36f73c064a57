"""Rotated-geometry ops: pairwise rotated IoU (CUDA kernel on the card, plain
PyTorch on the CPU) and the batched greedy rotated NMS."""

from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou  # noqa: F401
from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked  # noqa: F401
