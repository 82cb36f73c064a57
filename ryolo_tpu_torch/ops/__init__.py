"""Ops with hand-written CUDA kernels (plain PyTorch on the CPU): pairwise
rotated IoU, the batched greedy rotated NMS (a suppression bitmask and a
scan over it), and device-side augmentation's tap renderer and canvas
warp."""

from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou  # noqa: F401
from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked  # noqa: F401
