"""Model layer: YOLOv4/v5/v7 blocks, backbones, PAN necks, CSL and KFIoU
heads, deploy fusion."""

from ryolo_tpu_torch.nn.deploy import fuse_for_inference  # noqa: F401
from ryolo_tpu_torch.nn.yolo import (STRIDES, Yolo, make_anchors,  # noqa: F401
                                     make_rotated_anchors)
