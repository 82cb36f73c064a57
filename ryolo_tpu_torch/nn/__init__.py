"""Model layer: YOLOv7 blocks, backbone, PAN neck, CSL head, deploy fusion."""

from ryolo_tpu_torch.nn.deploy import fuse_for_inference  # noqa: F401
from ryolo_tpu_torch.nn.yolo import STRIDES, Yolo, make_anchors  # noqa: F401
