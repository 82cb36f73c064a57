"""Detection drawing (copy of ``ryolo_tpu/utils/plot.py``: ``rescale_boxes``
:28, ``class_color`` :66, ``plot_boxes`` :73)."""

from __future__ import annotations

import os

import cv2
import numpy as np

from ryolo_tpu_torch.data.datasets import xywha_to_polys_np

# Six-anchor colour ramp in (B, G, R) order; class colours interpolate it.
_COLOR_RAMP = np.array(
    [[1, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 0], [1, 1, 0], [1, 0, 0]],
    np.float32,
)


def rescale_boxes(boxes: np.ndarray, current_dim: int, original_shape):
    """Undo the letterbox: network-square coords -> original-image coords
    (half-padding floored, as the reference does)."""
    orig_h, orig_w = original_shape
    scale = current_dim / max(orig_h, orig_w)
    pad_x = max(orig_h - orig_w, 0) * scale
    pad_y = max(orig_w - orig_h, 0) * scale
    span_x = current_dim - pad_x
    span_y = current_dim - pad_y

    out = np.array(boxes, np.float64, copy=True)
    out[:, 0] = (out[:, 0] - pad_x // 2) * (orig_w / span_x)
    out[:, 1] = (out[:, 1] - pad_y // 2) * (orig_h / span_y)
    out[:, 2] *= orig_w / span_x
    out[:, 3] *= orig_h / span_y
    return out


def get_color(channel: int, x, max_val) -> int:
    """One colour channel off the ramp at position ``x / max_val``."""
    t = float(x) / max_val * 5
    lo, hi = int(np.floor(t)), int(np.ceil(t))
    frac = t - lo
    value = (1 - frac) * _COLOR_RAMP[lo, channel] \
        + frac * _COLOR_RAMP[hi, channel]
    return int(value * 255)


def class_color(cls_id: int, n_classes: int):
    """Class ids spread along the ramp by the coprime stride 93."""
    pos = cls_id * 93 % n_classes
    return tuple(get_color(ch, pos, n_classes) for ch in (2, 1, 0))


def plot_boxes(img_path: str, boxes: np.ndarray, class_names, img_size: int,
               output_folder: str) -> str:
    """Draw ``(n, 7)`` detections ``[x, y, w, h, theta, conf, cls]`` (network
    coords) on the original image and save it; returns the written path."""
    img = cv2.imread(img_path)
    boxes = np.asarray(boxes, np.float64)
    if len(boxes):
        boxes = rescale_boxes(boxes, img_size, img.shape[:2])
        corners = xywha_to_polys_np(boxes[:, :5].astype(np.float32))
        corners = corners.astype(np.intp)
        for quad, det in zip(corners, boxes):
            cls_id = int(det[6])
            pen = class_color(cls_id, len(class_names))
            cv2.drawContours(img, [quad], 0, pen, 2)
            label = f"{class_names[cls_id]}:{round(float(det[5]), 2)}"
            img = cv2.putText(img, label, tuple(quad[0]),
                              cv2.FONT_HERSHEY_SIMPLEX, 0.6, pen, 1)
    os.makedirs(output_folder, exist_ok=True)
    out_path = os.path.join(output_folder, os.path.split(img_path)[-1])
    cv2.imwrite(out_path, img)
    return out_path
