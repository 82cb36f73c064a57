"""The detect letterbox (copies of ``ryolo_tpu/data/datasets.py``
``ImageDataset`` :152 and ``xywha_to_polys_np`` :72, and of
``ryolo_tpu/data/augment.py:104`` ``pad_to_square``; the JAX package's
modules reach JAX through ``ryolo_tpu.geometry``)."""

from __future__ import annotations

import glob
import os
from typing import Tuple

import cv2
import numpy as np

PAD_VALUE = (114, 114, 114)


def xywha_to_polys_np(boxes: np.ndarray) -> np.ndarray:
    """``(N, 5)`` ``[x, y, w, h, theta]`` -> corners ``(N, 4, 2)``."""
    x, y, w, h, t = [boxes[:, i] for i in range(5)]
    c, s = np.cos(t), np.sin(t)
    dx = np.stack([-h, h, h, -h], -1) / 2
    dy = np.stack([-w, -w, w, w], -1) / 2
    px = x[:, None] + c[:, None] * dx + s[:, None] * dy
    py = y[:, None] - s[:, None] * dx + c[:, None] * dy
    return np.stack([px, py], -1)


def pad_to_square(img, new_shape: Tuple[int, int], pad_value):
    """Aspect-preserving letterbox; returns the image and the (dh, dw)
    half-padding."""
    shape = img.shape[:2]
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw = (new_shape[1] - new_unpad[0]) / 2
    dh = (new_shape[0] - new_unpad[1]) / 2
    if shape[::-1] != new_unpad:
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=pad_value)
    return img, (dh, dw)


class ImageDataset:
    """Label-free image folder for detect: letterboxed RGB uint8
    ``(S, S, 3)`` (the JAX package's ``image_uint8=True``; the device
    divides by 255 in float32)."""

    def __init__(self, folder_path: str, img_size: int = 416, ext: str = "png"):
        self.files = sorted(glob.glob(os.path.join(folder_path, f"*.{ext}")))
        self.img_size = img_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        path = self.files[index % len(self.files)]
        img = cv2.imread(path)
        img, _ = pad_to_square(img, (self.img_size, self.img_size), PAD_VALUE)
        return path, np.ascontiguousarray(img[:, :, ::-1])
