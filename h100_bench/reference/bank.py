"""The tile bank worked out again from the image files: each training image
decoded, resized to at most ``img_size`` as the augmenting dataset resizes
it, and packed to ``(s, s)`` int32 words ``R | G<<8 | B<<16`` x-major,
content top-left (frozen from ``ryolo_tpu_torch/data/datasets.py``
``_load_resized``, ``build_tile_bank`` and ``pack_tile_i32`` at commit
d329eff)."""

from __future__ import annotations

from typing import Sequence

import cv2
import numpy as np


def pack_tile_i32(img_bgr: np.ndarray) -> np.ndarray:
    """(h, w, 3) BGR uint8 -> (w, h) int32 packed RGB, x-major."""
    rgb = img_bgr[:, :, ::-1].astype(np.int32)
    return (rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16)).T


def tile_bank(img_files: Sequence[str], img_size: int,
              rows: Sequence[int] | None = None) -> np.ndarray:
    """``(N, s, s)`` int32 bank of ``img_files`` in the given order, or of
    the files at ``rows`` alone, in that order."""
    rows = range(len(img_files)) if rows is None else rows
    bank = np.zeros((len(rows), img_size, img_size), np.int32)
    for i, row in enumerate(rows):
        img = cv2.imread(img_files[row])
        h, w = img.shape[:2]
        r = img_size / max(h, w)
        if r != 1:
            img = cv2.resize(img, (int(w * r), int(h * r)),
                             interpolation=cv2.INTER_LINEAR)
        h, w = img.shape[:2]
        bank[i, :w, :h] = pack_tile_i32(img)
    return bank
