"""Image and rotated-label augmentations on the host (numpy/cv2).

Copy of ``ryolo_tpu/data/augment.py`` (the JAX package's data modules
reach jax through ``ryolo_tpu.geometry``): hsv ``:23``, mixup ``:44``,
flips ``:51``/``:59``, ``random_warping`` ``:67``, ``pad_to_square``
``:104``, ``filter_by_center`` ``:124``, ``normalize_targets`` ``:139``.
Randomness is an explicit ``numpy.random.Generator``; targets are
``(N, 9)`` ``[cls, x1..y4]`` polygon rows.
"""

from __future__ import annotations

from typing import Tuple

import cv2
import numpy as np


def hsv_augment(img: np.ndarray, rng: np.random.Generator,
                hgain=0.015, sgain=0.7, vgain=0.4) -> None:
    """In-place HSV jitter on a BGR uint8 image: per-channel gain
    ``1 + U(-1, 1)·g`` through uint8 lookup tables, hue wrapping at 180,
    saturation and value saturating at 255."""
    if not (hgain or sgain or vgain):
        return
    gains = 1.0 + rng.uniform(-1, 1, 3) * np.array([hgain, sgain, vgain])
    ramp = np.arange(256, dtype=np.float64)[None, :] * gains[:, None]
    luts = np.empty((3, 256), np.uint8)
    luts[0] = np.mod(ramp[0], 180)          # hue: circular
    luts[1:] = ramp[1:].clip(0, 255)        # sat/val: saturating
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    for c in range(3):
        hsv[..., c] = cv2.LUT(hsv[..., c], luts[c])
    cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR, dst=img)


def mixup(img, targets, img2, targets2, rng: np.random.Generator):
    """Beta(8, 8) image blend, truncated to uint8, and the label union."""
    r = rng.beta(8.0, 8.0)
    img = (img.astype(np.float32) * r
           + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return img, np.concatenate([targets, targets2], 0)


def horizontal_flip(img, targets):
    """Flip left-right; mirror the normalized polygon x coordinates."""
    img = np.fliplr(img)
    if len(targets):
        targets[:, 1::2] = 1.0 - targets[:, 1::2]
    return img, targets


def vertical_flip(img, targets):
    """Flip up-down; mirror the normalized polygon y coordinates."""
    img = np.flipud(img)
    if len(targets):
        targets[:, 2::2] = 1.0 - targets[:, 2::2]
    return img, targets


def random_warping(img, targets, rng: np.random.Generator, degrees=10.0,
                   scale=0.9, translate=0.1, border=(0, 0)):
    """Random rotate/scale/translate warp of the image and its polygons:
    rotation in ±degrees about the source centre, scale in
    ``[1-scale, 1.1+scale]``, centre moved to ``0.3±translate`` of the
    output; a negative ``border`` crops the 2s mosaic canvas back to s."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    theta = np.deg2rad(rng.uniform(-degrees, degrees))
    s = rng.uniform(1 - scale, 1.1 + scale)
    shift = np.array([
        rng.uniform(0.3 - translate, 0.3 + translate) * width,
        rng.uniform(0.3 - translate, 0.3 + translate) * height,
    ])
    # image y grows downward, so +angle is clockwise (cv2 convention)
    rot = s * np.array([[np.cos(theta), np.sin(theta)],
                        [-np.sin(theta), np.cos(theta)]])
    center = np.array([img.shape[1], img.shape[0]]) / 2.0
    affine = np.concatenate([rot, (shift - rot @ center)[:, None]], axis=1)
    out = cv2.warpAffine(img, affine, dsize=(width, height),
                         borderValue=(114, 114, 114))
    if len(targets):
        targets = targets.copy()
        pts = targets[:, 1:].reshape(-1, 4, 2)
        targets[:, 1:] = (pts @ rot.T + shift - rot @ center).reshape(-1, 8)
    return out, targets


def pad_to_square(img, new_shape: Tuple[int, int], pad_value):
    """Aspect-preserving letterbox; returns the image and the (dh, dw)
    half-padding used to shift labels."""
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


def filter_by_center(targets, border):
    """Drop targets whose polygon centre leaves ``(x1, x2, y1, y2)``."""
    if not len(targets):
        return targets
    x1, x2, y1, y2 = border
    cx = targets[:, 1::2].mean(1)
    cy = targets[:, 2::2].mean(1)
    mask = (cx > x1) & (cx < x2) & (cy > y1) & (cy < y2)
    return targets[mask]


def normalize_targets(targets, img_shape):
    """Pixel polygon coordinates -> [0, 1]."""
    h, w = img_shape[:2]
    if len(targets):
        targets = targets.copy()
        targets[:, 1::2] /= w
        targets[:, 2::2] /= h
    return targets
