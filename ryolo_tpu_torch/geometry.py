"""Rotated-box geometry (counterpart of ``ryolo_tpu/geometry.py``:
``norm_angle`` :25, ``wrap_angle`` :37, ``xywha2xyxyxyxy`` :50,
``xyxyxyxy2xywha`` :73, ``xywhr2xywhrsigma`` :104, and the host copy of
``csl_gaussian_labels_np`` :152; the JAX module imports jax).

Boxes are ``(x, y, w, h, theta)`` with theta in radians, clockwise in image
coordinates, in ``[-pi/2, pi/2)`` and set by the long side ``h``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def norm_angle(theta: torch.Tensor) -> torch.Tensor:
    """Angles within one period of ``[-pi/2, pi/2)`` moved into it (one
    correction each side)."""
    theta = torch.where(theta >= math.pi / 2, theta - math.pi, theta)
    return torch.where(theta < -math.pi / 2, theta + math.pi, theta)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Any angle moved into ``[-pi/2, pi/2)`` (a full modular wrap)."""
    return torch.remainder(theta + math.pi / 2, math.pi) - math.pi / 2


def xywha2xyxyxyxy(boxes: torch.Tensor) -> torch.Tensor:
    """``(..., 5)`` rotated boxes -> corner polygons ``(..., 4, 2)``: the
    offsets ``(-+h/2, -+w/2)`` (the long side on the local x axis) rotated
    by ``[[cos, sin], [-sin, cos]]`` about the centre."""
    x, y, w, h, theta = boxes.unbind(-1)
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    dx = torch.stack([-h, h, h, -h], -1) / 2.0
    dy = torch.stack([-w, -w, w, w], -1) / 2.0
    cx = x[..., None] + c * dx + s * dy
    cy = y[..., None] - s * dx + c * dy
    return torch.stack([cx, cy], -1)


def xyxyxyxy2xywha(polys: torch.Tensor) -> torch.Tensor:
    """Clockwise corner polygons ``(..., 8)`` -> ``(..., 5)`` rotated boxes
    with the long side ``h``."""
    x1, y1, x2, y2, x3, y3, x4, y4 = polys.unbind(-1)
    x = (x1 + x2 + x3 + x4) / 4
    y = (y1 + y2 + y3 + y4) / 4
    w = (torch.hypot(x2 - x3, y2 - y3) + torch.hypot(x1 - x4, y1 - y4)) / 2
    h = (torch.hypot(x1 - x2, y1 - y2) + torch.hypot(x4 - x3, y4 - y3)) / 2
    theta = -(torch.atan2(y1 - y2, x1 - x2)
              + torch.atan2(y4 - y3, x4 - x3)) / 2
    swap = w >= h
    w_, h_ = torch.where(swap, h, w), torch.where(swap, w, h)
    theta = torch.where(swap, torch.where(theta > 0, theta - math.pi / 2,
                                          theta + math.pi / 2), theta)
    return torch.stack([x, y, w_, h_, norm_angle(theta)], -1)


def xywhr2xywhrsigma(xywhr: torch.Tensor):
    """Rotated box -> 2-D Gaussian ``(xy, wh, r, sigma)``: ``sigma = R
    diag(w/2, h/2)^2 R^T`` with ``wh`` clipped to ``[1e-4, 1e4]``."""
    xy = xywhr[..., :2]
    wh = torch.clamp(xywhr[..., 2:4], 1e-4, 1e4)
    r = xywhr[..., 4]
    cos_r, sin_r = torch.cos(r), torch.sin(r)
    R = torch.stack([torch.stack([cos_r, -sin_r], -1),
                     torch.stack([sin_r, cos_r], -1)], -2)
    S2 = torch.diag_embed((0.5 * wh) ** 2)
    return xy, wh, r, R @ S2 @ R.transpose(-1, -2)


def csl_gaussian_labels_np(theta_deg_plus90: np.ndarray, num_bins: int = 180,
                           sig: float = 6.0) -> np.ndarray:
    """Gaussian window of std ``sig`` rolled onto the truncated integer bin
    of ``theta * 180/pi + 90`` (``datasets/base_dataset.py:13-31`` of the
    reference).  Returns ``(..., num_bins)`` float32."""
    theta_deg_plus90 = np.asarray(theta_deg_plus90, dtype=np.float64)
    x = np.arange(-num_bins / 2, num_bins / 2, dtype=np.float64)
    y_sig = np.exp(-(x ** 2) / (2 * sig ** 2))
    index = np.trunc(num_bins / 2 - theta_deg_plus90).astype(np.int64)
    j = np.arange(num_bins)
    src = np.mod(j + index[..., None], num_bins)
    return y_sig[src].astype(np.float32)
