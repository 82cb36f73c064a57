"""Shared loss primitives: BCE with logits, focal modulation, masked means,
axis-aligned CIoU (counterpart of ``ryolo_tpu/losses/common.py``:
``bce_with_logits`` :16, ``focal_modulation`` :26, ``bce_loss`` :37,
``bbox_ciou`` :55, ``masked_mean`` :145).  Every reduction over a padded
candidate set is a masked mean, so fixed shapes give the reference's
dynamic-shape ``.mean()``.  ``kf_loss`` comes with the KFIoU head.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def bce_with_logits(logits, targets, pos_weight=1.0):
    """Elementwise ``-(pw·z·log σ(x) + (1-z)·log(1-σ(x)))``."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_modulation(logits, targets, gamma: float, alpha: float = 0.25):
    """Focal scale ``alpha_factor · (1 - p_t)^gamma``."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return alpha_factor * (1.0 - p_t) ** gamma


def masked_mean(x, mask):
    """Mean of ``x`` over the elements where ``mask`` holds (0 if none)."""
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)


def bce_loss(logits, targets, pos_weight=1.0, fl_gamma: float = 0.0,
             mask=None):
    """Mean BCE over all elements, or over the elements ``mask`` selects,
    with focal modulation when ``fl_gamma > 0``."""
    loss = bce_with_logits(logits, targets, pos_weight)
    if fl_gamma > 0:
        loss = loss * focal_modulation(logits, targets, fl_gamma)
    if mask is None:
        return torch.mean(loss)
    return masked_mean(loss, mask)


def bbox_ciou(pred_boxes, target_boxes):
    """Complete IoU of axis-aligned ``(x, y, w, h)`` boxes, elementwise
    (``lib/loss.py:36-78`` of the reference: same epsilons, detached alpha,
    ``[-1, 1]`` clamp).  ``(..., 4) -> (...)``."""
    x1, y1, w1, h1 = pred_boxes.unbind(-1)
    x2, y2, w2, h2 = target_boxes.unbind(-1)
    pb_min = torch.stack([x1 - w1 / 2, y1 - h1 / 2], -1)
    pb_max = torch.stack([x1 + w1 / 2, y1 + h1 / 2], -1)
    tb_min = torch.stack([x2 - w2 / 2, y2 - h2 / 2], -1)
    tb_max = torch.stack([x2 + w2 / 2, y2 + h2 / 2], -1)

    inter = torch.clamp_min(torch.minimum(pb_max, tb_max)
                            - torch.maximum(pb_min, tb_min), 0)
    inter_area = inter[..., 0] * inter[..., 1]
    inter_diag = (x2 - x1) ** 2 + (y2 - y1) ** 2
    outer = torch.clamp_min(torch.maximum(pb_max, tb_max)
                            - torch.minimum(pb_min, tb_min), 0)
    outer_diag = outer[..., 0] ** 2 + outer[..., 1] ** 2
    union = w1 * h1 + w2 * h2 - inter_area
    u = inter_diag / (outer_diag + 1e-15)
    iou = inter_area / (union + 1e-15)
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    S = (1.0 - iou).detach()
    alpha = v.detach() / (S + v.detach() + 1e-15)
    ciou = iou - (u + alpha * v)
    return torch.clamp(ciou, -1.0, 1.0)
