"""Shared loss primitives: BCE with logits, focal modulation, masked means,
axis-aligned CIoU (counterpart of ``ryolo_tpu/losses/common.py``:
``bce_with_logits`` :16, ``focal_modulation`` :26, ``bce_loss`` :37,
``bbox_ciou`` :55, ``_sigma_inverse_quadform`` :89, ``kf_loss`` :100,
``masked_mean`` :145).  Every reduction over a padded candidate set is a
masked mean, so fixed shapes give the reference's dynamic-shape
``.mean()``.

Data parallelism (``--dp N``): the JAX trainer takes each mean over the
global batch.  A rank's loss is then its share of the global loss: a
masked mean divides by the ``count`` of unmasked elements summed over the
ranks (:func:`level_counts`), and an unmasked mean over equal shards is
the local mean over the number of ``shards``.  The shares sum to the
global loss, and the ranks' gradients to its gradient.

Under ``--sp`` the ``sp`` ranks of a group hold the same images and the
same whole head maps (:func:`ryolo_tpu_torch.parallel.spatial.gather_rows`),
so the counts and items sum over the groups, one rank of each, and the
``shards`` are the groups: a sum over all ranks would count each target
``sp`` times, and the loss would still be finite.
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


def masked_mean(x, mask, count=None):
    """Mean of ``x`` over the elements where ``mask`` holds (0 if none);
    ``count``: the number of those elements to divide by (default: this
    ``mask``'s)."""
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    if count is None:
        count = torch.sum(m)
    return torch.sum(x * m) / torch.clamp_min(count, 1.0)


def bce_loss(logits, targets, pos_weight=1.0, fl_gamma: float = 0.0,
             mask=None, count=None, shards: int = 1):
    """Mean BCE over all elements (over ``shards`` equal shards: this
    shard's mean / ``shards``), or over the elements ``mask`` selects
    (``count``: :func:`masked_mean`'s), with focal modulation when
    ``fl_gamma > 0``."""
    loss = bce_with_logits(logits, targets, pos_weight)
    if fl_gamma > 0:
        loss = loss * focal_modulation(logits, targets, fl_gamma)
    if mask is None:
        return torch.mean(loss) / shards
    return masked_mean(loss, mask, count)


def level_counts(valid_masks, reducer=None):
    """``(counts, shards)``: the number of valid candidates of each level's
    ``(B, K)`` mask, float32, summed over the groups of ``reducer`` (a
    :class:`~ryolo_tpu_torch.parallel.mesh.Mesh`; no gradient flows through
    them), and the number of groups (1 without a reducer)."""
    counts = torch.stack([m.sum() for m in valid_masks]).float()
    if reducer is None:
        return counts, 1
    return reducer.sum(counts), reducer.groups


def reduce_items(items: dict, reducer=None) -> dict:
    """Loss items (each group's share) summed over the groups, detached."""
    if reducer is None:
        return items
    ref = next(v for v in items.values() if isinstance(v, torch.Tensor))
    sums = reducer.sum(torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=ref.device).detach()
        for v in items.values()]))
    return dict(zip(items, sums.unbind()))


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


def _sigma_inverse_quadform(diff, wh, r):
    """``diff^T Sigma^-1 diff`` for ``Sigma = R diag(w/2, h/2)^2 R^T``, in
    closed form: ``diff`` rotated into the box frame, where ``Sigma^-1`` is
    diagonal."""
    cos_r, sin_r = torch.cos(r), torch.sin(r)
    dx = diff[..., 0] * cos_r + diff[..., 1] * sin_r
    dy = -diff[..., 0] * sin_r + diff[..., 1] * cos_r
    a = (0.5 * wh[..., 0]) ** 2
    b = (0.5 * wh[..., 1]) ** 2
    return dx ** 2 / a + dy ** 2 / b


def kf_loss(pred, target, fun: str = "exp", alpha: float = 3.0, mask=None,
            count=None):
    """Kalman-filter IoU loss of ``(..., 5)`` ``(x, y, w, h, theta)`` boxes
    (``lib/loss.py:100-150`` of the reference, the Gaussians of
    ``lib/general.py:107-133`` in closed form).  Returns ``(loss, kfiou)``:
    the loss's mean over the elements ``mask`` selects (all without one;
    ``count``: :func:`masked_mean`'s) and the elementwise KFIoU.  The terms
    keep the reference's order: with
    sizes clipped to ``[1e-4, 1e4]`` the size ratios reach 1e24 in
    float32."""
    wh_p = torch.clamp(pred[..., 2:4], 1e-4, 1e4)
    wh_t = torch.clamp(target[..., 2:4], 1e-4, 1e4)
    r_p, r_t = pred[..., 4], target[..., 4]

    diff = pred[..., 0:2] - target[..., 0:2]
    xy_loss = torch.log(_sigma_inverse_quadform(diff, wh_t, r_t) + 1.0)

    wp2, hp2 = wh_p[..., 0] ** 2, wh_p[..., 1] ** 2
    wt2, ht2 = wh_t[..., 0] ** 2, wh_t[..., 1] ** 2
    cos2dr = torch.cos(r_p - r_t) ** 2
    sin2dr = torch.sin(r_p - r_t) ** 2

    A = torch.sqrt(1 + (wp2 * hp2) / (wt2 * ht2)
                   + (wp2 / wt2 + hp2 / ht2) * cos2dr
                   + (wp2 / ht2 + hp2 / wt2) * sin2dr)
    B = torch.sqrt(1 + (wt2 * ht2) / (wp2 * hp2)
                   + (wt2 / wp2 + ht2 / hp2) * cos2dr
                   + (wt2 / hp2 + ht2 / wp2) * sin2dr)
    kfiou = (4.0 - alpha) / (A + B - alpha)

    if fun == "ln":
        k = -torch.log(kfiou + 1e-6)
    elif fun == "exp":
        k = torch.exp(1.0 - kfiou) - 1.0
    else:
        k = 1.0 - kfiou

    loss = torch.clamp_min(xy_loss + k, 0)
    if mask is None:
        return torch.mean(loss), kfiou
    return masked_mean(loss, mask, count), kfiou
