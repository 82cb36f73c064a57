"""Frozen copy of ``ryolo_tpu_torch/ops/rotated_iou.py`` at commit d329eff for the
benchmark's plain reference; it imports nothing of the port.

Rotated-rectangle IoU in plain PyTorch: the CUDA kernel's plain version.

Same formulation as ``ryolo_tpu/ops/rotated_iou.py`` (``_clip_ring`` :54,
``_ring_area`` :108, ``rotated_iou_pairs`` :148) and the TPU tile kernel
``ryolo_tpu/ops/pallas_iou.py:76`` it is pinned to: boxes are
``(cx, cy, w, h, angle_deg)``; each pair is re-centred on box2 before any
corner is formed (the class-offset NMS shifts centres by up to ~61k px);
box1's corners form an 8-slot duplicate-fill ring that goes through four
Sutherland-Hodgman clips against box2's edges (unit inward normals, a
vertex within 1e-4 px of an edge counts as inside); the shoelace formula
gives the area; IoU is 0 where ``union <= 0``.

The CPU's NMS mask (``rotated_nms.nms_mask_plain``), the CPU tests and
``chip_smoke.py``'s comparisons use it.  On a CUDA tensor the NMS computes
the same IoU inside its ``nms_mask`` kernel (:mod:`ryolo_tpu_torch.ops.cuda_nms`),
and ``pairwise_rotated_iou`` launches the pairwise kernel
(:mod:`ryolo_tpu_torch.ops.cuda_iou`).
"""

from __future__ import annotations

import math

import torch

_V = 8  # a convex quad clipped by a convex quad has at most 8 vertices
EPS_INSIDE = 1e-4  # px
_CORNERS = ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def _clip_ring(px, py, p0x, p0y, nx, ny):
    """One half-plane clip of a duplicate-fill ring ``(..., 8)``.

    ``p0*`` is a point on the clip line and ``n*`` its inward unit normal,
    ``(..., 1)``.  Slot ``2i`` of the emission holds vertex i if it is
    inside and not a duplicate of its predecessor, slot ``2i+1`` the edge
    crossing to vertex i+1; emitted points are compacted in order and the
    ring is filled up with the last one (zeros if none).
    """
    d = (px - p0x) * nx + (py - p0y) * ny
    nxt_px = torch.roll(px, -1, -1)
    nxt_py = torch.roll(py, -1, -1)
    d_nxt = torch.roll(d, -1, -1)
    dup = (px == torch.roll(px, 1, -1)) & (py == torch.roll(py, 1, -1))
    inside = d >= -EPS_INSIDE
    cur_in = inside & ~dup
    crossing = inside ^ (d_nxt >= -EPS_INSIDE)
    denom = d - d_nxt
    t = torch.where(crossing, d / torch.where(denom == 0, 1.0, denom), 0.0)
    ix = px + t * (nxt_px - px)
    iy = py + t * (nxt_py - py)

    shape = d.shape[:-1] + (2 * _V,)
    emit = torch.stack([cur_in, crossing], -1).reshape(shape)
    ex = torch.stack([px, ix], -1).reshape(shape)
    ey = torch.stack([py, iy], -1).reshape(shape)
    pos = torch.cumsum(emit, -1) - emit.long()
    count = pos[..., -1:] + emit[..., -1:].long()
    # scatter emitted points to their ring slot; the rest go to slot 8
    slot = torch.where(emit & (pos < _V), pos, _V)
    out_x = ex.new_zeros(d.shape[:-1] + (_V + 1,)).scatter_(-1, slot, ex)
    out_y = ey.new_zeros(d.shape[:-1] + (_V + 1,)).scatter_(-1, slot, ey)
    last = torch.clamp(count - 1, min=0)
    sel = emit & (pos == last)
    last_x = torch.where(sel, ex, 0.0).sum(-1, keepdim=True)
    last_y = torch.where(sel, ey, 0.0).sum(-1, keepdim=True)
    use = torch.arange(_V, device=d.device) < count
    return (torch.where(use, out_x[..., :_V], last_x),
            torch.where(use, out_y[..., :_V], last_y))


def _ring_area(px, py):
    """Shoelace over the closed ring (duplicates add exact zeros)."""
    acc = px * torch.roll(py, -1, -1) - py * torch.roll(px, -1, -1)
    return 0.5 * torch.abs(acc.sum(-1))


def rotated_iou_pairs(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise IoU of broadcast-compatible ``(..., 5)`` box sets.

    Per-box terms are computed on each input's own shape; pair terms
    broadcast."""
    b1, b2 = boxes1.float(), boxes2.float()
    deg2rad = math.pi / 180.0
    t1 = b1[..., 4:5] * deg2rad
    t2 = b2[..., 4:5] * deg2rad
    c1, s1 = torch.cos(t1), torch.sin(t1)
    c2, s2 = torch.cos(t2), torch.sin(t2)
    w1, h1, w2, h2 = b1[..., 2:3], b1[..., 3:4], b2[..., 2:3], b2[..., 3:4]
    rel_x = b1[..., 0:1] - b2[..., 0:1]
    rel_y = b1[..., 1:2] - b2[..., 1:2]

    sx, sy, qx, qy = [], [], [], []
    for dx, dy in _CORNERS:
        sx.append(rel_x + c1 * (w1 * dx) - s1 * (h1 * dy))
        sy.append(rel_y + s1 * (w1 * dx) + c1 * (h1 * dy))
        qx.append(c2 * (w2 * dx) - s2 * (h2 * dy))
        qy.append(s2 * (w2 * dx) + c2 * (h2 * dy))
    px = torch.cat(sx + [sx[3]] * 4, -1)  # duplicate-fill slots 4..7
    py = torch.cat(sy + [sy[3]] * 4, -1)

    for e in range(4):
        p0x, p0y = qx[e], qy[e]
        ex_ = qx[(e + 1) % 4] - p0x
        ey_ = qy[(e + 1) % 4] - p0y
        inv_len = torch.rsqrt(torch.clamp(ex_ * ex_ + ey_ * ey_, min=1e-12))
        nx = -ey_ * inv_len
        ny = ex_ * inv_len
        sgn = torch.sign(-p0x * nx - p0y * ny)  # orient toward box2's centre
        sgn = torch.where(sgn == 0, 1.0, sgn)
        px, py = _clip_ring(px, py, p0x, p0y, nx * sgn, ny * sgn)

    inter = _ring_area(px, py)
    union = (w1 * h1 + w2 * h2)[..., 0] - inter
    return torch.where(union > 0,
                       inter / torch.where(union == 0, 1.0, union), 0.0)


def pairwise_rotated_iou_plain(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """``(B, N, 5) x (B, M, 5) -> (B, N, M)``: row boxes are box1, column
    boxes box2 (the kernel's contract)."""
    return rotated_iou_pairs(boxes1[:, :, None, :], boxes2[:, None, :, :])
