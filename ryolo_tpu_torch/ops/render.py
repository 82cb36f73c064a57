"""The tap renderer of device-side augmentation: the plain PyTorch version.

Counterpart of ``ryolo_tpu/data/device_augment.py`` ``_render_one`` :175
(the JAX package's readable "taps" renderer) run for every spec, followed
by ``_mix_flip_tail`` :648 and the division by 255.  The CUDA kernel
``ops/csrc/render.cu`` (wrapper :mod:`ryolo_tpu_torch.ops.cuda_render`)
computes the same values in one launch; this version runs on the CPU and
is the kernel's yardstick on the card.

Contract, per spec ``b`` and pixel (row ``oy``, column ``ox``) of its
render, in float32:

* ``cx = (m0·ox + m1·oy) + m2``, ``cy = (m3·ox + m4·oy) + m5``,
  ``x0 = floor(cx)``, ``fx = cx - x0`` (the same for y); the taps are
  ``(x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1)``;
* a tap's owner is the highest slot ``k`` with ``r0 <= qx < r2`` and
  ``r1 <= qy < r3`` (its float region); an unowned tap is PAD 114;
* an owned tap reads the packed word ``rows[slot_rows[b, k], sx, sy]``,
  ``(sx, sy) = clip((qx, qy) - offset_k, 0, s-1)``, ``R | G<<8 | B<<16``,
  and applies slot ``k``'s HSV gains unless all three are 1;
* the blend ``c00·((1-fx)(1-fy)) + c01·(fx(1-fy)) + c10·((1-fx)fy) +
  c11·(fx·fy)`` is summed left to right and rounded half to even.

Then, per output ``b < n_out``: with a partner ``j = mix_idx[b] >= 0``,
``floor(img_b·r + img_j·(1-r))`` (``1-r`` in float32); flips after the
mix; times the float32 reciprocal of 255.
"""

from __future__ import annotations

import numpy as np
import torch

from ryolo_tpu_torch.ops.hsv import _RCP255, _hsv_jitter_planar
from ryolo_tpu_torch.utils import trace

PAD = 114.0            # letterbox / border value


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor, through pinned memory and without
    blocking the host when the device is a card (counted as
    ``upload.h2d``)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cpu":
        return t
    trace.count("upload.h2d")
    return t.pin_memory().to(device, non_blocking=True)


def mix_flip_tail(imgs: torch.Tensor, flip: np.ndarray, mix_idx: np.ndarray,
                  mix_r: np.ndarray, n_out: int) -> torch.Tensor:
    """Mixup (float blend, then floor as the reference's uint8 truncation),
    flips, /255 (``_mix_flip_tail`` :648).  ``imgs`` ``(B, 3, s, s)``
    float32 integers in [0, 255] -> ``(n_out, 3, s, s)`` in [0, 1]."""
    out = imgs[:n_out].clone()
    for b in range(n_out):
        j = int(mix_idx[b])
        if j >= 0:
            r = np.float32(mix_r[b])
            out[b] = torch.floor(imgs[b] * float(r)
                                 + imgs[j] * float(np.float32(1.0) - r))
        if flip[b, 0]:
            out[b] = out[b].flip(-1)
        if flip[b, 1]:
            out[b] = out[b].flip(-2)
    return out * _RCP255


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def tap_sources(s: int, slot_rows, region, offset, minv, device):
    """The bilinear taps of every spec's render, before any colour.

    Returns ``(weights, taps)``: ``weights`` the four ``(B, s, s)`` blend
    weights (w00, w01, w10, w11); ``taps`` four ``(owner, lin)`` pairs in
    the same order, ``owner`` ``(B, s, s)`` int64 the owning slot or -1,
    ``lin`` the word's index into the flattened ``(R, s, s)`` rows (0 where
    unowned: an unowned coordinate, however far off or NaN, never reaches
    an integer cast)."""
    B, T = region.shape[:2]
    reg = _f32(region, device)[..., None, None]               # (B, T, 4, 1, 1)
    off = _f32(offset, device)
    m = _f32(minv, device).reshape(B, 6, 1, 1)
    srow = torch.as_tensor(np.asarray(slot_rows, np.int64), device=device)
    o = torch.arange(s, dtype=torch.float32, device=device)
    ox, oy = o[None, None, :], o[None, :, None]
    cx = m[:, 0] * ox + m[:, 1] * oy + m[:, 2]                # (B, s, s)
    cy = m[:, 3] * ox + m[:, 4] * oy + m[:, 5]
    x0, y0 = torch.floor(cx), torch.floor(cy)
    fx, fy = cx - x0, cy - y0
    weights = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    slot_ids = torch.arange(T, device=device).view(1, T, 1, 1)
    taps = []
    for qx, qy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
        inside = ((qx[:, None] >= reg[:, :, 0]) & (qx[:, None] < reg[:, :, 2])
                  & (qy[:, None] >= reg[:, :, 1])
                  & (qy[:, None] < reg[:, :, 3]))            # (B, T, s, s)
        owner = torch.where(inside, slot_ids, -1).amax(1)     # (B, s, s)
        valid = owner >= 0
        own = owner.clamp(min=0).reshape(B, s * s)
        offx = off[..., 0].gather(1, own).view(B, s, s)
        offy = off[..., 1].gather(1, own).view(B, s, s)
        row = srow.gather(1, own).view(B, s, s)
        sx = torch.where(valid, (qx - offx).clamp(0, s - 1), 0.0).long()
        sy = torch.where(valid, (qy - offy).clamp(0, s - 1), 0.0).long()
        lin = torch.where(valid, (row * s + sx) * s + sy, 0)
        taps.append((owner, lin))
    return weights, taps


def render_taps_plain(rows: torch.Tensor, slot_rows, region, offset, hsv,
                      minv, flip, mix_idx, mix_r, n_out: int) -> torch.Tensor:
    """Render specs from packed tile rows -> ``(n_out, 3, s, s)`` float32
    in [0, 1] on ``rows``' device.

    ``rows`` ``(R, s, s)`` int32 packed words, x-major (a pixel batch's
    tiles viewed as ``(B*T, s, s)``, or the device tile bank); the rest
    are host arrays: ``slot_rows`` ``(B, T)`` each slot's row, ``region``
    ``(B, T, 4)``, ``offset`` ``(B, T, 2)``, ``hsv`` ``(B, T, 3)``,
    ``minv`` ``(B, 2, 3)``, ``flip`` ``(n_out, 2)``, ``mix_idx`` and
    ``mix_r`` ``(n_out,)``."""
    dev = rows.device
    s = rows.shape[-1]
    B = region.shape[0]
    weights, taps = tap_sources(s, slot_rows, region, offset, minv, dev)
    gains = _f32(hsv, dev)
    flat = rows.reshape(-1)
    out = None
    for w, (owner, lin) in zip(weights, taps):
        own = owner.clamp(min=0).reshape(B, s * s)
        gh, gs, gv = (gains[..., j].gather(1, own).view(B, s, s)
                      for j in range(3))
        word = flat[lin]
        r = (word & 0xFF).float()
        g = ((word >> 8) & 0xFF).float()
        b = ((word >> 16) & 0xFF).float()
        # identity gains skip the (quantizing) HSV round trip (:243-244)
        ident = (gh == 1.0) & (gs == 1.0) & (gv == 1.0)
        rj, gj, bj = _hsv_jitter_planar(r, g, b, gh, gs, gv)
        col = torch.stack([torch.where(ident, r, rj),
                           torch.where(ident, g, gj),
                           torch.where(ident, b, bj)], 1)     # (B, 3, s, s)
        term = torch.where((owner >= 0)[:, None], col, PAD) * w[:, None]
        out = term if out is None else out + term
    return mix_flip_tail(torch.round(out), flip, mix_idx, mix_r, n_out)
