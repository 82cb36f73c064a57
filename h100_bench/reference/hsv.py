"""Frozen copy of ``ryolo_tpu_torch/ops/hsv.py`` at commit d329eff for the
benchmark's plain reference; it imports nothing of the port.

HSV jitter with the reference's uint8-LUT semantics, on PyTorch tensors.

Counterpart of ``ryolo_tpu/data/device_augment.py`` ``hsv_jitter`` :114
and ``_hsv_jitter_planar`` :129.  Used by both render routes of
:mod:`ryolo_tpu_torch.data.device_augment` (the canvas HSV pass and the
plain tap renderer :mod:`ryolo_tpu_torch.ops.render`); the render kernel
``ops/csrc/render.cu`` repeats these expressions in the same order.
"""

from __future__ import annotations

import numpy as np
import torch


def _recip(c: float) -> float:
    return float(np.float32(1.0) / np.float32(c))


# XLA compiles a division by a constant as a multiplication by its float32
# reciprocal, and CUDA PyTorch divides by a host scalar the same way; the
# port multiplies by the reciprocal on every device, so the CPU, the card
# and the jitted JAX renderer agree bit for bit.
_RCP30, _RCP255 = _recip(30.0), _recip(255.0)


def _select(i, values, default):
    """``jnp.select([i == 0, i == 1, ...], values, default)``."""
    out = default
    for k in range(len(values) - 1, -1, -1):
        out = torch.where(i == k, values[k], out)
    return out


def _hsv_jitter_planar(r, g, b, gh, gs, gv):
    """HSV jitter with the reference's uint8-LUT semantics on channel planes
    (``_hsv_jitter_planar`` :129: the same float32 expressions in the same
    order).  Returns the (r, g, b) planes, rounded."""
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d > 0, d, 1.0)
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    h = torch.where(d > 0, h * 30.0, 0.0)
    h = torch.where(h < 0, h + 180.0, h)
    h = torch.round(h)
    h = torch.where(h >= 180.0, 0.0, h)
    s = torch.round(torch.where(mx > 0, 255.0 * d / torch.where(mx > 0, mx, 1.0),
                                0.0))
    v = mx
    # the jitter: hue wraps at 180, saturation and value clip at 255
    h = torch.floor(h * gh) % 180.0
    s = torch.clamp(torch.floor(s * gs), 0.0, 255.0)
    v = torch.clamp(torch.floor(v * gv), 0.0, 255.0)
    # back to RGB (cv2's 8-bit convention)
    h6 = h * _RCP30
    i = torch.floor(h6)
    f = h6 - i
    sf = s * _RCP255
    p = v * (1.0 - sf)
    q = v * (1.0 - sf * f)
    t = v * (1.0 - sf * (1.0 - f))
    i = i.to(torch.int32) % 6
    ro = _select(i, [v, q, p, p, t], v)
    go = _select(i, [t, v, v, q, p], p)
    bo = _select(i, [p, p, t, v, v], q)
    return torch.round(ro), torch.round(go), torch.round(bo)


def hsv_jitter(rgb: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """:func:`_hsv_jitter_planar` on ``(..., 3)`` RGB; ``gains`` ``(..., 3)``
    (``hsv_jitter`` :114)."""
    r, g, b = _hsv_jitter_planar(rgb[..., 0], rgb[..., 1], rgb[..., 2],
                                 gains[..., 0], gains[..., 1], gains[..., 2])
    return torch.stack([r, g, b], -1)
