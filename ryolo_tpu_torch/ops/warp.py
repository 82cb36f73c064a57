"""Affine bilinear warp of the mosaic canvas: the plain PyTorch version.

Counterpart of ``ryolo_tpu/data/device_augment.py:434`` ``_warp_block``,
the plain twin of the TPU kernel ``ryolo_tpu/ops/pallas_warp.py:261``
(``warp_canvas_planar``).  The hand-written CUDA kernel
(``ops/csrc/warp.cu``, wrapper :mod:`ryolo_tpu_torch.ops.cuda_warp`)
computes the same values; this version runs on the CPU and is the kernel's
yardstick on the card.

Contract, per spec ``b`` and output pixel (row ``oy``, column ``ox``):

* ``cx = (m0·ox + m1·oy) + m2``, ``cy = (m3·ox + m4·oy) + m5`` in float32,
  ``x0 = floor(cx)``, ``fx = cx - x0`` (the same for y);
* buffer cell ``(bx, by) = clamp((x0, y0) + 1, 0, C-1)``; the four taps are
  ``canvas[b, c, bx(+1), by(+1)]``, and a tap past index C-1 reads PAD;
* ``ok = -1 <= x0 <= C-2 and -1 <= y0 <= C-2``; the blend
  ``c00·((1-fx)(1-fy)) + c01·(fx(1-fy)) + c10·((1-fx)fy) + c11·(fx·fy)``,
  summed left to right, is PAD where not ``ok``, then rounded half to even;
* an inactive spec (``active[b] == 0``) is PAD everywhere.
"""

from __future__ import annotations

from typing import Optional

import torch

PAD = 114.0


def warp_canvas_plain(canvas: torch.Tensor, minv: torch.Tensor,
                      out_size: int,
                      active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(B, 3, C, C)`` uint8 planar x-major canvases (``canvas[b, c, X,
    Y]`` is canvas cell ``(X-1, Y-1)``) and ``(B, 2, 3)`` float32 inverse
    affines -> ``(B, 3, s, s)`` float32 NCHW images holding integers in
    [0, 255]."""
    B, _, C, _ = canvas.shape
    s = int(out_size)
    dev = canvas.device
    o = torch.arange(s, dtype=torch.float32, device=dev)
    ox, oy = o[None, None, :], o[None, :, None]
    m = minv.reshape(B, 6)[:, :, None, None]
    cx = m[:, 0] * ox + m[:, 1] * oy + m[:, 2]            # (B, s, s)
    cy = m[:, 3] * ox + m[:, 4] * oy + m[:, 5]
    x0, y0 = torch.floor(cx), torch.floor(cy)
    fx, fy = cx - x0, cy - y0
    ok = (x0 >= -1.0) & (x0 <= C - 2.0) & (y0 >= -1.0) & (y0 <= C - 2.0)
    # clamp before the integer cast so far off-canvas coordinates stay
    # defined; clamped taps are masked out through `ok`
    bx = (x0.clamp(-2.0, float(C)).long() + 1).clamp(0, C - 1)
    by = (y0.clamp(-2.0, float(C)).long() + 1).clamp(0, C - 1)

    # one PAD row and column past the edge: the +1 taps of edge cells
    padded = torch.full((B, 3, C + 1, C + 1), int(PAD), dtype=torch.uint8,
                        device=dev)
    padded[:, :, :C, :C] = canvas
    flat = padded.reshape(B, 3, (C + 1) * (C + 1))
    idx = (bx * (C + 1) + by).reshape(B, 1, s * s).expand(B, 3, s * s)

    def tap(shift):
        return flat.gather(2, idx + shift).reshape(B, 3, s, s).float()

    c00, c01, c10, c11 = tap(0), tap(C + 1), tap(1), tap(C + 2)
    fx, fy = fx[:, None], fy[:, None]
    out = (c00 * ((1 - fx) * (1 - fy)) + c01 * (fx * (1 - fy))
           + c10 * ((1 - fx) * fy) + c11 * (fx * fy))
    out = torch.where(ok[:, None], out, PAD)
    if active is not None:
        out = torch.where(active.reshape(B, 1, 1, 1) != 0, out, PAD)
    return torch.round(out)
