"""CSL head reshape and decode (counterpart of ``ryolo_tpu/nn/heads.py``).

Head maps are NCHW ``(B, na*nf, gh, gw)`` with anchor-major channels
``c = a*nf + f`` and per-anchor features ``[x, y, w, h, obj, cls...,
180 theta bins]`` (``heads.py:9-15``).  Decoded rows keep the JAX layout
and candidate order exactly: ``(B, N, nc+6)`` rows ``[x, y, w, h,
theta(rad), conf, cls...]``, candidate index = level offset +
``a*gh*gw + y*gw + x``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def reshape_head(x: torch.Tensor, na: int, nf: int) -> torch.Tensor:
    """``(B, na*nf, gh, gw)`` -> ``(B, na, gh, gw, nf)`` (``heads.py:33``)."""
    b, _, gh, gw = x.shape
    return x.view(b, na, nf, gh, gw).permute(0, 1, 3, 4, 2)


def _box_fields(x: torch.Tensor, anc: np.ndarray, stride: int, nc: int):
    """Sigmoid box/obj/cls fields of one level -> ``(B, na, 5+nc, gh, gw)``
    f32 as ``[x, y, w, h, obj, cls...]`` in pixels."""
    b, _, gh, gw = x.shape
    na = anc.shape[0]
    nf = x.shape[1] // na
    y = torch.sigmoid(x.view(b, na, nf, gh, gw)[:, :, :5 + nc].float())
    gy, gx = torch.meshgrid(torch.arange(gh, device=x.device),
                            torch.arange(gw, device=x.device), indexing="ij")
    grid = torch.stack([gx, gy]).float()  # (2, gh, gw)
    anc_t = torch.as_tensor(anc, dtype=torch.float32,
                            device=x.device).view(1, na, 2, 1, 1)
    pxy = (y[:, :, 0:2] * 2 - 0.5 + grid) * stride
    pwh = (y[:, :, 2:4] * 2) ** 2 * anc_t * stride
    return pxy, pwh, y[:, :, 4:5 + nc]


def _rows(fields, b: int, nc: int) -> torch.Tensor:
    # (B, na, nc+6, gh, gw) -> anchor-major, row-major candidate rows
    return torch.cat(fields, 2).permute(0, 1, 3, 4, 2).reshape(b, -1, nc + 6)


def decode_csl(outs: Sequence[torch.Tensor], anchors, strides, nc: int):
    """Full CSL decode, theta by argmax over the 180 bin logits
    (``heads.py:50``)."""
    decoded = []
    for x, anc, stride in zip(outs, anchors, strides):
        b, _, gh, gw = x.shape
        na = anc.shape[0]
        nf = x.shape[1] // na
        pxy, pwh, rest = _box_fields(x, anc, stride, nc)
        bins = x.view(b, na, nf, gh, gw)[:, :, 5 + nc:]
        theta = torch.argmax(bins, dim=2, keepdim=True).float()
        theta = (theta - 90.0) / 180.0 * math.pi
        decoded.append(_rows([pxy, pwh, theta, rest], b, nc))
    return torch.cat(decoded, 1)


def decode_csl_defer(outs: Sequence[torch.Tensor], anchors, strides,
                     nc: int):
    """CSL decode without the theta argmax: theta column 0, resolved after
    selection by :func:`ryolo_tpu_torch.eval.postprocess.deferred_theta`
    (``heads.py:104``).  Never reads the 180 bin channels."""
    decoded = []
    for x, anc, stride in zip(outs, anchors, strides):
        b = x.shape[0]
        pxy, pwh, rest = _box_fields(x, anc, stride, nc)
        decoded.append(_rows([pxy, pwh, torch.zeros_like(rest[:, :, :1]),
                              rest], b, nc))
    return torch.cat(decoded, 1)
