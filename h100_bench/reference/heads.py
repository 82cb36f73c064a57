"""Frozen copy of ``ryolo_tpu_torch/nn/heads.py`` at commit d329eff for the
benchmark's plain reference; it imports nothing of the port.

CSL and KFIoU head reshape and decode (counterpart of
``ryolo_tpu/nn/heads.py``: ``reshape_head`` :33, ``decode_csl`` :50,
``decode_csl_defer`` :104, ``decode_kfiou_scores`` :142,
``deferred_kfiou_box`` :198, ``decode_kfiou`` :245).

Head maps are NCHW ``(B, na*nf, gh, gw)`` with anchor-major channels
``c = a*nf + f`` and per-anchor features (``heads.py:9-15``)

* CSL (``nf = nc + 185``): ``[x, y, w, h, obj, cls..., 180 theta bins]``;
* KFIoU (``nf = nc + 6``): ``[x, y, w, h, theta, obj, cls...]``.

Decoded rows keep the JAX layout and candidate order exactly: ``(B, N,
nc+6)`` rows ``[x, y, w, h, theta(rad), conf, cls...]``, candidate index =
level offset + ``a*gh*gw + y*gw + x``; ``x.view(B, na, nf, gh, gw)`` is
that order already.  The KFIoU inference theta is ``(sigmoid - 0.5) *
0.5236 + anchor angle``, not wrapped (the loss's decode differs on
purpose: :mod:`ryolo_tpu_torch.losses.kfiou`).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .render import to_device

KFIOU_THETA_WIDTH = 0.5236  # inference decode, model/yololayer.py:96


def reshape_head(x: torch.Tensor, na: int, nf: int) -> torch.Tensor:
    """``(B, na*nf, gh, gw)`` -> ``(B, na, gh, gw, nf)`` (``heads.py:33``)."""
    b, _, gh, gw = x.shape
    return x.view(b, na, nf, gh, gw).permute(0, 1, 3, 4, 2)


def _anchor_table(anc, device) -> torch.Tensor:
    """A level's grid-unit anchors ``(na, 2|3)`` on ``device``, sent up
    without blocking the host."""
    return to_device(np.asarray(anc, np.float32), device)


def _sigmoid_fields(x: torch.Tensor, na: int, n: int) -> torch.Tensor:
    """f32 sigmoids of each anchor's first ``n`` channels, ``(B, na, n,
    gh, gw)``."""
    b, c, gh, gw = x.shape
    return torch.sigmoid(x.view(b, na, c // na, gh, gw)[:, :, :n].float())


def _box_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """KFIoU box fields' sigmoid, taken in float64 and rounded to float32.
    PyTorch's CPU kernel rounds a float32 sigmoid one way in a SIMD block
    and another in a loop's remainder, so a box would depend on where its
    candidate lies in the tensor; rounded from float64 it does not, and
    :func:`deferred_kfiou_box` equals :func:`decode_kfiou` to the bit."""
    return torch.sigmoid(x.double()).float()


def _box_xywh(y: torch.Tensor, anc_wh: torch.Tensor, stride: int):
    """Pixel centres and sizes from the sigmoids ``y`` ``(B, na, >=4, gh,
    gw)`` and the anchors' grid-unit ``(na, 2)`` sizes."""
    gh, gw = y.shape[-2:]
    gy, gx = torch.meshgrid(torch.arange(gh, device=y.device),
                            torch.arange(gw, device=y.device), indexing="ij")
    grid = torch.stack([gx, gy]).float()  # (2, gh, gw)
    anc_wh = anc_wh.view(1, -1, 2, 1, 1)
    pxy = (y[:, :, 0:2] * 2 - 0.5 + grid) * stride
    pwh = (y[:, :, 2:4] * 2) ** 2 * anc_wh * stride
    return pxy, pwh


def _rows(fields, b: int, nc: int) -> torch.Tensor:
    # (B, na, nc+6, gh, gw) -> anchor-major, row-major candidate rows
    return torch.cat(fields, 2).permute(0, 1, 3, 4, 2).reshape(b, -1, nc + 6)


def _csl_fields(x, anc, stride: int, nc: int):
    y = _sigmoid_fields(x, anc.shape[0], 5 + nc)
    pxy, pwh = _box_xywh(y, _anchor_table(anc, x.device), stride)
    return pxy, pwh, y[:, :, 4:5 + nc]


def decode_csl(outs: Sequence[torch.Tensor], anchors, strides, nc: int):
    """Full CSL decode, theta by argmax over the 180 bin logits
    (``heads.py:50``)."""
    decoded = []
    for x, anc, stride in zip(outs, anchors, strides):
        b, _, gh, gw = x.shape
        na = anc.shape[0]
        nf = x.shape[1] // na
        pxy, pwh, rest = _csl_fields(x, anc, stride, nc)
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
        pxy, pwh, rest = _csl_fields(x, anc, stride, nc)
        decoded.append(_rows([pxy, pwh, torch.zeros_like(rest[:, :, :1]),
                              rest], b, nc))
    return torch.cat(decoded, 1)


def decode_kfiou(outs: Sequence[torch.Tensor], anchors, strides, nc: int):
    """Full KFIoU decode with the rotated anchors ``(na, 3)`` ``[w, h,
    theta]`` (``heads.py:245``)."""
    decoded = []
    for x, anc, stride in zip(outs, anchors, strides):
        b, c, gh, gw = x.shape
        na = anc.shape[0]
        yb = _box_sigmoid(x.view(b, na, c // na, gh, gw)[:, :, :5])
        table = _anchor_table(anc, x.device)
        pxy, pwh = _box_xywh(yb, table[:, :2], stride)
        pth = (yb[:, :, 4:5] - 0.5) * KFIOU_THETA_WIDTH \
            + table[:, 2].view(1, na, 1, 1, 1)
        # decode_kfiou_scores' own call: the same float32 sigmoid bits
        scores = _sigmoid_fields(x, na, 6 + nc)[:, :, 5:]
        decoded.append(_rows([pxy, pwh, pth, scores], b, nc))
    return torch.cat(decoded, 1)


def decode_kfiou_scores(outs: Sequence[torch.Tensor], na: int, nc: int):
    """KFIoU candidate scores without the box decode -> ``(conf, cls_id)``,
    each ``(B, N)`` (``heads.py:142``): ``conf = max_c sigmoid(cls_c) *
    sigmoid(obj)`` in f32, the first maximum winning (a strict ``>`` chain
    in class order), the same products that
    :func:`ryolo_tpu_torch.eval.postprocess.post_process_fixed` takes on
    :func:`decode_kfiou`'s rows."""
    confs, ids = [], []
    for x in outs:
        b = x.shape[0]
        y = _sigmoid_fields(x, na, 6 + nc)
        sobj = y[:, :, 5]
        conf = y[:, :, 6] * sobj
        cls_id = torch.zeros_like(conf, dtype=torch.int32)
        for c in range(1, nc):
            s = y[:, :, 6 + c] * sobj
            hit = s > conf
            conf = torch.where(hit, s, conf)
            cls_id = torch.where(hit, c, cls_id)
        confs.append(conf.reshape(b, -1))
        ids.append(cls_id.reshape(b, -1))
    return torch.cat(confs, 1), torch.cat(ids, 1)


def deferred_kfiou_box(neck_outs: Sequence[torch.Tensor], idx: torch.Tensor,
                       na: int, anchors, strides) -> torch.Tensor:
    """KFIoU boxes ``(B, k, 5)`` ``[x, y, w, h, theta]`` of the selected
    candidates only (``heads.py:198``): ``idx`` ``(B, k)`` global candidate
    indices in :func:`decode_kfiou`'s order.  Gathers each candidate's five
    box logits and its anchor row, and decodes them as the full-width
    decode does, to the bit."""
    b, k = idx.shape
    out = torch.zeros((b, k, 5), dtype=torch.float32, device=idx.device)
    bidx = torch.arange(b, device=idx.device)[:, None]
    off = 0
    for x, anc, stride in zip(neck_outs, anchors, strides):
        _, ch, gh, gw = x.shape
        nf, hw = ch // na, gh * gw
        local = idx - off
        in_lvl = (local >= 0) & (local < na * hw)
        anchor = torch.clamp(local // hw, 0, na - 1)
        pos = torch.clamp(local - anchor * hw, 0, hw - 1)
        y = _box_sigmoid(x.view(b, na, nf, hw)[bidx, anchor, :5, pos])
        a = _anchor_table(anc, x.device)[anchor]            # (b, k, 3)
        grid = torch.stack([pos % gw, pos // gw], -1).float()
        pxy = (y[..., 0:2] * 2 - 0.5 + grid) * stride
        pwh = (y[..., 2:4] * 2) ** 2 * a[..., :2] * stride
        pth = (y[..., 4:5] - 0.5) * KFIOU_THETA_WIDTH + a[..., 2:3]
        out = torch.where(in_lvl[..., None], torch.cat([pxy, pwh, pth], -1),
                          out)
        off += na * hw
    return out
