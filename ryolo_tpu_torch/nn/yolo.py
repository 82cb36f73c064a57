"""Model assembly: backbone + PAN neck + CSL or KFIoU head
(counterpart of ``ryolo_tpu/nn/yolo.py``: ``STRIDES`` :23,
``make_anchors`` :26, ``make_rotated_anchors`` :36, ``Yolo`` :48)."""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from ryolo_tpu_torch.nn.backbones import BACKBONES
from ryolo_tpu_torch.nn.heads import (decode_csl, decode_csl_defer,
                                      decode_kfiou, decode_kfiou_scores,
                                      reshape_head)
from ryolo_tpu_torch.nn.necks import NECKS

STRIDES = (8, 16, 32)


def make_anchors(strides: Sequence[int], anchors: Sequence[Sequence[float]]):
    """Per-level (na, 2) anchor wh in grid units."""
    out = []
    for stride, anchor in zip(strides, anchors):
        lvl = [[anchor[i] / stride, anchor[i + 1] / stride]
               for i in range(0, len(anchor), 2)]
        out.append(np.asarray(lvl, np.float32))
    return out


def make_rotated_anchors(strides: Sequence[int],
                         anchors: Sequence[Sequence[float]],
                         angles_rad: Sequence[float]):
    """Per-level ``(na*len(angles), 3)`` ``[w, h, theta]`` anchors, each
    anchor size at every angle (``model/yolo.py:63-72``)."""
    out = []
    for stride, anchor in zip(strides, anchors):
        lvl = [[anchor[i] / stride, anchor[i + 1] / stride, ang]
               for i in range(0, len(anchor), 2) for ang in angles_rad]
        out.append(np.asarray(lvl, np.float32))
    return out


class Yolo(nn.Module):
    """Rotated-box YOLO, ``ver`` in {yolov4, yolov5, yolov7}, ``mode`` in
    {csl, kfiou}.

    ``forward(images_nchw, decode=...)``:
      * ``False``: the head maps ``(B, na*nf, gh, gw)`` per level;
      * ``True``: reference-layout f32 heads ``(B, na, gh, gw, nf)`` and
        the decoded rows ``(B, N, nc+6)``;
      * ``"defer"``: ``(heads, (rows_without_theta, heads))`` for
        :func:`ryolo_tpu_torch.eval.postprocess.post_process_defer`
        (CSL), ``(heads, ((conf, cls_id), heads))`` for
        :func:`ryolo_tpu_torch.eval.postprocess.post_process_kfiou_defer`
        (KFIoU: every box field resolves after selection).
    ``deploy=True`` is the fused inference structure
    (:func:`ryolo_tpu_torch.nn.deploy.fuse_for_inference`).
    """

    def __init__(self, n_classes: int, model_config: Any, mode: str = "csl",
                 ver: str = "yolov7", deploy: bool = False):
        super().__init__()
        if mode not in ("csl", "kfiou"):
            raise NotImplementedError(f"Loss mode : {mode} not found.")
        if ver not in BACKBONES:
            raise NotImplementedError(f"Yolo version : {ver} not found.")
        self.n_classes = n_classes
        self.model_config = model_config
        self.mode, self.ver, self.deploy = mode, ver, deploy
        if mode == "csl":
            self.nf = 4 + 180 + 1 + n_classes
            self.anchors = make_anchors(STRIDES, model_config["anchors"])
        else:
            self.nf = 5 + 1 + n_classes
            self.anchors = make_rotated_anchors(
                STRIDES, model_config["anchors"],
                [a * math.pi / 180.0 for a in model_config["angles"]])
        self.na = len(self.anchors[0])
        self.backbone = BACKBONES[ver](deploy=deploy)
        self.neck = NECKS[ver](self.nf * self.na, deploy=deploy)

    def forward(self, images: torch.Tensor, decode: bool | str = False):
        d3, d4, d5 = self.backbone(images)
        heads = self.neck(d5, d4, d3)
        if not decode:
            return heads
        if decode == "defer":
            if self.mode == "csl":
                return heads, (decode_csl_defer(heads, self.anchors, STRIDES,
                                                self.n_classes), heads)
            return heads, (decode_kfiou_scores(heads, self.na,
                                               self.n_classes), heads)
        outs = tuple(reshape_head(x, self.na, self.nf).float() for x in heads)
        fn = decode_csl if self.mode == "csl" else decode_kfiou
        return outs, fn(heads, self.anchors, STRIDES, self.n_classes)
