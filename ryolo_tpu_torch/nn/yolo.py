"""Model assembly: backbone + PAN neck + CSL head
(counterpart of ``ryolo_tpu/nn/yolo.py``: ``STRIDES`` :23,
``make_anchors`` :26, ``Yolo`` :48)."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from ryolo_tpu_torch.nn.backbones import BACKBONES
from ryolo_tpu_torch.nn.heads import decode_csl, decode_csl_defer, reshape_head
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


class Yolo(nn.Module):
    """Rotated-box YOLO, ``ver`` in {yolov4, yolov5, yolov7}, ``mode='csl'``.

    ``forward(images_nchw, decode=...)``:
      * ``False``: the head maps ``(B, na*nf, gh, gw)`` per level;
      * ``True``: reference-layout f32 heads ``(B, na, gh, gw, nf)`` and
        the decoded rows ``(B, N, nc+6)``;
      * ``"defer"``: ``(heads, (rows_without_theta, heads))`` for
        :func:`ryolo_tpu_torch.eval.postprocess.post_process_defer`.
    ``deploy=True`` is the fused inference structure
    (:func:`ryolo_tpu_torch.nn.deploy.fuse_for_inference`).
    """

    def __init__(self, n_classes: int, model_config: Any, mode: str = "csl",
                 ver: str = "yolov7", deploy: bool = False):
        super().__init__()
        if mode != "csl":
            raise NotImplementedError(
                f"mode {mode!r}: only csl is ported so far; KFIoU comes "
                "with ROADMAP §A2")
        if ver not in BACKBONES:
            raise NotImplementedError(f"Yolo version : {ver} not found.")
        self.n_classes = n_classes
        self.model_config = model_config
        self.mode, self.ver, self.deploy = mode, ver, deploy
        self.nf = 4 + 180 + 1 + n_classes
        self.anchors = make_anchors(STRIDES, model_config["anchors"])
        self.na = len(self.anchors[0])
        self.backbone = BACKBONES[ver](deploy=deploy)
        self.neck = NECKS[ver](self.nf * self.na, deploy=deploy)

    def forward(self, images: torch.Tensor, decode: bool | str = False):
        d3, d4, d5 = self.backbone(images)
        heads = self.neck(d5, d4, d3)
        if not decode:
            return heads
        if decode == "defer":
            return heads, (decode_csl_defer(heads, self.anchors, STRIDES,
                                            self.n_classes), heads)
        outs = tuple(reshape_head(x, self.na, self.nf).float() for x in heads)
        return outs, decode_csl(heads, self.anchors, STRIDES, self.n_classes)
