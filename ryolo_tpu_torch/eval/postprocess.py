"""Confidence filtering, candidate selection and rotated NMS over decoded rows.

Counterpart of ``ryolo_tpu/eval/postprocess.py`` (``_select_nms_compact``
:42, ``post_process_fixed`` :113, ``_class_max`` :136, ``deferred_theta``
:158, ``post_process_defer`` :198, ``post_process_kfiou_defer`` :220,
``_pp_tail`` :248; ``post_process_obb_defer``, for YOLO11's OBB head, has no
JAX twin), with the same semantics: score = obj x max class
conf, keep score > conf_thres, descending score with ties by candidate
index, cap ``max_nms``, NMS on boxes offset by ``class * 4096`` with
angles in degrees, cap ``max_det``; outputs ``(B, max_det, 7)`` rows
``[x, y, w, h, theta(rad), conf, cls]`` and a ``(B, max_det)`` valid
mask, kept rows first in score order.

The post-process runs as steps that a caller may also take one by one
(``Detect.infer`` replays each device step on a card as a CUDA graph):
``select_rows`` or ``select_scores``, and ``candidate_count``; the host read
in ``tail_width``, which picks the width ``k``; ``nms_fields``; ``nms_keep``;
``compact``.
"""

from __future__ import annotations

import math

import torch

from ryolo_tpu_torch.nn.heads import (deferred_kfiou_box, deferred_obb_box,
                                      first_max)
from ryolo_tpu_torch.ops.rotated_nms import nms_rotated_masked
from ryolo_tpu_torch.utils import trace

MAX_WH = 4096.0   # class-offset separation
MAX_NMS = 5000
MAX_DET = 1500
# Candidate width used when no image has more above-threshold rows than
# this: the same result as the full width, with narrower buffers.
SMALL_K = 512


def _class_max(predictions: torch.Tensor):
    """``max/argmax`` over classes of ``cls * obj``: a strict ``>`` chain in
    ascending class order, so the first maximum wins."""
    nc = predictions.shape[-1] - 6
    obj = predictions[..., 5]
    conf, cls_id = first_max(predictions[..., 6 + c] * obj
                              for c in range(nc))
    return conf, cls_id.float()


def deferred_theta(neck_outs, idx: torch.Tensor, na: int, nc: int):
    """CSL theta (radians) of the selected candidates only.

    ``neck_outs``: NCHW head maps ``(B, na*nf, gh, gw)``; ``idx``: ``(B, k)``
    global candidate indices (anchor-major, row-major, levels
    concatenated).  Gathers each candidate's 180 bin logits and takes the
    first maximum, as the full-width decode does.
    """
    b, k = idx.shape
    theta_bin = torch.zeros((b, k), dtype=torch.long, device=idx.device)
    bidx = torch.arange(b, device=idx.device)[:, None]
    off = 0
    for x in neck_outs:
        _, ch, gh, gw = x.shape
        nf, hw = ch // na, gh * gw
        local = idx - off
        in_lvl = (local >= 0) & (local < na * hw)
        anchor = torch.clamp(local // hw, 0, na - 1)
        pos = torch.clamp(local - anchor * hw, 0, hw - 1)
        bins = x.view(b, na, nf, hw)[bidx, anchor, 5 + nc:, pos]  # (b, k, 180)
        theta_bin = torch.where(in_lvl, torch.argmax(bins, -1), theta_bin)
        off += na * hw
    return (theta_bin.float() - 90.0) / 180.0 * math.pi


def nms_fields(payload, sel, k: int, theta_fn=None, box_fn=None):
    """Top-k selection at width ``k``: ``(rows, boxes, scores, valid)``,
    the selected candidates' rows ``(B, k, 7)`` ``[x, y, w, h, theta,
    conf, cls]`` by descending score, ties by index, and the NMS's inputs:
    their boxes offset by class with angles in degrees, scores and valid
    flags.  ``theta_fn(idx)`` resolves the selected candidates' theta
    (CSL); ``box_fn(idx) -> (B, k, 5)`` all their box fields, the payload
    then holding the class alone (KFIoU)."""
    # a stable ascending sort of -sel: descending score, ties by index
    idx = torch.sort(-sel, dim=1, stable=True).indices[:, :k]
    top_scores = sel.gather(1, idx)
    if box_fn is not None:
        tcls = payload[0].gather(1, idx)
        bx, by, bw, bh, bt = box_fn(idx).unbind(-1)
    else:
        bx, by, bw, bh, bt, tcls = (p.gather(1, idx) for p in payload)
    if theta_fn is not None:
        bt = theta_fn(idx)
    boxes = torch.stack([bx + tcls * MAX_WH, by + tcls * MAX_WH, bw, bh,
                         bt * (180.0 / math.pi)], -1)
    rows = torch.stack([bx, by, bw, bh, bt, top_scores, tcls], -1)
    return rows, boxes, top_scores, top_scores > 0.0


def nms_keep(boxes, scores, valid, iou_thres: float, max_det: int):
    """``keep`` ``(B, k)`` of :func:`nms_fields`' candidates, through this
    module's ``nms_rotated_masked``."""
    return nms_rotated_masked(boxes, scores, valid, iou_thres,
                              max_keep=max_det, presorted=True)[1]


def compact(rows, keep, max_det: int):
    """``(dets (B, max_det, 7), valid (B, max_det))``: the kept rows first,
    in score order; dropped rows sink and read 0."""
    b, k = keep.shape
    pos = torch.arange(k, device=keep.device).expand_as(keep)
    perm = torch.sort(torch.where(keep, pos, k), dim=1, stable=True).indices
    md = min(max_det, k)
    dets = rows.gather(1, perm[:, :md, None].expand(-1, md, 7))
    n_keep = torch.clamp(keep.sum(1), max=md)
    out_valid = pos[:, :md] < n_keep[:, None]
    dets = torch.where(out_valid[..., None], dets, 0.0)
    if md < max_det:  # keep the (B, max_det) output shape
        dets = torch.cat([dets, dets.new_zeros(b, max_det - md, 7)], 1)
        out_valid = torch.cat(
            [out_valid, out_valid.new_zeros(b, max_det - md)], 1)
    return dets, out_valid


def candidate_count(sel: torch.Tensor) -> torch.Tensor:
    """The most candidates above the threshold in one image (0-d)."""
    return (sel > 0.0).sum(1).max()


def tail_width(sel: torch.Tensor, max_nms: int, count=None) -> int:
    """The width ``k`` of the top-k selection: ``min(max_nms, N)``, or
    ``SMALL_K`` where no image has more candidates than that.  Deciding
    takes one host read of ``count`` (:func:`candidate_count` of ``sel``,
    computed here when not given), where the JAX package branches with
    ``lax.cond``."""
    k = min(max_nms, sel.shape[1])
    if k > SMALL_K:
        with trace.span("detect.host_read", sel.device):
            trace.count("sync.post_process_read")
            n_max = int(candidate_count(sel) if count is None else count)
        if n_max <= SMALL_K:
            k = SMALL_K
    return k


def _pp_tail(payload, sel, iou_thres: float, max_nms: int, max_det: int,
             theta_fn=None, box_fn=None):
    rows, boxes, scores, valid = nms_fields(
        payload, sel, tail_width(sel, max_nms), theta_fn, box_fn)
    return compact(rows, nms_keep(boxes, scores, valid, iou_thres, max_det),
                   max_det)


def _select(conf: torch.Tensor, conf_thres: float) -> torch.Tensor:
    # a Python scalar against a float32 tensor compares in float32, as
    # JAX's weakly typed threshold does, and sends nothing to the card
    return torch.where(conf > conf_thres, conf, -1.0)


def select_rows(predictions, conf_thres: float):
    """``(payload, sel)`` of decoded rows ``(B, N, nc+6)``: the fields x,
    y, w, h, theta and the class, each ``(B, N)``, and the score where it
    passes ``conf_thres``, else -1."""
    conf, cls_id = _class_max(predictions)
    sel = _select(conf, conf_thres)
    return [predictions[..., i] for i in range(5)] + [cls_id], sel


def select_scores(scores, conf_thres: float):
    """``(payload, sel)`` of the KFIoU or OBB ``(conf, cls_id)``: the class
    alone, and the score where it passes ``conf_thres``, else -1."""
    conf, cls_id = scores
    return [cls_id.float()], _select(conf, conf_thres)


def post_process_fixed(predictions: torch.Tensor, conf_thres: float,
                       iou_thres: float, max_nms: int = MAX_NMS,
                       max_det: int = MAX_DET):
    """Post-process fully decoded rows ``(B, N, nc+6)``."""
    payload, sel = select_rows(predictions, conf_thres)
    return _pp_tail(payload, sel, iou_thres, max_nms, max_det)


def post_process_defer(predictions: torch.Tensor, neck_outs, na: int,
                       nc: int, conf_thres: float, iou_thres: float,
                       max_nms: int = MAX_NMS, max_det: int = MAX_DET):
    """Post-process rows from ``decode_csl_defer`` (theta column 0): theta
    is resolved from the head maps for the selected candidates only."""
    payload, sel = select_rows(predictions, conf_thres)
    return _pp_tail(payload, sel, iou_thres, max_nms, max_det,
                    lambda idx: deferred_theta(neck_outs, idx, na, nc))


def post_process_kfiou_defer(scores, neck_outs, na: int, anchors, strides,
                             conf_thres: float, iou_thres: float,
                             max_nms: int = MAX_NMS, max_det: int = MAX_DET):
    """Post-process the KFIoU head with its whole box decode deferred:
    ``scores`` ``(conf, cls_id)`` from
    :func:`ryolo_tpu_torch.nn.heads.decode_kfiou_scores`, ``neck_outs`` the
    head maps, ``anchors`` the model's rotated anchors (``Yolo.anchors``).
    x, y, w, h and theta come from
    :func:`ryolo_tpu_torch.nn.heads.deferred_kfiou_box` for the selected
    candidates only; the result equals :func:`post_process_fixed` on the
    full :func:`ryolo_tpu_torch.nn.heads.decode_kfiou` rows."""
    payload, sel = select_scores(scores, conf_thres)
    return _pp_tail(payload, sel, iou_thres, max_nms, max_det,
                    box_fn=lambda idx: deferred_kfiou_box(
                        neck_outs, idx, na, anchors, strides))


def post_process_obb_defer(scores, neck_outs, nc: int, strides,
                           conf_thres: float, iou_thres: float,
                           max_nms: int = MAX_NMS, max_det: int = MAX_DET):
    """Post-process the OBB head with its box decode deferred: ``scores``
    ``(conf, cls_id)`` from
    :func:`ryolo_tpu_torch.nn.heads.decode_obb_scores`, ``neck_outs`` the
    head maps.  The DFL sides, the angle and the rotated centre come from
    :func:`ryolo_tpu_torch.nn.heads.deferred_obb_box` for the selected
    candidates only; the result equals :func:`post_process_fixed` on the
    full :func:`ryolo_tpu_torch.nn.heads.decode_obb` rows."""
    payload, sel = select_scores(scores, conf_thres)
    return _pp_tail(payload, sel, iou_thres, max_nms, max_det,
                    box_fn=lambda idx: deferred_obb_box(neck_outs, idx, nc,
                                                        strides))
