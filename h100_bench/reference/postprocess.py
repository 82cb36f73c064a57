"""Frozen copy of ``ryolo_tpu_torch/eval/postprocess.py`` at commit d329eff for the
benchmark's plain reference; it imports nothing of the port.

Confidence filtering, candidate selection and rotated NMS over decoded rows.

Counterpart of ``ryolo_tpu/eval/postprocess.py`` (``_select_nms_compact``
:42, ``post_process_fixed`` :113, ``_class_max`` :136, ``deferred_theta``
:158, ``post_process_defer`` :198, ``post_process_kfiou_defer`` :220,
``_pp_tail`` :248), with the same semantics: score = obj x max class
conf, keep score > conf_thres, descending score with ties by candidate
index, cap ``max_nms``, NMS on boxes offset by ``class * 4096`` with
angles in degrees, cap ``max_det``; outputs ``(B, max_det, 7)`` rows
``[x, y, w, h, theta(rad), conf, cls]`` and a ``(B, max_det)`` valid
mask, kept rows first in score order.
"""

from __future__ import annotations

import math

import torch

from .heads import deferred_kfiou_box
from .rotated_nms import nms_rotated_masked

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
    conf = predictions[..., 6] * obj
    cls_id = torch.zeros_like(conf, dtype=torch.int32)
    for c in range(1, nc):
        s = predictions[..., 6 + c] * obj
        hit = s > conf
        conf = torch.where(hit, s, conf)
        cls_id = torch.where(hit, c, cls_id)
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


def _select_nms_compact(payload, sel, k: int, iou_thres: float,
                        max_det: int, theta_fn=None, box_fn=None):
    """Top-k selection, rotated NMS and compaction at width ``k``.
    ``theta_fn(idx)`` resolves the selected candidates' theta (CSL);
    ``box_fn(idx) -> (B, k, 5)`` all their box fields, the payload then
    holding the class alone (KFIoU)."""
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
    nms_boxes = torch.stack([bx + tcls * MAX_WH, by + tcls * MAX_WH, bw, bh,
                             bt * (180.0 / math.pi)], -1)
    _, keep = nms_rotated_masked(nms_boxes, top_scores, top_scores > 0.0,
                                 iou_thres, max_keep=max_det, presorted=True)

    # kept rows first, in score order; dropped rows sink
    pos = torch.arange(k, device=sel.device).expand_as(keep)
    perm = torch.sort(torch.where(keep, pos, k), dim=1, stable=True).indices
    md = min(max_det, k)
    rows = torch.stack([bx, by, bw, bh, bt, top_scores, tcls], -1)
    dets = rows.gather(1, perm[:, :md, None].expand(-1, md, 7))
    n_keep = torch.clamp(keep.sum(1), max=md)
    out_valid = torch.arange(md, device=sel.device)[None, :] < n_keep[:, None]
    dets = torch.where(out_valid[..., None], dets, 0.0)
    if md < max_det:  # keep the (B, max_det) output shape
        b = dets.shape[0]
        dets = torch.cat([dets, dets.new_zeros(b, max_det - md, 7)], 1)
        out_valid = torch.cat(
            [out_valid, out_valid.new_zeros(b, max_det - md)], 1)
    return dets, out_valid


def _pp_tail(payload, sel, iou_thres: float, max_nms: int, max_det: int,
             theta_fn=None, box_fn=None):
    k = min(max_nms, sel.shape[1])
    if k > SMALL_K:
        # one host read, where the JAX package branches with lax.cond
        n_max = int((sel > 0.0).sum(1).max())
        if n_max <= SMALL_K:
            k = SMALL_K
    return _select_nms_compact(payload, sel, k, iou_thres, max_det, theta_fn,
                               box_fn)


def _select(conf: torch.Tensor, conf_thres: float) -> torch.Tensor:
    thres = torch.tensor(conf_thres, dtype=torch.float32, device=conf.device)
    return torch.where(conf > thres, conf, -1.0)


def _payload_and_sel(predictions, conf_thres: float):
    conf, cls_id = _class_max(predictions)
    sel = _select(conf, conf_thres)
    return [predictions[..., i] for i in range(5)] + [cls_id], sel


def post_process_fixed(predictions: torch.Tensor, conf_thres: float,
                       iou_thres: float, max_nms: int = MAX_NMS,
                       max_det: int = MAX_DET):
    """Post-process fully decoded rows ``(B, N, nc+6)``."""
    payload, sel = _payload_and_sel(predictions, conf_thres)
    return _pp_tail(payload, sel, iou_thres, max_nms, max_det)


def post_process_defer(predictions: torch.Tensor, neck_outs, na: int,
                       nc: int, conf_thres: float, iou_thres: float,
                       max_nms: int = MAX_NMS, max_det: int = MAX_DET):
    """Post-process rows from ``decode_csl_defer`` (theta column 0): theta
    is resolved from the head maps for the selected candidates only."""
    payload, sel = _payload_and_sel(predictions, conf_thres)
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
    conf, cls_id = scores
    return _pp_tail([cls_id.float()], _select(conf, conf_thres), iou_thres,
                    max_nms, max_det,
                    box_fn=lambda idx: deferred_kfiou_box(
                        neck_outs, idx, na, anchors, strides))
