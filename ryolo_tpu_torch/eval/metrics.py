"""Rotated-detection mAP: matching, PR curves, COCO-interpolated AP.

A numpy copy of ``ryolo_tpu/eval/metrics.py`` (``pairwise_rotated_iou_host``
:25, ``match_image_detections`` :46, ``get_batch_statistics`` :113,
``compute_ap`` :140, ``ap_per_class`` :169, ``calculate_eval_stats`` :213):
greedy skew-IoU matching with per-target dedup, 101-point COCO-interpolated
AP, the F1-max operating point.

One difference: :func:`match_image_detections` always runs the C++ matcher
(:mod:`ryolo_tpu_torch.ops.native`) and lets its failure raise, where the
JAX package falls back to numpy.  The numpy formulation is kept as
:func:`match_image_detections_plain`, the matcher's plain version, which
only the tests call.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ryolo_tpu_torch.ops.native import (match_rotated_native,
                                        pairwise_rotated_iou_native)

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)  # mAP@.5:.95
_CONF_GRID = np.linspace(0.0, 1.0, 1000)  # PR-curve sampling grid
_RECALL_GRID = np.linspace(0.0, 1.0, 101)  # COCO 101-point AP grid
_RAD2DEG = 180.0 / np.pi


def pairwise_rotated_iou_host(boxes1, boxes2) -> np.ndarray:
    """Small-matrix pairwise skew-IoU of degree boxes on the host."""
    return pairwise_rotated_iou_native(boxes1, boxes2)


def _degree_geometry(pred, tar):
    angle_scale = np.array([1.0, 1.0, 1.0, 1.0, _RAD2DEG], np.float32)
    return pred[:, :5] * angle_scale, tar[:, 1:6] * angle_scale


def match_image_detections(pred: np.ndarray, tar: np.ndarray,
                           iouv: np.ndarray) -> np.ndarray:
    """True-positive flags for one image's detections at each IoU threshold.

    Args:
      pred: ``(n, 7)`` detections ``[x, y, w, h, θ(rad), conf, cls]`` in
        post-NMS order (confidence descending).
      tar: ``(m, 6)`` ground-truth rows ``[cls, x, y, w, h, θ(rad)]`` in
        pixels.
      iouv: ascending IoU thresholds; ``iouv[0]`` gates candidacy.

    Returns:
      ``(n, len(iouv))`` bool TP matrix, from one C++ call (class filter,
      IoU, first-max argmax, first claim per target).
    """
    if pred.shape[0] == 0 or tar.shape[0] == 0:
        return np.zeros((pred.shape[0], len(iouv)), dtype=bool)
    pred_geom, tar_geom = _degree_geometry(pred, tar)
    return match_rotated_native(pred_geom, pred[:, 6], tar_geom, tar[:, 0],
                                np.asarray(iouv))


def match_image_detections_plain(pred: np.ndarray, tar: np.ndarray,
                                 iouv: np.ndarray) -> np.ndarray:
    """The same TP matrix by the per-class numpy formulation.

    Predictions visited in confidence order each claim their single
    highest-IoU same-class target, succeeding iff the IoU clears
    ``iouv[0]`` and that target is still unclaimed.  A candidate fails only
    when an EARLIER candidate shares its argmax target, so the winners are
    the first occurrence of each argmax-target index among candidates,
    which ``np.unique(..., return_index=True)`` yields directly.
    """
    tp = np.zeros((pred.shape[0], len(iouv)), dtype=bool)
    if pred.shape[0] == 0 or tar.shape[0] == 0:
        return tp
    pred_geom, tar_geom = _degree_geometry(pred, tar)
    for cls in np.unique(tar[:, 0]):
        pi = np.flatnonzero(pred[:, 6] == cls)
        ti = np.flatnonzero(tar[:, 0] == cls)
        if pi.size == 0:
            continue
        iou = pairwise_rotated_iou_host(pred_geom[pi], tar_geom[ti])
        best_iou = iou.max(axis=1)
        best_tgt = iou.argmax(axis=1)
        cand = np.flatnonzero(best_iou > iouv[0])
        if cand.size == 0:
            continue
        _, first = np.unique(best_tgt[cand], return_index=True)
        winners = cand[first]
        tp[pi[winners]] = best_iou[winners, None] > iouv[None, :]
    return tp


def get_batch_statistics(outputs: Sequence[np.ndarray], targets: np.ndarray,
                         iouv: np.ndarray, niou: int) -> List[tuple]:
    """Per-image ``(tp, conf, pred_cls, target_cls)`` statistic tuples.

    Args:
      outputs: per-image ``(n_i, 7)`` post-process outputs.
      targets: ``(M, 7)`` rows ``[img_idx, cls, x, y, w, h, θ(rad)]`` in
        pixels for the whole batch.

    Images with neither predictions nor labels contribute nothing; images
    with labels but no predictions contribute an empty-TP tuple so recall
    still counts them.
    """
    stats = []
    for img_idx, pred in enumerate(outputs):
        tar = targets[targets[:, 0] == img_idx, 1:]
        tcls = tar[:, 0].tolist()
        if len(pred) == 0:
            if len(tar):
                stats.append((np.zeros((0, niou), bool), np.empty(0),
                              np.empty(0), tcls))
            continue
        tp = match_image_detections(pred, tar, np.asarray(iouv))
        stats.append((tp, pred[:, 5], pred[:, 6], tcls))
    return stats


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> np.ndarray:
    """101-point COCO-interpolated AP.

    Accepts column-stacked curves: ``recall``/``precision`` are ``(n, k)``
    cumulative curves in confidence-descending order (or ``(n,)`` for a
    single curve).  Returns ``(k,)`` AP values.

    Pad the precision curve with (r=0, p=1) and (r=last+0.01, p=0)
    sentinels, take the right-to-left running-max envelope, sample it on a
    uniform 101-point recall grid, integrate trapezoidally.
    """
    recall = np.atleast_2d(np.asarray(recall, np.float64).T).T
    precision = np.atleast_2d(np.asarray(precision, np.float64).T).T
    k = recall.shape[1]

    envelope = np.concatenate(
        [np.ones((1, k)), precision, np.zeros((1, k))], axis=0)
    envelope = np.flip(np.maximum.accumulate(np.flip(envelope, 0), 0), 0)
    grid = np.concatenate(
        [np.zeros((1, k)), recall, recall[-1:] + 0.01], axis=0)
    return np.array([
        np.trapezoid(np.interp(_RECALL_GRID, grid[:, j], envelope[:, j]),
                     _RECALL_GRID)
        for j in range(k)
    ])


def ap_per_class(tp, conf, pred_cls, target_cls):
    """Per-class precision/recall/AP with the F1-max operating point.

    Detections globally sorted by confidence; per class, cumulative TP/FP
    curves; AP per IoU threshold via :func:`compute_ap`; the reported
    P/R/F1 are read off 1000-point confidence-grid samples of the
    base-threshold curves at the confidence that maximizes mean F1.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    classes = np.unique(target_cls)
    n_cls, n_thr = len(classes), tp.shape[1]
    ap = np.zeros((n_cls, n_thr))
    p_curve = np.zeros((n_cls, _CONF_GRID.size))
    r_curve = np.zeros((n_cls, _CONF_GRID.size))

    for ci, cls in enumerate(classes):
        sel = pred_cls == cls
        n_labels = int((target_cls == cls).sum())
        if n_labels == 0 or not sel.any():
            continue
        tp_cum = tp[sel].cumsum(0)
        fp_cum = (1 - tp[sel]).cumsum(0)
        recall = tp_cum / (n_labels + 1e-16)
        precision = tp_cum / (tp_cum + fp_cum)
        ap[ci] = compute_ap(recall, precision)

        # conf is descending; flip to ascending for interp.  Above the
        # highest observed confidence nothing is predicted: recall 0,
        # precision 1.
        conf_asc = conf[sel][::-1]
        r_curve[ci] = np.interp(_CONF_GRID, conf_asc, recall[::-1, 0],
                                right=0.0)
        p_curve[ci] = np.interp(_CONF_GRID, conf_asc, precision[::-1, 0],
                                right=1.0)

    f1 = 2 * p_curve * r_curve / (p_curve + r_curve + 1e-16)
    best = int(f1.mean(0).argmax())
    return (p_curve[:, best], r_curve[:, best], ap, f1[:, best],
            classes.astype("int32"))


def calculate_eval_stats(stats, num_classes: int):
    """Aggregate concatenated statistics into mAP numbers: ``(nt, p, r,
    ap50, ap, f1, ap_class, mp, mr, map50, map50_95)``."""
    if len(stats) and stats[0].any():
        p, r, ap, f1, ap_class = ap_per_class(*stats)
        ap50 = ap[:, 0]
        ap = ap.mean(1)
        nt = np.bincount(stats[3].astype(np.int64), minlength=num_classes)
        return (nt, p, r, ap50, ap, f1, ap_class,
                p.mean(), r.mean(), ap50.mean(), ap.mean())
    return (np.zeros(1), 0.0, 0.0, [], [], 0.0, [], 0.0, 0.0, 0.0, 0.0)
