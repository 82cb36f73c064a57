"""KFIoU training loss on the fixed candidate lattice (counterpart of
``ryolo_tpu/losses/kfiou.py:30`` ``kfiou_loss``, the functional form of
the reference's ``ComputeKFIoULoss``, ``lib/loss.py:334-492``):
Kalman-filter IoU regression over (x, y, w, h, theta), KFIoU-scored
objectness BCE (the obj logit is channel 5, ``lib/loss.py:407``) and
one-hot class BCE, with the same weights and reductions.

The loss decodes theta as ``norm_angle((sigmoid - 0.5) * 1.1 + anchor
angle)``, wider than the inference decode's 0.5236 and wrapped
(``model/yololayer.py:96`` against ``lib/loss.py:390``): the reference's
asymmetry, kept (``tests/test_kfiou_asymmetry.py``).  With a ``reducer``
(data parallelism) each mean is this rank's share of the global batch's
(:mod:`ryolo_tpu_torch.losses.common`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ryolo_tpu_torch.geometry import norm_angle
from ryolo_tpu_torch.losses.assign import (build_candidates,
                                           gather_predictions, scatter_conf)
from ryolo_tpu_torch.losses.common import (bce_loss, kf_loss, level_counts,
                                           reduce_items)

GR = 1.0                 # iou-ratio blending, lib/loss.py:353
LOSS_THETA_WIDTH = 1.1   # lib/loss.py:390
_SAFE_BOX = (0.5, 0.5, 1.0, 1.0, 0.0)


def loss_theta(t: torch.Tensor, anc_theta: torch.Tensor) -> torch.Tensor:
    """The loss's theta from the logit ``t``: ``norm_angle((sigmoid(t) -
    0.5) * 1.1 + anchor angle)`` (``lib/loss.py:390``)."""
    return norm_angle((torch.sigmoid(t) - 0.5) * LOSS_THETA_WIDTH + anc_theta)


def kfiou_loss(outputs: Sequence[torch.Tensor], tgt: torch.Tensor,
               tgt_mask: torch.Tensor, anchors: Sequence[torch.Tensor],
               nc: int, hyp: dict, reducer=None):
    """``outputs``: 3 NCHW head maps ``(B, na·(nc+6), gh, gw)``; ``tgt``
    (B, T, 6), ``tgt_mask`` (B, T) bool; ``anchors``: per level ``(na, 3)``
    ``[w, h, theta]`` grid-unit tensors on the maps' device.  Returns
    ``(total_loss, items)``, ``items`` a dict of 0-dim tensors; with
    ``reducer``, as :func:`ryolo_tpu_torch.losses.csl.csl_loss`."""
    lam_box, lam_obj, lam_cls = hyp["box"], hyp["obj"], hyp["cls"]
    obj_pw = hyp.get("obj_pw", 1.0)
    cls_pw = hyp.get("cls_pw", 1.0)
    fl_gamma = hyp.get("fl_gamma", 0.0)

    cands = [build_candidates(tgt, tgt_mask, anc, pi.shape[2], pi.shape[3],
                              angle_gate=True)
             for pi, anc in zip(outputs, anchors)]
    counts, shards = level_counts([c.valid for c in cands], reducer)
    reg_loss = conf_loss = cls_loss = 0.0
    for pi, anc, cand, n in zip(outputs, anchors, cands, counts.unbind()):
        na = anc.shape[0]
        B, c, gh, gw = pi.shape
        nf = c // na
        ps = gather_predictions(pi, cand, na)                 # (B, K, nf)
        m = cand.valid

        anc_rows = anc[cand.anchor]                           # (B, K, 3)
        pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anc_rows[..., :2]
        pa = loss_theta(ps[..., 4:5], anc_rows[..., 2:3])
        pbox = torch.cat([pxy, pwh, pa], -1)
        tbox = torch.cat([cand.txy, cand.twh, cand.ttheta[..., None]], -1)
        # padded rows get a harmless box (built on the device: no sync)
        safe = torch.stack([pbox.new_full((), v) for v in _SAFE_BOX])
        pbox = torch.where(m[..., None], pbox, safe)
        tbox = torch.where(m[..., None], tbox, safe)

        kf, kfiou = kf_loss(pbox, tbox, fun="exp", mask=m, count=n)
        reg_loss = reg_loss + kf

        score = torch.clamp_min(kfiou, 0.0).detach()
        tconf = scatter_conf((B, na, gh, gw), cand, (1.0 - GR) + GR * score)
        pobj = pi.reshape(B, na, nf, gh, gw)[:, :, 5].float()
        conf_loss = conf_loss + bce_loss(pobj, tconf, pos_weight=obj_pw,
                                         fl_gamma=fl_gamma, shards=shards)
        if nc > 1:
            onehot = F.one_hot(cand.cls, nc).float()
            cls_loss = cls_loss + bce_loss(
                ps[..., 6:], onehot, pos_weight=cls_pw, fl_gamma=fl_gamma,
                mask=m[..., None], count=n * nc)

    reg_loss = lam_box * reg_loss
    conf_loss = lam_obj * conf_loss
    cls_loss = lam_cls * cls_loss
    total = reg_loss + conf_loss + cls_loss
    items = {"reg_loss": reg_loss, "conf_loss": conf_loss,
             "cls_loss": cls_loss, "total_loss": total}
    return total, reduce_items(items, reducer)
