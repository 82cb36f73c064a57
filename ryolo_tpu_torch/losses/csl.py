"""CSL (Circular Smooth Label) training loss on the fixed candidate lattice
(counterpart of ``ryolo_tpu/losses/csl.py:28`` ``csl_loss``, itself the
functional form of the reference's ``ComputeCSLLoss``,
``lib/loss.py:153-331``): CIoU box regression, 180-bin BCE angle
classification, CIoU-scored objectness BCE and one-hot class BCE, with the
same weights and reductions.  With a ``reducer`` (data parallelism) each
mean is this rank's share of the global batch's
(:mod:`ryolo_tpu_torch.losses.common`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ryolo_tpu_torch.losses.assign import (build_candidates,
                                           gather_predictions, scatter_conf)
from ryolo_tpu_torch.losses.common import (bbox_ciou, bce_loss, level_counts,
                                           masked_mean, reduce_items)

LAMBDA_THETA = 0.5  # lib/loss.py:160
GR = 1.0            # iou-ratio blending, lib/loss.py:161
_SAFE_BOX = (0.5, 0.5, 1.0, 1.0)


def csl_loss(outputs: Sequence[torch.Tensor], tgt: torch.Tensor,
             tgt_csl: torch.Tensor, tgt_mask: torch.Tensor,
             anchors: Sequence[torch.Tensor], nc: int, hyp: dict,
             reducer=None):
    """``outputs``: 3 NCHW head maps ``(B, na·(nc+185), gh, gw)``; ``tgt``
    (B, T, 6), ``tgt_csl`` (B, T, 180), ``tgt_mask`` (B, T) bool;
    ``anchors``: per level ``(na, 2)`` grid-unit tensors on the maps'
    device.  Returns ``(total_loss, items)``, ``items`` a dict of 0-dim
    tensors (reading them is the caller's host sync).  With ``reducer``
    (a :class:`~ryolo_tpu_torch.parallel.mesh.Mesh`), ``total_loss`` is this
    rank's share of the global loss and ``items`` the global items."""
    lam_box, lam_obj, lam_cls = hyp["box"], hyp["obj"], hyp["cls"]
    obj_pw = hyp.get("obj_pw", 1.0)
    cls_pw = hyp.get("cls_pw", 1.0)
    fl_gamma = hyp.get("fl_gamma", 0.0)

    cands = [build_candidates(tgt, tgt_mask, anc, pi.shape[2], pi.shape[3],
                              tgt_csl=tgt_csl)
             for pi, anc in zip(outputs, anchors)]
    counts, shards = level_counts([c.valid for c in cands], reducer)
    reg_loss = theta_loss = conf_loss = cls_loss = 0.0
    for pi, anc, cand, n in zip(outputs, anchors, cands, counts.unbind()):
        na = anc.shape[0]
        B, c, gh, gw = pi.shape
        nf = c // na
        ps = gather_predictions(pi, cand, na)                 # (B, K, nf)
        m = cand.valid

        # decoded box in grid units (lib/loss.py:212-214)
        pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anc[cand.anchor]
        pbox = torch.cat([pxy, pwh], -1)
        tbox = torch.cat([cand.txy, cand.twh], -1)
        # padded rows get a harmless box, so CIoU never sees a 0-sized one
        # (built on the device: a host tensor would cost a copy and a sync)
        safe = torch.stack([pbox.new_full((), v) for v in _SAFE_BOX])
        tbox = torch.where(m[..., None], tbox, safe)
        pbox = torch.where(m[..., None], pbox, safe)

        ciou = bbox_ciou(pbox, tbox)                          # (B, K)
        reg_loss = reg_loss + masked_mean(1.0 - ciou, m, n)

        score_iou = torch.clamp_min(ciou, 0.0).detach()
        tconf = scatter_conf((B, na, gh, gw), cand,
                             (1.0 - GR) + GR * score_iou)
        pobj = pi.reshape(B, na, nf, gh, gw)[:, :, 4].float()
        conf_loss = conf_loss + bce_loss(pobj, tconf, pos_weight=obj_pw,
                                         fl_gamma=fl_gamma, shards=shards)
        if nc > 1:
            onehot = F.one_hot(cand.cls, nc).float()
            cls_loss = cls_loss + bce_loss(
                ps[..., 5:5 + nc], onehot, pos_weight=cls_pw,
                fl_gamma=fl_gamma, mask=m[..., None], count=n * nc)
        theta_loss = theta_loss + bce_loss(
            ps[..., 5 + nc:], cand.tcsl, pos_weight=1.0, fl_gamma=fl_gamma,
            mask=m[..., None], count=n * cand.tcsl.shape[-1])

    reg_loss = lam_box * reg_loss
    theta_loss = LAMBDA_THETA * theta_loss
    conf_loss = lam_obj * conf_loss
    cls_loss = lam_cls * cls_loss
    total = reg_loss + conf_loss + cls_loss + theta_loss
    items = {"reg_loss": reg_loss, "theta_loss": theta_loss,
             "conf_loss": conf_loss, "cls_loss": cls_loss,
             "total_loss": total}
    return total, reduce_items(items, reducer)
