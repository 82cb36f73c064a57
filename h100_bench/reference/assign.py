"""Frozen copy of ``ryolo_tpu_torch/losses/assign.py`` at commit d329eff for the
benchmark's plain reference; it imports nothing of the port.

Fixed-shape YOLOv5-style target assignment (counterpart of
``ryolo_tpu/losses/assign.py``: ``Candidates`` :36, ``build_candidates``
:52, ``gather_predictions`` :134, ``scatter_conf`` :151).

The reference's ``build_targets`` (``lib/loss.py:270-331``) builds index
lists of dynamic size; here the candidates form a dense lattice
``(B, T, na, 5)`` = batch x padded targets x anchors x {centre, 4
neighbours}, flattened to ``K = T·na·5``, with a validity mask (target
padding, wh-ratio gate, for KFIoU the angle gate, neighbour gates with
g = 0.5).

Head maps are the port's NCHW ``(B, na·nf, gh, gw)`` with anchor-major
channels, so a candidate's row is read at ``(anchor, :, gj, gi)`` directly
(no full-map transpose).  ``cell`` keeps the JAX package's index
``(gj·gw + gi)·na + a``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# neighbour offsets (lib/loss.py:281-284, g = 0.5): centre, +x, +y, -x, -y
OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))
N_OFF = 5


class Candidates(NamedTuple):
    """Flattened per-level assignment, all ``(B, K)`` with K = T·na·5."""

    valid: torch.Tensor   # bool: the candidate enters the loss
    cls: torch.Tensor     # int64 target class
    anchor: torch.Tensor  # int64 anchor index within the level
    cell: torch.Tensor    # int64 (gj·gw + gi)·na + a
    txy: torch.Tensor     # (B, K, 2) cell-relative target xy
    twh: torch.Tensor     # (B, K, 2) target wh in grid units
    ttheta: torch.Tensor  # target angle (radians)
    tcsl: Optional[torch.Tensor]  # (B, K, 180) CSL bins or None


def build_candidates(tgt: torch.Tensor, tgt_mask: torch.Tensor,
                     anchors_lvl: torch.Tensor, gh: int, gw: int,
                     tgt_csl: Optional[torch.Tensor] = None,
                     angle_gate: bool = False) -> Candidates:
    """``tgt`` (B, T, 6) ``[cls, x, y, w, h, theta]`` normalized,
    ``tgt_mask`` (B, T) bool, ``anchors_lvl`` (na, 2) or, rotated, (na, 3)
    ``[w, h, theta]`` grid units.  ``angle_gate`` (KFIoU) keeps an anchor
    only within 30 degrees of the target, ``|cos(theta_t - theta_a)| >
    0.866`` (``lib/loss.py:457-459``)."""
    B, T = tgt.shape[:2]
    na = anchors_lvl.shape[0]
    gxy = torch.stack([tgt[..., 1] * float(gw), tgt[..., 2] * float(gh)], -1)
    gwh = torch.stack([tgt[..., 3] * float(gw), tgt[..., 4] * float(gh)], -1)
    theta = tgt[..., 5]

    # wh-ratio anchor gate (lib/loss.py:297-298), padding rows sanitized
    r = gwh[:, :, None, :] / torch.clamp_min(anchors_lvl[None, None, :, :2],
                                             1e-9)
    r = torch.where(tgt_mask[:, :, None, None], r, 1.0)
    ratio = torch.maximum(r, 1.0 / torch.clamp_min(r, 1e-9)).amax(-1)
    ok = tgt_mask[:, :, None] & (ratio < 4.0)                 # (B, T, na)
    if angle_gate:
        d = torch.abs(torch.cos(theta[:, :, None]
                                - anchors_lvl[None, None, :, 2]))
        ok = ok & (d > 0.866)

    # neighbour-cell gates (lib/loss.py:302-310)
    g = 0.5
    gxi = torch.stack([float(gw) - gxy[..., 0], float(gh) - gxy[..., 1]], -1)
    jx = (torch.remainder(gxy[..., 0], 1.0) < g) & (gxy[..., 0] > 1.0)
    ky = (torch.remainder(gxy[..., 1], 1.0) < g) & (gxy[..., 1] > 1.0)
    lx = (torch.remainder(gxi[..., 0], 1.0) < g) & (gxi[..., 0] > 1.0)
    my = (torch.remainder(gxi[..., 1], 1.0) < g) & (gxi[..., 1] > 1.0)
    off_ok = torch.stack([torch.ones_like(jx), jx, ky, lx, my], -1)
    valid = ok[:, :, :, None] & off_ok[:, :, None, :]         # (B, T, na, 5)

    # gij = floor(gxy - offset), clamped before tbox is taken (the
    # reference's clamp_ mutates the gij views, lib/loss.py:324-325)
    gi = torch.stack([torch.floor(gxy[..., 0] - ox) for ox, _ in OFFSETS],
                     -1).clamp(0, gw - 1).long()               # (B, T, 5)
    gj = torch.stack([torch.floor(gxy[..., 1] - oy) for _, oy in OFFSETS],
                     -1).clamp(0, gh - 1).long()
    txy = gxy[:, :, None, :] - torch.stack([gi, gj], -1).float()

    shape = (B, T, na, N_OFF)
    K = T * na * N_OFF
    a_idx = torch.arange(na, device=tgt.device)[None, None, :, None]
    cell = (gj[:, :, None, :] * gw + gi[:, :, None, :]) * na + a_idx
    tcsl = None
    if tgt_csl is not None:
        nb = tgt_csl.shape[-1]
        tcsl = tgt_csl[:, :, None, None, :].expand(B, T, na, N_OFF,
                                                   nb).reshape(B, K, nb)
    return Candidates(
        valid=valid.reshape(B, K),
        cls=tgt[..., 0].long()[:, :, None, None].expand(shape).reshape(B, K),
        anchor=a_idx.expand(shape).reshape(B, K),
        cell=cell.expand(shape).reshape(B, K),
        txy=txy[:, :, None].expand(B, T, na, N_OFF, 2).reshape(B, K, 2),
        twh=gwh[:, :, None, None].expand(B, T, na, N_OFF, 2).reshape(B, K, 2),
        ttheta=theta[:, :, None, None].expand(shape).reshape(B, K),
        tcsl=tcsl,
    )


def gather_predictions(pred_lvl: torch.Tensor, cand: Candidates,
                       na: int) -> torch.Tensor:
    """float32 ``(B, K, nf)`` prediction rows at the candidate cells, read
    from the NCHW head map ``(B, na·nf, gh, gw)`` as it is (the reference's
    ``ps = pi[b, a, gj, gi]``, ``lib/loss.py:209``)."""
    B, c, gh, gw = pred_lvl.shape
    flat = pred_lvl.reshape(B, na, c // na, gh * gw)
    b_idx = torch.arange(B, device=pred_lvl.device)[:, None]
    rows = flat[b_idx, cand.anchor, :, torch.div(cand.cell, na,
                                                 rounding_mode="floor")]
    return rows.float()                                       # (B, K, nf)


def scatter_conf(conf_target_shape, cand: Candidates,
                 scores: torch.Tensor) -> torch.Tensor:
    """Scatter per-candidate objectness scores into the dense target
    ``(B, na, gh, gw)`` (the NCHW obj planes; ``tconf[b, a, gj, gi] =
    score``, ``lib/loss.py:221``).

    Duplicate cells resolve as the reference's in-place indexing does: the
    last candidate in its order (offset-major, then anchor, then target)
    wins.  Two passes, deterministic on every device: the highest priority
    per cell (``scatter_reduce`` amax), then a scatter by the unique
    winners.
    """
    B, na, gh, gw = conf_target_shape
    n_cells = na * gh * gw
    K = cand.cell.shape[1]
    T = K // (na * N_OFF)
    dev = cand.cell.device
    # priority o·(na·T) + a·T + t + 1 (0 = empty); K runs ((t·na)+a)·5 + o
    k = torch.arange(K, device=dev)
    o, a, t = k % N_OFF, (k // N_OFF) % na, k // (N_OFF * na)
    prio = torch.where(cand.valid, (o * (na * T) + a * T + t + 1)[None], 0)
    # the obj-plane index a·gh·gw + gj·gw + gi; invalid candidates go to a
    # spare cell n_cells that is dropped at the end
    sp = torch.div(cand.cell, na, rounding_mode="floor")
    idx = torch.where(cand.valid, cand.anchor * (gh * gw) + sp, n_cells)
    pmax = torch.zeros(B, n_cells + 1, dtype=prio.dtype, device=dev)
    pmax.scatter_reduce_(1, idx, prio, "amax")
    win = (pmax.gather(1, idx) == prio) & (prio > 0)
    out = torch.zeros(B, n_cells + 1, dtype=scores.dtype, device=dev)
    out.scatter_(1, torch.where(win, idx, n_cells), scores)
    return out[:, :n_cells].reshape(B, na, gh, gw)
