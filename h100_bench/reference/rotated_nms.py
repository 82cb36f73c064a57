"""Frozen copy of ``ryolo_tpu_torch/ops/rotated_nms.py`` at commit d329eff for the
benchmark's plain reference; it imports nothing of the port.

Greedy rotated NMS over padded, batched candidate sets.

Counterpart of ``ryolo_tpu/ops/rotated_nms.py`` (``nms_rotated_masked``
:62, ``_iou_block`` :42), the same function: candidates in descending score
order (a stable sort of -score, padding last), and with ``ch(x) = x // 64``
(the JAX chunk) an earlier candidate ``e`` suppresses a later ``r`` when
their IoU is strictly above the threshold, with ``_iou_block``'s box roles:
``IoU(box1=r, box2=e)`` when ``ch(e) < ch(r)`` (the candidate against the
kept buffer), ``IoU(box1=e, box2=r)`` when ``ch(e) == ch(r)`` (the chunk's
self block).  ``keep[r]`` holds when ``r`` is valid, no kept ``e < r``
suppresses it and fewer than ``max_keep`` earlier rows are kept.  As in the
JAX loop, only the rows below ``64 * ceil(#valid / 64)`` are decided.

It runs in two steps, a suppression bitmask (``(B, K, ceil(K / 64))``
int64 words, bit j of word c of row r set when candidate 64c + j
suppresses r) and a greedy scan over it, both the port's plain versions
(``nms_mask_plain``, ``nms_scan_plain``) on any device.
"""

from __future__ import annotations

import torch

from .rotated_iou import pairwise_rotated_iou_plain

NEG_INF = -1e30
CHUNK = 64
# bit j of an int64 word: 2**j, and -2**63 for the sign bit
_BITS = torch.tensor([1 << j for j in range(CHUNK - 1)] + [-(1 << 63)],
                     dtype=torch.int64)


def decided_rows(svalid: torch.Tensor) -> torch.Tensor:
    """``(B,)`` int32: rows the NMS decides, ``min(K, 64 * ceil(#valid /
    64))``, the JAX loop's chunk count (``rotated_nms.py:194-204``)."""
    k = svalid.shape[1]
    n = svalid.sum(1)
    return ((n + CHUNK - 1) // CHUNK * CHUNK).clamp(max=k).to(torch.int32)


def _n_chunks(n_rows: torch.Tensor) -> int:
    return -(-int(n_rows.max()) // CHUNK) if n_rows.numel() else 0


def nms_mask_plain(sboxes: torch.Tensor, n_rows: torch.Tensor,
                   thr: float) -> torch.Tensor:
    """The ``nms_mask`` kernel's plain version: ``(B, K, ceil(K / 64))``
    int64 words, with the plain IoU, 64 rows at a time against the earlier
    prefix.  Words the kernel does not write are 0."""
    b, k, _ = sboxes.shape
    dev = sboxes.device
    thr_t = torch.tensor(thr, dtype=torch.float32, device=dev)
    bits = _BITS.to(dev)
    mask = torch.zeros((b, k, -(-k // CHUNK)), dtype=torch.int64, device=dev)
    for ci in range(_n_chunks(n_rows)):
        lo, hi = ci * CHUNK, min(k, (ci + 1) * CHUNK)
        rows = sboxes[:, lo:hi]
        # [r, e]: across chunks IoU(box1=r, box2=e); within, IoU(box1=e, box2=r)
        cross = pairwise_rotated_iou_plain(rows, sboxes[:, :lo]) > thr_t
        same = (pairwise_rotated_iou_plain(rows, rows) > thr_t).transpose(1, 2)
        same = same & torch.ones(hi - lo, hi - lo, dtype=torch.bool,
                                 device=dev).tril(-1)
        hit = torch.cat([cross, same,
                         same.new_zeros(b, hi - lo, (ci + 1) * CHUNK - hi)], 2)
        words = (hit.view(b, hi - lo, ci + 1, CHUNK).long() * bits).sum(-1)
        live = torch.arange(lo, hi, device=dev) < n_rows[:, None]
        mask[:, lo:hi, :ci + 1] = torch.where(live[..., None], words, 0)
    return mask


def nms_scan_plain(mask: torch.Tensor, svalid: torch.Tensor,
                   n_rows: torch.Tensor, max_keep: int) -> torch.Tensor:
    """The ``nms_scan`` kernel's plain version: the greedy scan of ``mask``
    row by row, with the ``max_keep`` cap.  Reads only the words the mask
    kernel writes."""
    b, k = svalid.shape
    dev = svalid.device
    shifts = torch.arange(CHUNK, device=dev)
    keep = torch.zeros((b, k), dtype=torch.bool, device=dev)
    count = torch.zeros(b, dtype=torch.long, device=dev)
    for ci in range(_n_chunks(n_rows)):
        lo, hi = ci * CHUNK, min(k, (ci + 1) * CHUNK)
        live = torch.arange(lo, hi, device=dev) < n_rows[:, None]
        words = torch.where(live[..., None], mask[:, lo:hi, :ci + 1], 0)
        hit = ((words[..., None] >> shifts) & 1).bool().flatten(2)
        sup = (hit[:, :, :lo] & keep[:, None, :lo]).any(2)
        base = svalid[:, lo:hi] & live & ~sup
        same = hit[:, :, lo:hi]  # [i, j]: chunk row j suppresses chunk row i
        for i in range(hi - lo):
            kept = (base[:, i] & (count < max_keep)
                    & ~(same[:, i, :i] & keep[:, lo:lo + i]).any(1))
            keep[:, lo + i] = kept
            count += kept
    return keep


def nms_rotated_masked(boxes: torch.Tensor, scores: torch.Tensor,
                       valid: torch.Tensor, iou_threshold: float,
                       max_keep: int = 1500, presorted: bool = False):
    """Greedy rotated NMS on ``(K, 5)`` or batched ``(B, K, 5)`` boxes
    ``(cx, cy, w, h, angle_deg)`` with ``(…, K)`` scores and valid flags.

    Returns ``order`` (candidate indices by descending score, ties by
    index) and ``keep`` aligned with ``order``.  ``presorted``: the caller
    gives descending scores with padding last.  On a CUDA tensor the two
    kernels launch on the current stream and nothing is read back.
    """
    unbatched = boxes.dim() == 2
    if unbatched:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    b, k = scores.shape
    dev = boxes.device
    m = min(max_keep, k)
    if presorted:
        order = torch.arange(k, device=dev).expand(b, k)
        sboxes, svalid = boxes.float(), valid.bool()
    else:
        sort_scores = torch.where(valid, scores, NEG_INF)
        order = torch.sort(-sort_scores, dim=1, stable=True).indices
        sboxes = boxes.float().gather(1, order[..., None].expand(b, k, 5))
        svalid = valid.bool().gather(1, order)
    sboxes, svalid = sboxes.contiguous(), svalid.contiguous()
    n_rows = decided_rows(svalid)
    mask = nms_mask_plain(sboxes, n_rows, iou_threshold)
    keep = nms_scan_plain(mask, svalid, n_rows, m)
    return (order[0], keep[0]) if unbatched else (order, keep)
