"""Greedy rotated NMS over padded, batched candidate sets.

Counterpart of ``ryolo_tpu/ops/rotated_nms.py`` (``nms_rotated_masked``
:62, ``_iou_block`` :42).  Same semantics: descending score order, a
candidate is suppressed when its IoU with a kept higher-scoring candidate
is strictly above the threshold, at most ``max_keep`` kept (later ones are
dropped), candidates handled ``CHUNK`` (64) at a time.

The JAX package runs the loop on the device with dynamic trip counts.
Here it is a host loop over chunks that runs the B images together:

* one IoU launch per chunk, the chunk's rows against the live kept prefix
  followed by the chunk itself (``chunk x (kept || chunk)``), with the
  candidate as box1 and the earlier box as box2, as ``_iou_block`` orients
  them;
* the within-chunk greedy is the fixpoint of ``rotated_nms.py:152-171``,
  iterated on the device ``FIX_ROUNDS`` rounds at a time;
* one host sync per chunk reads the fixpoint's convergence flag together
  with the kept counts, which give the next chunk's kept prefix and the
  early exit (every image out of valid chunks or at ``max_keep``); one
  more sync before the loop reads the valid counts.  A chunk whose
  fixpoint needs more rounds adds a sync per further ``FIX_ROUNDS``.

``SYNCS`` counts the host syncs, for the record of what the loop costs.
"""

from __future__ import annotations

import torch

from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou

NEG_INF = -1e30
CHUNK = 64
FIX_ROUNDS = 4

SYNCS = {"nms": 0}


def _host(t: torch.Tensor) -> list:
    SYNCS["nms"] += 1
    return t.tolist()


def nms_rotated_masked(boxes: torch.Tensor, scores: torch.Tensor,
                       valid: torch.Tensor, iou_threshold: float,
                       max_keep: int = 1500, presorted: bool = False):
    """Greedy rotated NMS on ``(K, 5)`` or batched ``(B, K, 5)`` boxes
    ``(cx, cy, w, h, angle_deg)`` with ``(…, K)`` scores and valid flags.

    Returns ``order`` (candidate indices by descending score, ties by
    index) and ``keep`` aligned with ``order``.  ``presorted``: the caller
    gives descending scores with padding last.
    """
    unbatched = boxes.dim() == 2
    if unbatched:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    b, k = scores.shape
    dev = boxes.device
    if k == 0:
        order = torch.zeros((b, 0), dtype=torch.long, device=dev)
        keep = torch.zeros((b, 0), dtype=torch.bool, device=dev)
        return (order[0], keep[0]) if unbatched else (order, keep)
    c = min(CHUNK, k)
    m = min(max_keep, k)
    k_pad = -(-k // c) * c

    if presorted:
        order = torch.arange(k, device=dev).expand(b, k)
        sboxes, svalid = boxes.float(), valid
    else:
        sort_scores = torch.where(valid, scores, NEG_INF)
        order = torch.sort(-sort_scores, dim=1, stable=True).indices
        sboxes = boxes.float().gather(1, order[..., None].expand(b, k, 5))
        svalid = valid.gather(1, order)
    sboxes = torch.cat([sboxes, sboxes.new_zeros(b, k_pad - k, 5)], 1)
    svalid = torch.cat([svalid, svalid.new_zeros(b, k_pad - k)], 1)

    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    kept = torch.zeros((b, m + 1, 5), dtype=torch.float32, device=dev)
    count = torch.zeros(b, dtype=torch.long, device=dev)
    keep = torch.zeros((b, k_pad), dtype=torch.bool, device=dev)
    # tri[j, i]: earlier chunk element j may suppress later element i
    tri = torch.ones((c, c), dtype=torch.bool, device=dev).triu(1)
    slots = torch.arange(m, device=dev)

    n_chunks = [-(-n // c) for n in _host(svalid.sum(1))]
    counts = [0] * b
    ci = 0
    while any(ci < n_chunks[i] and counts[i] < m for i in range(b)):
        start = ci * c
        cboxes = sboxes[:, start:start + c].contiguous()
        live = max(counts)
        iou = pairwise_rotated_iou(
            cboxes, torch.cat([kept[:, :live], cboxes], 1))
        hit = iou > thr
        kept_live = slots[:live] < count[:, None]  # (b, live)
        sup_kept = (hit[:, :, :live] & kept_live[:, None, :]).any(2)
        sup_self = hit[:, :, live:] & tri
        base = svalid[:, start:start + c] & ~sup_kept

        kc = base
        while True:
            for _ in range(FIX_ROUNDS):
                prev = kc
                kc = base & ~(kc[:, :, None] & sup_self).any(1)
            changed = (kc != prev).any()
            rank = count[:, None] + torch.cumsum(kc, 1) - kc.long()
            kc_cap = kc & (rank < m)  # kept-buffer capacity, score order
            new_count = count + kc_cap.sum(1)
            flags = _host(torch.cat([changed.long()[None], new_count]))
            if not flags[0]:
                break
        slot = torch.where(kc_cap, rank, m)  # slot m: dropped rows
        kept.scatter_(1, slot[..., None].expand(b, c, 5), cboxes)
        keep[:, start:start + c] = kc_cap
        count, counts = new_count, flags[1:]
        ci += 1

    keep = keep[:, :k]
    return (order[0], keep[0]) if unbatched else (order, keep)
