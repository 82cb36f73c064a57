"""Operations and bytes that a kernel's inputs need, for its roofline
share: the least time the card could take (operations over the FP32 peak
or bytes over the memory rate, whichever is larger) over its measured
time.

Frozen from ``chip_smoke.py`` at commit d329eff (``pair_counts``,
``mask_ops``, ``mask_bound``, ``scan_words`` and the scan's bytes from
``phase_nms_kernels``, ``render_bound``), with the per-pair and per-pixel
operation counts of ``ryolo_tpu_torch/ops/cuda_iou.py`` and
``ops/cuda_render.py`` and ``decided_rows`` of ``ops/rotated_nms.py`` at
the same commit copied in, so that the yardstick does not move with the
program.  The counts come from the inputs' geometry (which pairs' circles
meet, which taps a pixel owns), not from how a kernel is written.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import peaks
from h100_bench.reference.render import tap_sources

CHUNK = 64
# The far reject of rotated_nms.cu: circumscribed circles apart by more
# than FAR_MARGIN_PX + FAR_MARGIN_REL * (|dx| + |dy|), box2's sides both at
# least MIN_SIDE px.
FAR_MARGIN_PX = 1.0
FAR_MARGIN_REL = 1e-3
MIN_SIDE = 1e-3
# FP32 operations: the far reject per pair; the clip of a pair it cannot
# rule out; each box's row and column terms (cuda_iou.py).
OPS_PER_REJECT = 12
OPS_PER_PAIR = 2 + 16 + 4 * 8 * 5 + 36
OPS_PER_ROW_BOX = 10
OPS_PER_COL_BOX = 74
# The tap renderer (cuda_render.py): per rendered spec pixel, per owned
# tap, per owned tap with HSV gains other than 1, per output pixel with a
# mixup partner, per output pixel.
OPS_PER_SPEC_PIXEL = 8 + 2 + 2 + 2 + 2 + 4 + 3 * (4 + 3 + 1)
OPS_PER_TAP = 2 + 4
OPS_PER_HSV = 4 + 1 + 3 + 1 + 1 + 1 + 3 + 3 + 4 + 4 + 1 + 1 + 1 + 1 + 2 + 3 \
    + 4 + 3
OPS_PER_MIX = 1 + 3 * 4
OPS_PER_OUT_PIXEL = 3


def decided_rows(svalid: torch.Tensor) -> torch.Tensor:
    """``(B,)`` int32: rows the NMS decides, ``min(K, 64 * ceil(#valid /
    64))``."""
    k = svalid.shape[1]
    n = svalid.sum(1)
    return ((n + CHUNK - 1) // CHUNK * CHUNK).clamp(max=k).to(torch.int32)


def pair_counts(sboxes, svalid, n_rows):
    """``(valid pairs, pairs the far reject cannot rule out)``: pairs e < r
    of valid rows that the mask decides, the reject taken in float32 as the
    kernel takes it (box2 is e across chunks and r within a chunk)."""
    n_pairs = n_near = 0
    for boxes, valid, lim in zip(sboxes, svalid, n_rows.tolist()):
        boxes, valid = boxes[:lim], valid[:lim]
        idx = torch.arange(lim, device=boxes.device)
        pairs = valid[:, None] & valid[None, :] & (idx[:, None] > idx[None, :])
        same = (idx[:, None] // CHUNK) == (idx[None, :] // CHUNK)  # [r, e]
        cx, cy, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        rad = 0.5 * torch.sqrt(w * w + h * h)
        big = (w.abs() >= MIN_SIDE) & (h.abs() >= MIN_SIDE)
        big2 = torch.where(same, big[:, None], big[None, :])
        dx = cx[:, None] - cx[None, :]
        dy = cy[:, None] - cy[None, :]
        reach = ((rad[:, None] + rad[None, :])
                 + (FAR_MARGIN_PX + FAR_MARGIN_REL * (dx.abs() + dy.abs())))
        far = big2 & (dx * dx + dy * dy > reach * reach)
        n_pairs += int(pairs.sum())
        n_near += int((pairs & ~far).sum())
    return n_pairs, n_near


def mask_ops(n_pairs, n_near, n_rows_total):
    """FP32 operations the mask needs: the reject on every pair, the clip on
    the pairs it cannot rule out, and each box's terms."""
    return (n_pairs * OPS_PER_REJECT + n_near * OPS_PER_PAIR
            + n_rows_total * (OPS_PER_ROW_BOX + OPS_PER_COL_BOX))


def mask_bound(boxes, valid):
    """``nms_mask``'s least time in seconds on one NMS input ``(boxes,
    valid)`` (score-sorted, class-offset, degrees), with its counts."""
    n_rows = decided_rows(valid)
    rows_total = int(n_rows.sum())
    n_pairs, n_near = pair_counts(boxes, valid, n_rows)
    words = int(sum((torch.arange(n, device=boxes.device) // CHUNK + 1).sum()
                    for n in n_rows.tolist()))
    t_ops = mask_ops(n_pairs, n_near, rows_total) / peaks.FLOPS["float32"]
    t_bytes = (rows_total * 20 + words * 8 + len(boxes) * 4) \
        / peaks.BYTES_PER_S
    return max(t_ops, t_bytes), dict(pairs=n_pairs, near=n_near, words=words)


def scan_words(keep, n_rows, max_keep):
    """Mask words the scan reads: (R + 1) for each decided row of each chunk
    R it visits, and it visits chunks until ``max_keep`` rows are kept or
    ``n_rows`` is reached."""
    b, k = keep.shape
    nw = -(-k // CHUNK)
    kept = torch.nn.functional.pad(keep.long(), (0, nw * CHUNK - k))
    kept = kept.view(b, nw, CHUNK).sum(2)
    before = torch.cumsum(kept, 1) - kept  # kept before chunk R
    chunk = torch.arange(nw, device=keep.device)
    rows = (n_rows[:, None].long() - chunk * CHUNK).clamp(0, CHUNK)
    visited = (before < max_keep) & (rows > 0)
    return int((visited * rows * (chunk + 1)).sum())


def scan_bound(keep, valid, max_keep):
    """``nms_scan``'s least time in seconds: the mask words it reads, the
    valid flags of the decided rows, the keep flags written, the row
    counts (bytes)."""
    n_rows = decided_rows(valid)
    b, k = keep.shape
    nbytes = (scan_words(keep, n_rows, max_keep) * 8 + int(n_rows.sum())
              + b * k + b * 4)
    return nbytes / peaks.BYTES_PER_S


def render_bound(s, slot_rows, spec, n_out, device):
    """The tap renderer's least time in seconds on one spec batch: bytes
    (each tile word that a tap of a rendered spec reads, once, the slot
    table, and the float32 output written once) against its FP32
    operations (every rendered spec pixel, every owned tap, the HSV round
    trip of each owned tap whose slot has gains other than 1, the mixup).
    A partner counts once per base that blends it."""
    region, hsv, mix_idx = spec["region"], spec["hsv"], spec["mix_idx"]
    b, t = region.shape[:2]
    mult = np.zeros(b)
    mult[:n_out] += 1
    for j in mix_idx[:n_out]:
        if j >= 0:
            mult[j] += 1
    mult_t = torch.as_tensor(mult, device=device)
    ident = torch.as_tensor((hsv == 1).all(-1), device=device)  # (b, t)
    _, taps = tap_sources(s, slot_rows, region, spec["offset"], spec["minv"],
                          device)
    owned = jittered = 0.0
    words = []
    for owner, lin in taps:
        valid = owner >= 0
        own = owner.clamp(min=0).reshape(b, -1)
        plain = ident.gather(1, own).view_as(owner)
        owned += float((valid.sum((1, 2)) * mult_t).sum())
        jittered += float(((valid & ~plain).sum((1, 2)) * mult_t).sum())
        words.append(lin[valid & (mult_t > 0)[:, None, None]])
    distinct = int(torch.unique(torch.cat(words)).numel())
    n_mixed = int((mix_idx[:n_out] >= 0).sum())
    px = s * s
    ops = (OPS_PER_SPEC_PIXEL * px * mult.sum() + OPS_PER_TAP * owned
           + OPS_PER_HSV * jittered + OPS_PER_MIX * n_mixed * px
           + OPS_PER_OUT_PIXEL * n_out * px)
    nbytes = distinct * 4 + b * (10 + 10 * t) * 4 + n_out * 3 * px * 4
    return max(ops / peaks.FLOPS["float32"], nbytes / peaks.BYTES_PER_S)
