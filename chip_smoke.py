#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ryolo_tpu_torch``) on one NVIDIA GPU.

Usage, from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device: the card's name and power limit, torch and CUDA versions, the
   TF32 flags (both off: every float32 number here is float32);
2. build: every CUDA kernel of the port from ``ryolo_tpu_torch/ops/csrc``,
   one ``nvcc`` per source, started together, with ptxas's registers and
   spills;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it plus probes, and their times: the pairwise
   rotated IoU, the NMS mask and scan at 8 x 5000 candidates (thresholds
   0.2 and 0.65, with far-reject probes), the canvas warp, and the tap
   renderer at 12 specs x 800 px in both tile layouts (bit for bit);
4. detect path: YOLOv7-CSL, nc = 16, seeded random weights, deploy-fused,
   f32, 800 px, batch 8, driven through ``ryolo_tpu_torch.detect.Detect``
   on a folder of synthetic images at the CLI default (conf 0.7, iou 0.2)
   and at eval load (conf 0.001, iou 0.65), and once more at eval load in
   bf16: one ``nms_mask`` and one ``nms_scan`` launch per batch, no
   pairwise IoU launch, no host sync inside the NMS;
5. card against CPU at 256 px, batch 2: fused head maps, and equal keep
   sets from post-processing on the card (kernel) and on the CPU (plain);
6. training path: a synthetic DOTA split, YOLOv7-CSL at full width from
   ``weights_init_normal``, the port's spec loader at 800 px, batch 8,
   steps through ``Trainer.train_step_rendered`` with warm-up and
   accumulation as the JAX ``train.py`` sets them, in three runs: the tap
   renderer (one ``render`` launch and no ``warp`` launch per step) with
   pixel specs and with the device tile bank, then the canvas route (paste,
   HSV, one ``warp`` launch per step) with the tile bank; no host sync in
   a step;
7. card against CPU, training, at 256 px, batch 2: the same spec batch
   rendered on the card (the render kernel) and on the CPU (its plain
   version), then one SGD step from the same weights on each.

Then one JSON line with every kernel's numbers and, last, the result line.
Any failure raises: the script exits non-zero and prints no result.  It
refuses to run without a CUDA device.
"""

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from argparse import Namespace

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NC = 16
IMG, BATCH, N_IMAGES = 800, 8, 40
H100_FP32_OPS = 67e12      # FP32 outside the tensor cores, dense
H100_BYTES_PER_S = 3.35e12  # HBM3
TRAIN_IMAGES, TRAIN_STEPS, NBS = 64, 7, 64  # NBS: nominal batch, train.py


def check(ok, what):
    """Fail the run (a raise, so it holds under ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters):
    """Mean device ms per call over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand_boxes(gen, b, n, spread=60.0):
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(b, n, generator=gen)  # noqa: E731
    return torch.stack([u(0, spread), u(0, spread), u(2, 40), u(2, 40),
                        u(-180, 180)], -1)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build():
    from ryolo_tpu_torch.ops import _build

    names = ["rotated_iou", "rotated_nms", "warp", "render"]
    t = time.perf_counter()
    _build.build(names)
    log("build", f"{', '.join(names)} built in "
        f"{time.perf_counter() - t:.3f} s")
    for name in names:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"ptxas {name}: " + line.strip())


def iou_bounds_ok(got, want):
    """tests/test_pallas_iou.py bounds: < 5e-4 of pairs off by > 1e-3,
    median difference < 1e-6."""
    diff = (got - want).abs()
    frac = (diff > 1e-3).float().mean().item()
    med = diff.median().item()
    return frac < 5e-4 and med < 1e-6, diff.max().item(), frac, med


def phase_kernels():
    from ryolo_tpu_torch.ops.cuda_iou import (OPS_PER_COL_BOX, OPS_PER_PAIR,
                                              OPS_PER_ROW_BOX,
                                              pairwise_rotated_iou)
    from ryolo_tpu_torch.ops.rotated_iou import pairwise_rotated_iou_plain

    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    max_err, rep = 0.0, None
    # NMS chunk (64) against the live kept prefix || the chunk: prefix 0,
    # 192 and the full 1500; and a square 1024 case
    for n, m in [(64, 64), (64, 256), (64, 1564), (1024, 1024)]:
        a = rand_boxes(gen, BATCH, n).to(dev)
        b = rand_boxes(gen, BATCH, m).to(dev)
        got = pairwise_rotated_iou(a, b)
        torch.cuda.synchronize()
        want = pairwise_rotated_iou_plain(a, b)
        ok, err, frac, med = iou_bounds_ok(got, want)
        check(ok, f"kernel vs plain at {BATCH}x{n}x{m}: {err} {frac} {med}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: pairwise_rotated_iou(a, b), 50)
        plain_ms = cuda_ms(lambda: pairwise_rotated_iou_plain(a, b), 5)
        pairs, boxes = BATCH * n * m, BATCH * (n + m)
        ops = (pairs * OPS_PER_PAIR + BATCH * n * OPS_PER_ROW_BOX
               + BATCH * m * OPS_PER_COL_BOX)
        nbytes = boxes * 5 * 4 + pairs * 4
        bound = max(ops / H100_FP32_OPS, nbytes / H100_BYTES_PER_S) * 1e3
        by = "operations" if ops / H100_FP32_OPS > nbytes / H100_BYTES_PER_S \
            else "bytes"
        log("kernels", f"rotated_iou {BATCH}x{n}x{m}: max_abs_err {err:.3e} "
            f"frac>1e-3 {frac:.2e} median {med:.1e}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by})")
        if (n, m) == (64, 1564):
            rep = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)

    # probes
    b = rand_boxes(gen, 1, 64).to(dev)
    diag = torch.diagonal(pairwise_rotated_iou(b, b)[0])
    check(torch.allclose(diag, torch.ones_like(diag), atol=1e-5), diag)
    b180 = b.clone()
    b180[..., 4] += 180.0
    diag = torch.diagonal(pairwise_rotated_iou(b, b180)[0])
    check(torch.allclose(diag, torch.ones_like(diag), atol=1e-4), diag)
    z = b.clone()
    z[..., 2:4] = 0.0
    check(torch.all(pairwise_rotated_iou(z, b) == 0), "zero-size rows")
    check(torch.all(pairwise_rotated_iou(z, z) == 0), "zero-size pairs")
    s1, s2 = rand_boxes(gen, 2, 256, 30.0), rand_boxes(gen, 2, 256, 30.0)
    s1[..., :2] += 15 * 4096.0  # class-offset centres, class 15
    s2[..., :2] += 15 * 4096.0
    got = pairwise_rotated_iou(s1.to(dev), s2.to(dev)).cpu()
    ok, err, frac, med = iou_bounds_ok(got, pairwise_rotated_iou_plain(s1, s2))
    check(ok and (got > 0).float().mean() > 0.1, (err, frac, med))
    max_err = max(max_err, err)
    log("kernels", "probes ok: diagonal 1, theta vs theta+180 1, zero-size "
        f"rows 0, class-offset centres max_abs_err {err:.3e}")
    return dict(max_abs_err=max_err, **rep)


def cuda_ms_once(fn):
    """``fn()`` and its device ms, one call (for the slow plain versions)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nms_candidates(gen, b, k, n_valid):
    """Score-sorted candidates as post-processing hands them to the NMS at
    eval load: 16 per object on average, jittered as neighbouring anchors
    predict one object (centre by up to 15% of the width, sides by 20%,
    angle by 10 degrees), objects over an 800 px image with DOTA-like sizes,
    centres moved by class * 4096 (16 classes); padding last."""
    def r(*shape):
        return torch.rand(*shape, generator=gen)

    n_obj = max(1, k // 16)
    obj = torch.stack([IMG * r(b, n_obj), IMG * r(b, n_obj),
                       8 + 112 * r(b, n_obj), 8 + 52 * r(b, n_obj),
                       180 * r(b, n_obj) - 90], -1)
    cls = torch.randint(0, NC, (b, n_obj), generator=gen).float() * 4096.0
    pick = torch.randint(0, n_obj, (b, k), generator=gen)
    boxes = obj.gather(1, pick[..., None].expand(b, k, 5)).clone()
    boxes[..., :2] += (r(b, k, 2) - 0.5) * 0.3 * boxes[..., 2:3]
    boxes[..., :2] += cls.gather(1, pick)[..., None]
    boxes[..., 2:4] *= 0.8 + 0.4 * r(b, k, 2)
    boxes[..., 4] += 20 * r(b, k) - 10
    valid = torch.arange(k)[None, :] < torch.tensor(n_valid)[:, None]
    return boxes, valid


def mask_bits(mask, n_rows):
    """``(B, K, K)`` bits [r, e] of the words the mask kernel writes."""
    k = mask.shape[1]
    shifts = torch.arange(64, device=mask.device)
    bits = ((mask[..., None] >> shifts) & 1).bool().flatten(2)[..., :k]
    r = torch.arange(k, device=mask.device)
    return bits & ((r[None, :, None] < n_rows[:, None, None].long())
                   & (r[None, None, :] // 64 <= r[None, :, None] // 64))


def mask_iou(boxes, pairs):
    """Plain IoU of ``(b, r, e)`` pairs in the mask's orientation: box1 = r
    across chunks, box1 = e within a chunk."""
    from ryolo_tpu_torch.ops.rotated_iou import rotated_iou_pairs

    bi, r, e = pairs.unbind(1)
    same = ((r // 64) == (e // 64))[:, None]
    return rotated_iou_pairs(torch.where(same, boxes[bi, e], boxes[bi, r]),
                             torch.where(same, boxes[bi, r], boxes[bi, e]))


# The far reject of ryolo_tpu_torch/ops/csrc/rotated_nms.cu (kFarMargin*,
# kMinSide there; its source argues why it is exact), repeated here for the
# mask's bound and the probes: circumscribed circles apart by more than
# FAR_MARGIN_PX + FAR_MARGIN_REL * (|dx| + |dy|), box2's sides both at least
# MIN_SIDE px.
FAR_MARGIN_PX = 1.0
FAR_MARGIN_REL = 1e-3
MIN_SIDE = 1e-3
# FP32 operations of the far reject per pair (dx, dy, |dx| + |dy|, the
# margin, r1 + r2, the reach squared, dx² + dy²); compares left out, as in
# OPS_PER_PAIR.
OPS_PER_REJECT = 12


def pair_counts(sboxes, svalid, n_rows):
    """``(valid pairs, pairs the far reject cannot rule out)``: pairs e < r
    of valid rows that the mask decides (r < n_rows), the reject taken in
    float32 as the kernel takes it (box2 is e across chunks and r within a
    chunk).  Python ints; one image at a time, to bound the memory."""
    n_pairs = n_near = 0
    for boxes, valid, lim in zip(sboxes, svalid, n_rows.tolist()):
        boxes, valid = boxes[:lim], valid[:lim]
        idx = torch.arange(lim, device=boxes.device)
        pairs = valid[:, None] & valid[None, :] & (idx[:, None] > idx[None, :])
        same = (idx[:, None] // 64) == (idx[None, :] // 64)  # [r, e]
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
    from ryolo_tpu_torch.ops.cuda_iou import (OPS_PER_COL_BOX, OPS_PER_PAIR,
                                              OPS_PER_ROW_BOX)

    return (n_pairs * OPS_PER_REJECT + n_near * OPS_PER_PAIR
            + n_rows_total * (OPS_PER_ROW_BOX + OPS_PER_COL_BOX))


def scan_words(keep, n_rows, max_keep):
    """Mask words the scan reads: (R + 1) for each decided row of each chunk
    R it visits, and it visits chunks until ``max_keep`` rows are kept or
    ``n_rows`` is reached."""
    b, k = keep.shape
    nw = -(-k // 64)
    kept = torch.nn.functional.pad(keep.long(), (0, nw * 64 - k))
    kept = kept.view(b, nw, 64).sum(2)
    before = torch.cumsum(kept, 1) - kept  # kept before chunk R
    chunk = torch.arange(nw, device=keep.device)
    rows = (n_rows[:, None].long() - chunk * 64).clamp(0, 64)
    visited = (before < max_keep) & (rows > 0)
    return int((visited * rows * (chunk + 1)).sum())


def reject_probes():
    """Pairs where the far reject must not change a bit: circles exactly at
    the margin and just inside it (squares with corners pointing at each
    other, and wide boxes end to end), touching boxes, an overlap under
    1e-4 px, identical boxes, theta against theta + 180; near 0 and at
    class 15's offset.  Each pair sits in one chunk (rows 0..31) and across
    two (first boxes from row 96, second ones from row 128), among far
    fillers.  ``(1, 144, 5)``."""
    def at_margin(w, h, theta, inside):
        d = (float(np.hypot(w, h)) + FAR_MARGIN_PX) / (1 - FAR_MARGIN_REL)
        return [(0, 0, w, h, theta), (d - inside, 0, w, h, theta)]

    pairs = [at_margin(10, 10, 45, 0), at_margin(10, 10, 45, 0.01),
             at_margin(30, 8, 0, 0), at_margin(30, 8, 0, 0.01),
             [(0, 0, 10, 10, 0), (10, 0, 10, 10, 0)],
             [(0, 0, 10, 10, 0), (10 - 5e-5, 0, 10, 10, 0)],
             [(0, 0, 20, 8, 30), (0, 0, 20, 8, 30)],
             [(0, 0, 20, 8, 30), (0, 0, 20, 8, 210)]]
    rows = []
    for shift in (0.0, 15 * 4096.0):
        for p in pairs:
            rows += [np.array(x, np.float64) + [shift, shift, 0, 0, 0]
                     for x in p]
    n = len(rows)
    far = [(5e4 + 100.0 * i, -5e4, 4, 4, 0) for i in range(128)]
    boxes = (rows + far[:96 - n] + rows[::2] + far[96 - n:128 - n - n // 2]
             + rows[1::2])
    return torch.from_numpy(np.array(boxes, np.float32))[None]


def phase_nms_kernels():
    """nms_mask and nms_scan at the eval-load shape against their plain
    versions, with times and bounds."""
    from ryolo_tpu_torch.ops import cuda_nms
    from ryolo_tpu_torch.ops.cuda_iou import (OPS_PER_COL_BOX, OPS_PER_PAIR,
                                              OPS_PER_ROW_BOX)
    from ryolo_tpu_torch.ops.rotated_nms import (decided_rows, nms_mask_plain,
                                                 nms_rotated_masked,
                                                 nms_scan_plain)

    dev = torch.device("cuda")
    k, max_keep = 5000, 1500  # MAX_NMS, MAX_DET
    boxes, valid = nms_candidates(torch.Generator().manual_seed(SEED + 5),
                                  BATCH, k, [k] * (BATCH - 1) + [3000])
    boxes, valid = boxes.to(dev), valid.to(dev)
    n_rows = decided_rows(valid)
    rows_total = int(n_rows.sum())
    n_pairs, n_near = pair_counts(boxes, valid, n_rows)
    words_written = int(sum((torch.arange(n, device=dev) // 64 + 1).sum()
                            for n in n_rows.tolist()))
    rep = {}
    for thr in (0.2, 0.65):
        mask = cuda_nms.nms_mask(boxes, n_rows, thr)
        torch.cuda.synchronize()
        plain, plain_ms = cuda_ms_once(
            lambda: nms_mask_plain(boxes, n_rows, thr))
        got, want = mask_bits(mask, n_rows), mask_bits(plain, n_rows)
        diff = (got ^ want).nonzero()
        worst = float((mask_iou(boxes, diff) - thr).abs().max()) \
            if len(diff) else 0.0
        check(worst <= 1e-5, f"mask bits differ off the knife edge at thr "
              f"{thr}: plain IoU {worst} from it")
        ms = cuda_ms(lambda: cuda_nms.nms_mask(boxes, n_rows, thr), 20)
        ops = mask_ops(n_pairs, n_near, rows_total)
        nbytes = rows_total * 20 + words_written * 8 + BATCH * 4
        t_ops, t_bytes = ops / H100_FP32_OPS, nbytes / H100_BYTES_PER_S
        bound, by = max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"
        ops_all = (n_pairs * OPS_PER_PAIR
                   + rows_total * (OPS_PER_ROW_BOX + OPS_PER_COL_BOX))
        log("kernels", f"nms_mask {BATCH}x{k} (valid {n_rows.tolist()}) at "
            f"thr {thr}: {int(got.sum())} bits set, {len(diff)} differ from "
            "the plain version (each within 1e-5 of thr); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound:.5f} ms "
            f"({by}: {n_pairs} valid pairs, {n_near} not ruled out by the "
            f"far reject, {words_written} words written); bound with every "
            f"valid pair clipped {ops_all / H100_FP32_OPS * 1e3:.5f} ms")

        keep = cuda_nms.nms_scan(mask, valid, n_rows, max_keep)
        torch.cuda.synchronize()
        keep_plain, scan_plain_ms = cuda_ms_once(
            lambda: nms_scan_plain(mask, valid, n_rows, max_keep))
        check(torch.equal(keep, keep_plain),
              f"scan kernel vs plain on the same mask at thr {thr}")
        scan_ms = cuda_ms(
            lambda: cuda_nms.nms_scan(mask, valid, n_rows, max_keep), 20)
        words = scan_words(keep, n_rows, max_keep)
        scan_bytes = words * 8 + rows_total + BATCH * k + BATCH * 4
        scan_bound = scan_bytes / H100_BYTES_PER_S * 1e3
        log("kernels", f"nms_scan at thr {thr}: kept per image "
            f"{keep.sum(1).tolist()}, equal to the plain scan on the kernel's"
            f" mask; kernel {scan_ms:.4f} ms, plain {scan_plain_ms:.1f} ms, "
            f"bound {scan_bound:.5f} ms (bytes: {words} mask words read)")

        # the whole NMS: the kernels' keep against the plain mask + scan
        nms_plain = nms_scan_plain(plain, valid, n_rows, max_keep)
        n_keep_diff = int((keep != nms_plain).sum())
        check(n_keep_diff == 0 or len(diff) > 0,
              f"NMS keep differs at thr {thr} with equal masks")
        nms_ms = cuda_ms(lambda: nms_rotated_masked(
            boxes, valid.float(), valid, thr, max_keep=max_keep,
            presorted=True), 20)
        log("kernels", f"NMS at thr {thr} (presorted, mask + scan): "
            f"{nms_ms:.4f} ms per batch of {BATCH}; keep equal to the plain "
            f"NMS's except {n_keep_diff} rows (allowed only through the "
            f"{len(diff)} knife-edge bits)")
        rep[thr] = dict(
            mask=dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                      max_abs_err=float(len(diff) > 0)),
            scan=dict(ms=scan_ms, plain_ms=scan_plain_ms,
                      bound_ms=scan_bound, bound_by="bytes",
                      max_abs_err=float((keep ^ keep_plain).any())))

    probes = reject_probes().to(dev)
    p_valid = torch.ones(probes.shape[:2], dtype=torch.bool, device=dev)
    p_rows = decided_rows(p_valid)
    for thr in (1e-3, 0.5):
        got = mask_bits(cuda_nms.nms_mask(probes, p_rows, thr), p_rows)
        want = mask_bits(nms_mask_plain(probes, p_rows, thr), p_rows)
        check(torch.equal(got, want),
              f"reject probes at thr {thr}: {(got ^ want).nonzero().tolist()}")
    torch.cuda.empty_cache()  # the plain versions' buffers
    log("kernels", "far-reject probes equal to the plain mask at thr 0.001 "
        "and 0.5 (circles at the margin and 0.01 px inside, touching boxes, "
        "overlap 5e-5 px, identical boxes, theta vs theta+180; one chunk and"
        " across chunks; near 0 and at 15 x 4096 px)")
    return rep[0.65]


def spec_affines(rng, b, s):
    """Inverse affines as the spec builder draws them for a 2s mosaic canvas
    (configs/hyp.yaml: rotate 45, scale 0.5, translate 0.1;
    ``BaseDataset._warp_params``)."""
    th = np.deg2rad(rng.uniform(-45, 45, b))
    sc = rng.uniform(0.5, 1.6, b)
    shift = rng.uniform(0.2, 0.4, (b, 2)) * s
    minv = np.zeros((b, 2, 3), np.float32)
    minv[:, 0, 0] = minv[:, 1, 1] = np.cos(th) / sc
    minv[:, 0, 1], minv[:, 1, 0] = -np.sin(th) / sc, np.sin(th) / sc
    for k in range(b):
        minv[k, :, 2] = s - minv[k, :, :2] @ shift[k]
    return minv


HSV_GAINS = np.array([0.015, 0.7, 0.4])  # configs/hyp.yaml hsv_h, hsv_s, hsv_v


def render_case(rng, b, s, n_out, t=9):
    """Render specs shaped as the loader's, from ``rng``: mosaic-4 (slots
    0-3) or mosaic-9 (0-8) over a 2s canvas, region edges on whole and half
    cells and grown by 1.5 cells now and then (so a higher slot wins the
    seam), offsets at each region's start with a jitter of up to 4 cells
    and regions up to 1.4 s wide (so the clip to [0, s-1] bites), a
    mosaic-9 slot of zero area mid-prefix now and then, the canvas border
    unowned, HSV gains as configs/hyp.yaml draws them with one slot in five
    at identity, affines from :func:`spec_affines`; partners at slots
    >= ``n_out``, each blended into at most one base, flips at random.
    Returns a dict of host arrays (``slot_rows`` left to the caller)."""
    region = np.zeros((b, t, 4), np.float32)
    offset = np.zeros((b, t, 2), np.float32)
    for i in range(b):
        n = 2 if rng.random() < 0.8 else 3
        cuts = np.sort(rng.uniform(0.6 * s, 1.4 * s, (2, n - 1)), 1)
        cuts = np.round(cuts * 2) / 2  # whole and half cells
        xs = np.concatenate([[0.0], cuts[0], [2.0 * s]])
        ys = np.concatenate([[0.0], cuts[1], [2.0 * s]])
        k = 0
        for jy in range(n):
            for jx in range(n):
                grow = 1.5 * (rng.random(4) < 0.3)
                region[i, k] = [max(xs[jx] - grow[0], -1.0),
                                max(ys[jy] - grow[1], -1.0),
                                min(xs[jx + 1] + grow[2], 2.0 * s),
                                min(ys[jy + 1] + grow[3], 2.0 * s)]
                offset[i, k] = np.floor(region[i, k, :2]) \
                    + rng.integers(-4, 5, 2)
                k += 1
        if n == 3 and rng.random() < 0.5:
            z = int(rng.integers(1, 8))
            region[i, z, 2] = region[i, z, 0]  # zero area, mid-prefix
    hsv = (1 + rng.uniform(-1, 1, (b, t, 3)) * HSV_GAINS).astype(np.float32)
    hsv[rng.random((b, t)) < 0.2] = 1.0
    flip = np.zeros((n_out, 2), bool)
    flip[:] = rng.random((n_out, 2)) < 0.5
    mix_idx = np.full(n_out, -1, np.int32)
    mix_r = np.zeros(n_out, np.float32)
    bases = rng.permutation(n_out)
    for j, base in zip(range(n_out, b), bases):
        if j == n_out or rng.random() < 0.5:
            mix_idx[base] = j
            mix_r[base] = rng.beta(32.0, 32.0)
    return dict(region=region, offset=offset, hsv=hsv,
                minv=spec_affines(rng, b, s), flip=flip, mix_idx=mix_idx,
                mix_r=mix_r)


def warp_coords(minv, s):
    """Canvas coordinates (cx, cy) of every output pixel, as the kernel
    computes them."""
    o = torch.arange(s, dtype=torch.float32, device=minv.device)
    m = minv.reshape(-1, 6)[:, :, None, None]
    cx = m[:, 0] * o[None, None, :] + m[:, 1] * o[None, :, None] + m[:, 2]
    cy = m[:, 3] * o[None, None, :] + m[:, 4] * o[None, :, None] + m[:, 5]
    return cx, cy


def warp_bound(minv, c, s, active):
    """Least time for the warp: bytes over the memory rate, against its
    FP32 operations over the FP32 rate.  The bytes are the affines, the
    flags, each canvas cell that a tap of an in-canvas pixel of an active
    spec reads, once, and each output value of an active spec written once
    as a byte (the values are integers 0..255; nothing reads the inactive
    slots).  Also returns the bound with the kernel's own output, float32
    for every spec, which the render keeps because it fuses the cast the
    tail needs."""
    from ryolo_tpu_torch.ops.cuda_warp import OPS_PER_PIXEL

    b = minv.shape[0]
    x0, y0 = (torch.floor(v) for v in warp_coords(minv, s))
    ok = ((x0 >= -1) & (x0 <= c - 2) & (y0 >= -1) & (y0 <= c - 2)
          & (active.reshape(b, 1, 1) != 0))
    touched = torch.zeros(b, c + 1, c + 1, dtype=torch.bool,
                          device=minv.device)
    bi = torch.arange(b, device=minv.device)[:, None, None].expand_as(ok)[ok]
    bx, by = x0[ok].long() + 1, y0[ok].long() + 1
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        touched[bi, bx + dx, by + dy] = True
    cells = int(touched[:, :c, :c].sum())  # index c is PAD, never read
    n_active = int((active != 0).sum())
    read = 3 * cells + minv.numel() * 4 + b * 4
    t_ops = OPS_PER_PIXEL * int(ok.sum()) / H100_FP32_OPS
    t_bytes = (read + n_active * 3 * s * s) / H100_BYTES_PER_S
    t_carrier = (read + b * 3 * s * s * 4) / H100_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", cells,
            max(t_carrier, t_ops) * 1e3)


def grid_sample_call(canvas, minv, s):
    """``grid_sample`` on the same canvases and affines (bilinear, float32
    canvas, zero padding): the nearest library call, not bit-equal (no
    rounding, other padding)."""
    import torch.nn.functional as F

    c = canvas.shape[2]
    cx, cy = warp_coords(minv, s)
    # input (b, 3, X, Y): grid x runs along Y (buffer cy + 1), grid y along X
    grid = torch.stack([(cy + 1) * (2.0 / (c - 1)) - 1,
                        (cx + 1) * (2.0 / (c - 1)) - 1], -1)
    canvas_f = canvas.float()
    return lambda: F.grid_sample(canvas_f, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def phase_warp_kernel():
    from ryolo_tpu_torch.ops.cuda_warp import warp_canvas
    from ryolo_tpu_torch.ops.warp import warp_canvas_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s64, c64 = 64, 130
    d = 3.03 / 2 * 0.999
    probes = np.array([
        [[1, 0, 0], [0, 1, 0]],                       # identity
        [[1, 0, 9000], [0, 1, -9000]],                # all PAD
        [[1, 0, -31.5], [0, 1, c64 - 32.5]],          # canvas edge
        [[0.5, 0.5, -1.0], [-0.5, 0.5, c64 - 33.0]],  # canvas edge
        [[d, d, 20.2], [-d, d, 40.7]],                # TPU span bound
        [[2.9, -2.7, 60.0], [2.6, 3.1, -40.0]],       # |row|_1 ~5.7
    ], np.float32)
    path_b = BATCH + max(1, -(-BATCH * 2 // 5))       # B + E = 12
    cases = [
        ("path 12x800", IMG, spec_affines(rng, path_b, IMG),
         np.array([1] * BATCH + [1, 0, 1, 0], np.int32)),
        ("spec 4x64", s64, spec_affines(rng, 4, s64), np.ones(4, np.int32)),
        ("probes 6x64", s64, probes, np.ones(len(probes), np.int32)),
    ]
    max_err, rep = 0.0, None
    for label, s, minv_np, act_np in cases:
        b, c = len(minv_np), 2 * s + 2
        canvas = torch.randint(0, 256, (b, 3, c, c), generator=gen,
                               device=dev, dtype=torch.uint8)
        minv = torch.from_numpy(minv_np).to(dev)
        active = torch.from_numpy(act_np).to(dev)
        got = warp_canvas(canvas, minv, s, active)
        torch.cuda.synchronize()
        want = warp_canvas_plain(canvas, minv, s, active)
        diff = (got - want).abs()
        n_diff, err = int((diff > 0).sum()), float(diff.max())
        check(err <= 1.0 and n_diff <= 1e-3 * diff.numel(),
              f"warp kernel vs plain, {label}: {n_diff} differ, max {err}")
        check(bool((got[active == 0] == 114.0).all()), "inactive not PAD")
        max_err = max(max_err, err)
        msg = (f"warp {label}: {n_diff} of {diff.numel()} values differ, "
               f"max_abs_err {err:.1f}")
        if label.startswith("probes"):
            check(bool((got[1] == 114.0).all()), "off-canvas probe not PAD")
            log("kernels", msg + " (identity, off-canvas all PAD, canvas "
                "edges, |row|_1 at 3.03 and at ~5.7)")
            continue
        ms = cuda_ms(lambda: warp_canvas(canvas, minv, s, active), 50)
        plain_ms = cuda_ms(lambda: warp_canvas_plain(canvas, minv, s,
                                                     active), 5)
        lib_ms = cuda_ms(grid_sample_call(canvas, minv, s), 20)
        bound, by, cells, carrier = warp_bound(minv, c, s, active)
        log("kernels", f"{msg}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" grid_sample {lib_ms:.4f} ms (float32 canvas, no rounding, "
            f"zero padding: not bit-equal), bound {bound:.5f} ms ({by}; "
            f"{cells} canvas cells read, uint8 output of the "
            f"{int((active != 0).sum())} active specs); with the kernel's "
            f"float32 output for all {b} specs {carrier:.5f} ms")
        if label.startswith("path"):
            rep = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=lib_ms)
    return dict(max_abs_err=max_err, **rep)


def render_inputs(b, s, n_out, layout, seed, dev):
    """:func:`render_case` specs with their tile rows on ``dev``: the
    ``(b*9, s, s)`` pixel tiles, or a 64-row bank (rows drawn at random,
    some shared between specs)."""
    rng = np.random.default_rng(seed)
    spec = render_case(rng, b, s, n_out)
    n = b * 9 if layout == "pixel" else 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, 1 << 24, (n, s, s), generator=gen, device=dev,
                         dtype=torch.int32)
    slot_rows = (np.arange(b * 9).reshape(b, 9) if layout == "pixel"
                 else rng.integers(0, n, (b, 9)))
    return rows, slot_rows, spec


def render_args(spec):
    return [spec[k] for k in ("region", "offset", "hsv", "minv", "flip",
                              "mix_idx", "mix_r")]


def render_bound(rows, slot_rows, spec, n_out):
    """Least time for the tap renderer on these inputs: bytes (each tile
    word that a tap of a rendered spec reads, once, the slot table, and the
    float32 output written once) over the memory rate, against its FP32
    operations (``ops/cuda_render.py``'s counts: every rendered spec pixel,
    every owned tap, the HSV round trip of each owned tap whose slot has
    gains other than 1, the mixup) over the FP32 rate.  A partner counts
    once per base that blends it, as the kernel renders it per base.  Also
    returns the counts, and the mean 32-byte sectors that a warp's load of
    one tap touches with the kernel's 8 x 4 pixel footprint and with a
    32 x 1 row."""
    from ryolo_tpu_torch.ops import cuda_render as cr
    from ryolo_tpu_torch.ops.render import tap_sources

    s = rows.shape[-1]
    region, hsv, mix_idx = spec["region"], spec["hsv"], spec["mix_idx"]
    b, t = region.shape[:2]
    dev = rows.device
    mult = np.zeros(b)
    mult[:n_out] += 1
    for j in mix_idx[:n_out]:
        if j >= 0:
            mult[j] += 1
    mult_t = torch.as_tensor(mult, device=dev)
    ident = torch.as_tensor((hsv == 1).all(-1), device=dev)  # (b, t)
    _, taps = tap_sources(s, slot_rows, region, spec["offset"], spec["minv"],
                          dev)
    owned = jittered = 0
    words, sectors = [], {"8x4": [], "32x1": []}
    for owner, lin in taps:
        valid = owner >= 0
        own = owner.clamp(min=0).reshape(b, -1)
        plain = ident.gather(1, own).view_as(owner)
        owned += float((valid.sum((1, 2)) * mult_t).sum())
        jittered += float(((valid & ~plain).sum((1, 2)) * mult_t).sum())
        words.append(lin[valid & (mult_t > 0)[:, None, None]])
        sec = torch.where(valid, lin // 8, -1)[mult_t > 0]  # 8 words a sector
        n = sec.shape[0]
        for key, (h, w) in (("8x4", (4, 8)), ("32x1", (1, 32))):
            grp = sec.reshape(n, s // h, h, s // w, w).permute(0, 1, 3, 2, 4)
            srt = grp.reshape(-1, h * w).sort(-1).values
            new = torch.cat([srt[:, :1] >= 0,
                             (srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)],
                            1)
            sectors[key].append(new.sum(1).float().mean().item())
    distinct = int(torch.unique(torch.cat(words)).numel())
    n_mixed = int((mix_idx[:n_out] >= 0).sum())
    px = s * s
    ops = (cr.OPS_PER_SPEC_PIXEL * px * mult.sum() + cr.OPS_PER_TAP * owned
           + cr.OPS_PER_HSV * jittered + cr.OPS_PER_MIX * n_mixed * px
           + cr.OPS_PER_OUT_PIXEL * n_out * px)
    nbytes = distinct * 4 + b * (10 + 10 * t) * 4 + n_out * 3 * px * 4
    t_ops, t_bytes = ops / H100_FP32_OPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes",
            dict(ops=ops, bytes=nbytes, words=distinct, owned=owned,
                 jittered=jittered, ops_ms=t_ops * 1e3,
                 bytes_ms=t_bytes * 1e3,
                 sectors={k: float(np.mean(v)) for k, v in sectors.items()}))


def phase_render_kernel():
    """The tap renderer against its plain version on the card, bit for
    bit, at the training path's shape (12 specs, 8 outputs, 800 px) in
    both layouts and on probe affines; its time, its bound, the plain
    version's time, and its time with every gain at 1 (no HSV)."""
    from ryolo_tpu_torch.ops import cuda_render as cr
    from ryolo_tpu_torch.ops.render import render_taps_plain

    dev = torch.device("cuda")
    path_b, n_out = BATCH + max(1, -(-BATCH * 2 // 5)), BATCH  # 12, 8
    cases = [("path bank 12x800", path_b, IMG, n_out, "bank"),
             ("path pixel 12x800", path_b, IMG, n_out, "pixel"),
             ("probes 6x64", 6, 64, 4, "bank")]
    rep, max_err = {}, 0.0
    for i, (label, b, s, n, layout) in enumerate(cases):
        rows, slot_rows, spec = render_inputs(b, s, n, layout, SEED + 7 + i,
                                              dev)
        if label.startswith("probes"):
            spec["minv"][0] = [[1, 0, 0], [0, 1, 0]]               # identity
            spec["minv"][1] = [[1, 0, 9e6], [0, 1, -3e7]]          # far off
            spec["minv"][2] = [[0.7071, 0.7071, 5], [0.7071, 0.7071, 9]]
            spec["minv"][3] = [[2.9, -2.7, 60.0], [2.6, 3.1, -40.0]]
        args = render_args(spec)
        got = cr.render_taps(rows, slot_rows, *args, n)
        torch.cuda.synchronize()
        want = render_taps_plain(rows, slot_rows, *args, n)
        n_diff = int((got != want).sum())
        err = float((got - want).abs().max()) * 255
        check(n_diff == 0, f"render kernel vs plain, {label}: {n_diff} "
              f"values differ, max {err}/255")
        max_err = max(max_err, err)
        msg = (f"render {label} ({layout}, {int((spec['mix_idx'] >= 0).sum())}"
               f" of {n} outputs blend a partner): equal to the plain version"
               " bit for bit")
        if label.startswith("probes"):
            log("kernels", msg + " (identity, far off, rank one, |row|_1 "
                "~5.7)")
            continue
        table = cr.to_device(cr.pack_table(slot_rows, *args, n), dev)
        ms = cuda_ms(lambda: cr.launch(rows, table, n), 50)
        call_ms = cuda_ms(lambda: cr.render_taps(rows, slot_rows, *args, n),
                          50)
        plain_ms = cuda_ms(lambda: render_taps_plain(rows, slot_rows, *args,
                                                     n), 3)
        ones = dict(spec, hsv=np.ones_like(spec["hsv"]))
        table1 = cr.to_device(cr.pack_table(slot_rows, *render_args(ones), n),
                              dev)
        ident_ms = cuda_ms(lambda: cr.launch(rows, table1, n), 50)
        bound, by, cnt = render_bound(rows, slot_rows, spec, n)
        log("kernels", f"{msg}; kernel {ms:.4f} ms (with every gain 1, no "
            f"HSV: {ident_ms:.4f} ms; the wrapper's call with the host "
            f"packing and upload of the slot table {call_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({by}: bytes "
            f"{cnt['bytes_ms']:.5f} ms for {cnt['bytes']} B, {cnt['words']} "
            f"distinct tile words read; operations {cnt['ops_ms']:.5f} ms for"
            f" {cnt['ops']:.4g}, {cnt['owned']:.0f} owned taps, "
            f"{cnt['jittered']:.0f} with HSV); 32-byte sectors per warp load"
            f" of a tap: {cnt['sectors']['8x4']:.2f} with the 8 x 4 "
            f"footprint, {cnt['sectors']['32x1']:.2f} with a 32 x 1 row")
        rep[layout] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, ident_ms=ident_ms, call_ms=call_ms)
        del rows, table, table1
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, **rep["bank"], pixel=rep["pixel"])


def write_dota_split(root, names, rng):
    """A DOTA-format split: ``images/*.png`` (1024 px) and
    ``annfiles/*.txt`` rows ``x1 y1 .. x4 y4 class-name difficulty``."""
    import cv2

    for d in ("images", "annfiles"):
        os.makedirs(os.path.join(root, d))
    for i in range(TRAIN_IMAGES):
        img = rng.integers(0, 70, (1024, 1024, 3), dtype=np.uint8)
        rows = []
        for _ in range(int(rng.integers(8, 30))):
            rect = ((float(rng.uniform(60, 964)), float(rng.uniform(60, 964))),
                    (float(rng.uniform(12, 120)), float(rng.uniform(12, 60))),
                    float(rng.uniform(-90, 90)))
            pts = cv2.boxPoints(rect)
            cv2.fillPoly(img, [pts.astype(np.int32)],
                         [int(c) for c in rng.integers(60, 255, 3)])
            name = names[int(rng.integers(0, NC))].replace(" ", "-")
            rows.append(" ".join(f"{v:.1f}" for v in pts.reshape(-1))
                        + f" {name} 0")
        cv2.imwrite(os.path.join(root, "images", f"P{i:04d}.png"), img)
        with open(os.path.join(root, "annfiles", f"P{i:04d}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")


def train_model(cfg, device):
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import weights_init_normal

    model = Yolo(NC, cfg["model"], mode="csl", ver="yolov7")
    weights_init_normal(model, torch.Generator().manual_seed(SEED))
    return model.to(device)


def train_loss_fn(cfg, device):
    from ryolo_tpu_torch.nn import STRIDES, make_anchors
    from ryolo_tpu_torch.train import csl_loss_fn

    return csl_loss_fn(make_anchors(STRIDES, cfg["model"]["anchors"]), NC,
                       cfg["hyp"], device)


TRAIN_RUNS = (("pixel specs", False, "taps"), ("tile bank", True, "taps"),
              ("tile bank", True, "canvas"))
SPANS = ("render", "upload", "kernel", "paste_hsv", "mix_flip", "step")


def phase_train(split, names, cfg):
    """Training steps in three runs: the tap renderer with pixel specs and
    with the tile bank, then the canvas route (paste, HSV, the warp kernel
    B2, mixup and flips) with the tile bank."""
    import ryolo_tpu_torch.data.device_augment as da
    import ryolo_tpu_torch.train.trainer as trainer_mod
    from ryolo_tpu_torch.data.loader import load_data
    from ryolo_tpu_torch.ops import cuda_render, cuda_warp
    from ryolo_tpu_torch.train import Trainer, one_cycle

    hyp, dev = cfg["hyp"], torch.device("cuda")
    lr0, epochs = 0.01, 80  # the train CLI's defaults
    trainer = Trainer(train_model(cfg, dev), train_loss_fn(cfg, dev), "SGD",
                      lr0)
    lf = one_cycle(1, hyp["lrf"], epochs)

    # CUDA events around the render, its stages and the step (wrapping the
    # module functions; the launch counts stay the wrappers')
    spans = {}

    def timed(key, fn):
        def wrapped(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans.setdefault(key, []).append((s, e))
            return out
        return wrapped

    saved = [(trainer_mod, "render_batch"), (cuda_render, "launch"),
             (da, "to_device"), (da, "_canvases"), (da, "warp_canvas"),
             (da, "_mix_flip_tail")]
    saved = [(m, k, getattr(m, k)) for m, k in saved]
    trainer_mod.render_batch = timed("render", trainer_mod.render_batch)
    cuda_render.launch = timed("kernel", cuda_render.launch)
    da.to_device = timed("upload", da.to_device)
    da._canvases = timed("paste_hsv", da._canvases)
    da.warp_canvas = timed("kernel", da.warp_canvas)
    da._mix_flip_tail = timed("mix_flip", da._mix_flip_tail)
    trainer.train_step = timed("step", trainer.train_step)

    results, launches = {}, {}
    counts = (cuda_render.LAUNCHES, "render"), (cuda_warp.LAUNCHES, "warp")
    try:
        for mode, cached, method in TRAIN_RUNS:
            run = f"{mode}, {method}"
            dataset, loader = load_data(
                split, names, "DOTA", hyp, True, img_size=IMG,
                batch_size=BATCH, augment=True, shuffle=True,
                drop_last=True, seed=SEED, workers=4, device_augment=True,
                cache_images=True, device_cache=cached)
            bank = None
            if cached:
                t = time.perf_counter()
                bank = torch.from_numpy(dataset.build_tile_bank()).to(dev)
                log("train", f"tile bank {tuple(bank.shape)} int32, "
                    f"{bank.numel() * 4 / 1e6:.1f} MB, built and uploaded "
                    f"in {time.perf_counter() - t:.3f} s")
            iters = len(loader)
            check(iters >= TRAIN_STEPS, iters)
            nw = max(int(epochs * iters * hyp["warmup_prop"]), 1000)
            torch.cuda.reset_peak_memory_stats()
            rows, it, epoch = [], iter(loader), 0
            # the run's launches only: every count set to 0 just before
            for table, key in counts:
                table[key] = 0
            for step in range(1, TRAIN_STEPS + 1):
                t0 = time.perf_counter()
                batch = next(it)
                wait = time.perf_counter() - t0
                # warm-up of the lr and the accumulation (train.py:210-221)
                acc = max(1, int(np.interp(step, [0, nw],
                                           [1, NBS / BATCH]).round()))
                lr = float(np.interp(step, [0, nw], [0.0, lr0 * lf(epoch)]))
                spans.clear()
                before = {key: table[key] for table, key in counts}
                # the step must not wait for the device: PyTorch reports
                # every synchronizing call it makes while this mode is on
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        _, items = trainer.train_step_rendered(
                            batch, bank, lr, acc, BATCH, method=method)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                syncs = sum("synchroniz" in str(w.message) for w in caught)
                check(step == 1 or syncs == 0,
                      f"{syncs} host syncs in step {step}: "
                      + "; ".join(str(w.message)[:200] for w in caught))
                per_step = {key: table[key] - before[key]
                            for table, key in counts}
                want = ({"render": 1, "warp": 0} if method == "taps"
                        else {"render": 0, "warp": 1})
                check(per_step == want, f"{run} step {step}: launches "
                      f"{per_step}, expected {want}")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                vals = {k: v.item() for k, v in items.items()}
                check(all(math.isfinite(v) for v in vals.values()), vals)
                row = {k: sum(s.elapsed_time(e) for s, e in spans.get(k, []))
                       for k in SPANS}
                row.update(wait=wait * 1e3, wall=wall * 1e3,
                           ips=BATCH / wall,
                           mem=torch.cuda.max_memory_allocated() / 2 ** 30)
                rows.append(row)
                layout = ("bank rows" if "spec_tile_idx" in batch
                          else "pixel tiles")
                log("train", f"{run} step {step} ({layout}, lr {lr:.3g}, "
                    f"accumulate {acc}, host syncs {syncs}, launches "
                    f"{per_step}): " + ", ".join(
                        f"{k} {v:.4g}" for k, v in vals.items())
                    + "; ms " + ", ".join(
                        f"{k} {row[k]:.3f}" for k in SPANS + ("wait", "wall"))
                    + f"; {row['ips']:.2f} images/s; peak {row['mem']:.2f} "
                    "GiB")
                if step == 1:  # its one-off allocations stay out of the peak
                    torch.cuda.reset_peak_memory_stats()
            launches[run] = {key: table[key] for table, key in counts}
            del it
            steady = {k: float(np.mean([r[k] for r in rows[1:]]))
                      for k in rows[0]}
            steady["mem"] = max(r["mem"] for r in rows[1:])

            def spread(k):
                v = [r[k] for r in rows[1:]]
                return (f"{k} {np.mean(v):.3f} / {np.median(v):.3f} "
                        f"[{min(v):.3f}-{max(v):.3f}]")
            keys = ("render", "upload", "kernel") + (
                ("paste_hsv", "mix_flip") if method == "canvas" else ())
            log("train", f"{run}, steps 2..{TRAIN_STEPS}, mean / median "
                "[min-max] (ms; render = the whole render_batch span, "
                "upload = the host arrays it sends up, kernel = the render "
                "or warp launch; step = forward + loss + backward + "
                "optimizer; wait = host wait for the loader): "
                + ", ".join(spread(k) for k in keys + ("step", "wait",
                                                       "wall", "ips"))
                + f"; peak {steady['mem']:.2f} GiB; launches "
                f"{launches[run]} over {TRAIN_STEPS} steps")
            results[run] = steady
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)
    taps = sum(v["render"] for k, v in launches.items() if k.endswith("taps"))
    canvas = launches["tile bank, canvas"]["warp"]
    check(taps == 2 * TRAIN_STEPS and canvas == TRAIN_STEPS,
          f"launches {launches}")
    return dict(render_launches=taps, warp_launches=canvas, results=results)


def phase_train_card_vs_cpu(split, names, cfg):
    from ryolo_tpu_torch.data.device_augment import render_batch
    from ryolo_tpu_torch.data.loader import load_data
    from ryolo_tpu_torch.train import Trainer

    hyp, lr = cfg["hyp"], 0.01
    _, loader = load_data(split, names, "DOTA", hyp, True, img_size=256,
                          batch_size=2, augment=True, shuffle=False,
                          drop_last=True, seed=SEED + 4, workers=2,
                          device_augment=True)
    batch = next(iter(loader))
    # the taps route: the render kernel on the card, its plain version on
    # the CPU (the same float32 operations: bit for bit expected; bound:
    # tests/test_pallas_warp.py:32-36)
    got = render_batch(batch, 2, device="cuda", method="taps").cpu()
    want = render_batch(batch, 2, device="cpu", method="taps")
    diff = (torch.round(got * 255) - torch.round(want * 255)).abs()
    n_diff, err = int((diff > 0).sum()), float(diff.max())
    check(err <= 1 and n_diff <= 1e-3 * diff.numel(), (n_diff, err))
    log("card_vs_cpu", f"render (taps) at 256 px, batch 2 (+"
        f"{len(batch['spec_minv']) - 2} partner slots): {n_diff} of "
        f"{diff.numel()} values differ, max {err:.0f}/255; bit-equal: "
        f"{torch.equal(got, want)}")

    cpu = Trainer(train_model(cfg, "cpu"), train_loss_fn(cfg, "cpu"), "SGD",
                  lr)
    card = Trainer(copy.deepcopy(cpu.model).cuda(), train_loss_fn(cfg, "cuda"),
                   "SGD", lr)
    before = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    _, items_cpu = cpu.train_step_rendered(batch, None, lr, 1, 2)
    _, items_card = card.train_step_rendered(batch, None, lr, 1, 2)
    worst = max(abs(items_card[k].item() / items_cpu[k].item() - 1)
                for k in items_cpu)
    check(worst <= 1e-3, {k: (items_cpu[k].item(), items_card[k].item())
                          for k in items_cpu})
    got_sd = {k: v.cpu() for k, v in card.model.state_dict().items()}
    stat_err, upd, d_gots, d_wants = 0.0, [], [], []
    for k, w in cpu.model.state_dict().items():
        g = got_sd[k]
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, ((g - w).abs().max()
                                      / w.abs().max()).item())
            continue
        dw = (w - before[k]).double().reshape(-1)
        dg = (g - before[k]).double().reshape(-1)
        upd.append(((dg - dw).norm() / dw.norm()).item())
        d_gots.append(dg)
        d_wants.append(dw)
    dg, dw = torch.cat(d_gots), torch.cat(d_wants)
    total = ((dg - dw).norm() / dw.norm()).item()
    # bounds: statistics 1e-3 of the tensor's largest entry; the update's
    # error as the L2 norm over the CPU update's, 0.05 per tensor and 0.01
    # over all parameters (cuDNN's and the CPU's convolution sums differ in
    # order, and the BatchNorms amplify it)
    check(stat_err <= 1e-3, f"BN statistics off by {stat_err}")
    check(max(upd) <= 0.05 and total <= 0.01, (max(upd), total))
    log("card_vs_cpu", f"one SGD step at 256 px, batch 2: loss items within "
        f"{worst:.2e} (rtol 1e-3); BN running statistics within "
        f"{stat_err:.2e} of each tensor's largest entry (bound 1e-3); "
        f"parameter update error (L2 over the CPU update's L2) "
        f"{max(upd):.2e} in the worst tensor (bound 0.05), {total:.2e} over "
        "all parameters (bound 0.01)")


def init_weights(model, gen):
    """Seeded random weights; BN statistics made positive."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("implicit"):
                p.copy_((1.0 if ".im" in name else 0.0)
                        + 0.02 * torch.randn(p.shape, generator=gen))
            elif p.dim() == 4:  # conv kernel, LeCun normal
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
            elif name.endswith("weight"):  # BN scale
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            else:  # BN or head bias
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))


def build_model(cfg):
    from ryolo_tpu_torch.nn import Yolo

    model = Yolo(NC, cfg["model"], mode="csl", ver="yolov7")
    init_weights(model, torch.Generator().manual_seed(SEED))
    return model.eval()


def write_images(folder, rng):
    """Synthetic aerial-like scenes: noise plus filled rotated rectangles,
    square and wide, so the letterbox both scales and pads."""
    import cv2

    os.makedirs(folder)
    for i in range(N_IMAGES):
        h, w = (1024, 1024) if i % 3 else (768, 1024)
        img = rng.integers(0, 70, (h, w, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(10, 40))):
            rect = ((float(rng.uniform(0, w)), float(rng.uniform(0, h))),
                    (float(rng.uniform(8, 120)), float(rng.uniform(8, 60))),
                    float(rng.uniform(-90, 90)))
            pts = cv2.boxPoints(rect).astype(np.int32)
            cv2.fillPoly(img, [pts], [int(c) for c in rng.integers(60, 255, 3)])
        cv2.imwrite(os.path.join(folder, f"im{i:03d}.png"), img)


def phase_main_path(tmp, model):
    import ryolo_tpu_torch.eval.postprocess as pp
    from ryolo_tpu_torch.ops import cuda_nms
    from ryolo_tpu_torch.utils.config import load_yaml

    names = load_yaml(os.path.join(REPO, "configs", "DOTA.yaml"))["names"]
    check(len(names) == NC, names)
    write_images(os.path.join(tmp, "test"), np.random.default_rng(SEED))
    data = os.path.join(tmp, "data.yaml")
    with open(data, "w") as f:
        json.dump({"test": os.path.join(tmp, "test"), "names": names}, f)
    weights = os.path.join(tmp, "w.pth")
    torch.save(model.state_dict(), weights)

    # time every NMS call and kernel launch with CUDA events, by batch, and
    # count the host syncs inside the NMS (wrapping the module functions;
    # the launch counts stay the launchers')
    spans = []

    def timed(key, fn):
        def wrapped(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans[-1][key].append((s, e))
            return out
        return wrapped

    def sync_counted(fn):
        def wrapped(*a, **kw):
            # PyTorch reports every synchronizing call made in this mode
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            # (the mode's one-off notice that it is a prototype is not one)
            spans[-1]["syncs"] += [str(w.message)[:300] for w in caught
                                   if "called a synchronizing" in
                                   str(w.message)]
            return out
        return wrapped

    saved = [(pp, "nms_rotated_masked"), (cuda_nms, "nms_mask"),
             (cuda_nms, "nms_scan")]
    saved = [(m, name, getattr(m, name)) for m, name in saved]
    pp.nms_rotated_masked = timed("nms", sync_counted(pp.nms_rotated_masked))
    cuda_nms.nms_mask = timed("mask", cuda_nms.nms_mask)
    cuda_nms.nms_scan = timed("scan", cuda_nms.nms_scan)
    try:
        return detect_runs(tmp, data, weights, spans)
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def detect_runs(tmp, data, weights, spans):
    from ryolo_tpu_torch.detect import Detect
    from ryolo_tpu_torch.ops import cuda_iou, cuda_nms

    results = {}
    for label, conf, iou, dtype in (("cli_default", 0.7, 0.2, "f32"),
                                    ("eval_load", 0.001, 0.65, "f32"),
                                    ("eval_load_bf16", 0.001, 0.65, "bf16")):
        args = Namespace(
            weight_path=weights, mode="csl", ver="yolov7", conf_thres=conf,
            nms_thres=iou, batch_size=BATCH, img_size=IMG, data=data,
            hyp=os.path.join(REPO, "configs", "hyp.yaml"), ext="png",
            dtype=dtype, packed_input=False, device="cuda")
        det = Detect(args)
        infer = det.infer

        def batch_infer(*a, **kw):
            spans.append({"nms": [], "mask": [], "scan": [], "syncs": []})
            return infer(*a, **kw)

        det.infer = batch_infer
        spans.clear()
        # the main path's launches only: every count set to 0 just before
        cuda_iou.LAUNCHES["rotated_iou"] = 0
        for key in cuda_nms.LAUNCHES:
            cuda_nms.LAUNCHES[key] = 0
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            out = det.detect()
        finally:
            os.chdir(cwd)
        launches = dict(cuda_nms.LAUNCHES)
        iou_launches = cuda_iou.LAUNCHES["rotated_iou"]
        torch.cuda.synchronize()

        check(len(out) == N_IMAGES, len(out))
        n_det = [len(d) for _, d in out]
        for _, d in out:
            check(d.shape[1:] == (7,) and np.isfinite(d).all(), "rows")
            check(((d[:, 6] >= 0) & (d[:, 6] < NC)).all(), "classes")
            check(((d[:, 5] > conf) & (d[:, 5] <= 1)).all(), "scores")
        check(max(n_det) > 0, "no detections")
        nb = len(det.batch_s)
        syncs = [len(b["syncs"]) for b in spans]
        per_batch = [(len(b["mask"]), len(b["scan"])) for b in spans]
        check(len(spans) == nb and all(p == (1, 1) for p in per_batch),
              f"{label}: (nms_mask, nms_scan) launches per batch {per_batch}")
        check(launches == {"nms_mask": nb, "nms_scan": nb}, launches)
        check(iou_launches == 0, f"{iou_launches} pairwise IoU launches")
        check(sum(syncs) == 0, f"{label}: NMS host syncs per batch {syncs}: "
              + "; ".join(m for b in spans for m in b["syncs"]))
        # batch 0 carries cuDNN autotuning: steady numbers from batch 2 on
        steady = det.batch_s[1:]
        ips = BATCH * len(steady) / sum(steady)
        stage = {k: float(np.mean([s[k] for s in det.stage_ms[1:]]))
                 for k in det.stage_ms[0]}
        for key in ("nms", "mask", "scan"):
            stage[key] = float(np.mean([
                sum(s.elapsed_time(e) for s, e in b[key]) for b in spans[1:]]))
        log("main", f"{label} (conf {conf}, iou {iou}, {dtype}): {nb} batches "
            f"of {BATCH} at {IMG} px; {ips:.2f} images/s in infer (batches "
            f"2..{nb}), {N_IMAGES / det.total_s:.2f} images/s wall with "
            "letterbox and drawing; ms per batch " + ", ".join(
                f"{k} {v:.3f}" for k, v in stage.items()))
        log("main", f"{label}: detections per image min {min(n_det)} max "
            f"{max(n_det)}; launches {launches} over {nb} batches (one "
            f"nms_mask and one nms_scan per batch), pairwise rotated_iou "
            f"launches {iou_launches}; NMS host syncs per batch {syncs} "
            "(sync debug mode warn)")
        results[label] = dict(launches=launches, iou_launches=iou_launches,
                              ips=ips, stage=stage)
    return results


def phase_card_vs_cpu(model):
    from ryolo_tpu_torch.eval.postprocess import MAX_WH, post_process_defer
    from ryolo_tpu_torch.nn import STRIDES, fuse_for_inference
    from ryolo_tpu_torch.nn.heads import decode_csl_defer
    from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou
    from ryolo_tpu_torch.ops.rotated_iou import pairwise_rotated_iou_plain

    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.rand(2, 3, 256, 256, generator=gen)
    cpu_model = fuse_for_inference(model, device="cpu")
    gpu_model = fuse_for_inference(model, device="cuda")
    with torch.no_grad():
        h_cpu = cpu_model(x)
        h_gpu = [h.cpu() for h in gpu_model(x.cuda())]
    for r, o in zip(h_cpu, h_gpu):  # tests/test_deploy.py:72-73 bounds
        atol = 1e-4 * r.abs().max().item() + 1e-4
        check(torch.allclose(o, r, rtol=1e-3, atol=atol),
              (o - r).abs().max().item())
    log("card_vs_cpu", "fused head maps within rtol 1e-3, atol "
        "1e-4*max|r|+1e-4 of the CPU")

    dec = decode_csl_defer(h_cpu, cpu_model.anchors, STRIDES, NC)
    conf, iou = 0.001, 0.65
    d_cpu, v_cpu = post_process_defer(dec, h_cpu, 3, NC, conf, iou)
    d_gpu, v_gpu = post_process_defer(dec.cuda(), [h.cuda() for h in h_cpu],
                                      3, NC, conf, iou)
    d_gpu, v_gpu = d_gpu.cpu(), v_gpu.cpu()
    # theta: the same bin; the card divides by 180 as a multiplication by
    # its reciprocal, one ulp off (tests/test_postprocess.py:208-212)
    cols = [0, 1, 2, 3, 5, 6]
    equal = (torch.equal(v_cpu, v_gpu)
             and torch.equal(d_cpu[..., cols], d_gpu[..., cols]))
    theta_err = (d_cpu[..., 4] - d_gpu[..., 4]).abs().max().item()
    n_edge = 0
    if equal:
        check(theta_err <= 1e-6, theta_err)
    else:
        # allowed only where the kernel's and the plain version's IoU of
        # a pair lie on opposite sides of the threshold within 1e-3
        rows = torch.cat([d_cpu[v_cpu], d_gpu[v_gpu]])
        boxes = torch.stack([rows[:, 0] + rows[:, 6] * MAX_WH,
                             rows[:, 1] + rows[:, 6] * MAX_WH, rows[:, 2],
                             rows[:, 3], rows[:, 4] * (180.0 / np.pi)], -1)
        k = pairwise_rotated_iou(boxes.cuda()[None], boxes.cuda()[None])
        p = pairwise_rotated_iou_plain(boxes[None], boxes[None])
        k = k[0].cpu()
        edge = (((k > iou) != (p[0] > iou)) & ((k - iou).abs() < 1e-3)
                & ((p[0] - iou).abs() < 1e-3))
        n_edge = int(edge.sum())
        check(n_edge > 0, "keep sets differ without a knife-edge pair")
    log("card_vs_cpu", f"post-process at conf {conf}, iou {iou}: "
        f"{int(v_cpu.sum())} kept on the CPU, {int(v_gpu.sum())} on the card;"
        f" equal keep sets and detections: {equal} (theta max_abs_err "
        f"{theta_err:.1e}); knife-edge pairs {n_edge}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import ryolo_tpu_torch  # noqa: F401  (fails outside the repository)
    from ryolo_tpu_torch.utils.config import load_yaml

    from ryolo_tpu_torch.ops import cuda_iou

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernels()
    check_launches = cuda_iou.LAUNCHES["rotated_iou"]
    nms = phase_nms_kernels()
    warp = phase_warp_kernel()
    render = phase_render_kernel()
    cfg = load_yaml(os.path.join(REPO, "configs", "hyp.yaml"))
    names = load_yaml(os.path.join(REPO, "configs", "DOTA.yaml"))["names"]
    model = build_model(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        main_res = phase_main_path(tmp, model)
        phase_card_vs_cpu(model)
        del model
        split = os.path.join(tmp, "dota_train")
        write_dota_split(split, names, np.random.default_rng(SEED + 2))
        train = phase_train(split, names, cfg)
        phase_train_card_vs_cpu(split, names, cfg)

    launches = {key: sum(r["launches"][key] for r in main_res.values())
                for key in ("nms_mask", "nms_scan")}
    iou_launches = sum(r["iou_launches"] for r in main_res.values())
    nms_src = "ryolo_tpu_torch/ops/csrc/rotated_nms.cu"
    print(json.dumps({"kernels": [{
        "name": "rotated_iou", "route": "cuda",
        "source": "ryolo_tpu_torch/ops/csrc/rotated_iou.cu",
        "replaces": "off the detect path: B1's IoU runs there inside "
                    "nms_mask; this is the public pairwise_rotated_iou",
        "launches": iou_launches, "check_launches": check_launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None}, {
        "name": "nms_mask", "route": "cuda", "source": nms_src,
        "replaces": "ryolo_tpu/ops/pallas_iou.py:76 (inside "
                    "ryolo_tpu/ops/rotated_nms.py:127-182)",
        "launches": launches["nms_mask"], **nms["mask"],
        "library_ms": None}, {
        "name": "nms_scan", "route": "cuda", "source": nms_src,
        "replaces": "ryolo_tpu/ops/rotated_nms.py:152-212 (XLA while_loop; "
                    "no Pallas kernel)",
        "launches": launches["nms_scan"], **nms["scan"],
        "library_ms": None}, {
        "name": "warp", "route": "cuda",
        "source": "ryolo_tpu_torch/ops/csrc/warp.cu",
        "replaces": "ryolo_tpu/ops/pallas_warp.py:107",
        "launches": train["warp_launches"],
        "max_abs_err": warp["max_abs_err"],
        "ms": warp["ms"], "plain_ms": warp["plain_ms"],
        "bound_ms": warp["bound_ms"], "bound_by": warp["bound_by"],
        "library_ms": warp["library_ms"]}, {
        "name": "render", "route": "cuda",
        "source": "ryolo_tpu_torch/ops/csrc/render.cu",
        "replaces": "ryolo_tpu/ops/pallas_warp.py:107 (B2 redesigned: with "
                    "ryolo_tpu/data/device_augment.py:298, :365 and :648 "
                    "around it)",
        "launches": train["render_launches"],
        "max_abs_err": render["max_abs_err"],
        "ms": render["ms"], "plain_ms": render["plain_ms"],
        "bound_ms": render["bound_ms"], "bound_by": render["bound_by"],
        "library_ms": None}]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
