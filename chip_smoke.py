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
4. detect path: YOLOv7-CSL, nc = 16, seeded random weights (written with
   the port's ``save_pth``), deploy-fused,
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
   version), then one SGD step from the same weights on each;
8. eval path: the ``test`` CLI (``Test(args).run()``) with phase 4's
   weights on a 32-image synthetic DOTA val split at 800 px, batch 8, conf
   0.001, iou 0.65, in f32 and in bf16, each once to warm up and once
   timed: images/s from the first batch request to the AP table, the
   spans of each batch, the host syncs per batch, one ``nms_mask`` and one
   ``nms_scan`` launch per batch;
9. card against CPU, eval, at 256 px, batch 2, on 4 images: the four
   metrics and the val loss;
10. the ``train`` CLI in-process on a 16-image train and an 8-image val
   split at 800 px, batch 8, with the tap renderer and the tile bank: one
   epoch, then ``--resume`` to a second; the epoch split into steps, eval
   and saves, one ``render`` launch per step, checkpoints that load;
11. YOLOv5-CSL (the CLIs' default ``--ver``) at the same full width, its
   seeded random weights written with the port's ``save_pth``: detect as
   in phase 4 (both loads in f32, eval load in bf16), card against CPU as
   in phase 5, the ``test`` CLI as in phase 8 in f32, and 7 training steps
   as in phase 6 with the tap renderer and the tile bank;
12. YOLOv4-CSL likewise: detect at eval load in f32 and 5 training steps
   with the tap renderer and the tile bank;
13. YOLOv7 with the KFIoU head (18 rotated anchors, the deferred KFIoU
   decode, the KF loss) at the same full width: detect as in phase 4 (both
   loads in f32, eval load in bf16; 236,250 candidates an image at 800 px
   into the same two NMS kernels), card against CPU as in phase 5, the
   ``test`` CLI as in phase 8 in f32, 7 training steps as in phase 6 with
   the tap renderer and the tile bank, and one card-against-CPU SGD step as
   in phase 7;
14. YOLOv5-KFIoU: detect at eval load in f32 and 5 training steps with the
   tap renderer and the tile bank;
15. bf16 training, YOLOv7-CSL (``Trainer(dtype=torch.bfloat16)``: the
   forward in bf16, parameters, gradients, optimizer, BatchNorm statistics
   and loss in float32): 7 steps as in phase 6 with the tap renderer and
   the tile bank, one card-against-CPU SGD step as in phase 7 (both in
   bf16), the ``train`` CLI with ``--dtype bf16`` as in phase 10 (its
   per-epoch eval fused in bf16), and one profiled step in bf16 and in
   float32 (the device's busy time by kernel kind);
16. the int8 deploy path (``--dtype int8``: bf16 with the wide convs int8 x
   int8 -> int32 by ``torch._int_mm``), YOLOv7-CSL: detect as in phase 4 at
   both loads with dynamic activation scales and at eval load with static
   scales calibrated on the first batch; one forward at 800 px, batch 8,
   with every quantized conv's int32 accumulator held to its float64 plain
   version bit for bit; card against CPU at 256 px within the
   int8-vs-float32 envelope; the ``test`` CLI as in phase 8 with ``--dtype
   int8``; then YOLOv5-CSL's int8 detect at eval load;
17. data parallelism (``train --dp N``, ``ryolo_tpu_torch.parallel``):
   (a) phase 6's run (v7-CSL, 800 px, batch 8, taps + bank, 7 steps) as
   one rank of a world-1 NCCL group on ``cuda:0`` (synced BatchNorms, loss
   means over global counts, the gradient all-reduce), its first update
   against the plain ``Trainer``'s on the same batch, its step times beside
   phase 6's, one profiled step with the all-reduces' device time by kind;
   (b) two ranks spawned by ``ryolo_tpu_torch.parallel.launch``, both on
   ``cuda:0`` over gloo (NCCL refuses two ranks on one device; gloo's
   all-reduce and broadcast take CUDA tensors, and its object collectives
   go through the host), each loading its half of the global batch of 8:
   the first step held against (a)'s on the same global batch, one render
   launch a rank a step, then ``Train(args).train()`` in each rank for an
   epoch of 2 steps with the sharded eval (one ``nms_mask`` and one
   ``nms_scan`` a rank) and ``--resume`` to a second, checkpoints from rank
   0 alone; (c) the same over NCCL on two cards, only where there are two.
   A failing rank fails the script.
18. spatial sharding (``train --dp N --sp S``,
   ``ryolo_tpu_torch.parallel.spatial``): (a) two ranks by ``launch``
   sharing ``cuda:0`` over gloo under ``make_mesh(2, sp=2)``, one group of
   phase 6's global batch of 8 split by height (rows 416 + 384), for
   v7-CSL and v5-CSL: the gathered training-mode head maps before any
   update against one process's forward (with the synced and with cuDNN's
   BatchNorm) within 5x that forward's own envelope (the batch reversed,
   channels-last), and against the halo rows zeroed, which must fail; 3
   steps (one render a rank a step, every halo collective counted, no host
   sync outside the collectives after step 1, each rank's peak memory
   against phase 6's and 11's), the first held against the plain
   ``Trainer``'s first step on the same batch, and a step with the loss
   counts summed over all ranks, which must fail; (b) then
   ``Train(args).train()`` with ``--dp 2 --sp 2`` in each rank, an epoch
   and ``--resume``, its eval one ``nms_mask`` and one ``nms_scan`` a rank
   a batch; (c) ``--dp 4 --sp 2`` over NCCL, only where there are four
   cards.
19. trained weights (the recipe of ``tests/test_torch_e2e.py``, after
   ``tests/test_trained_parity.py``): (a) YOLOv5-CSL (520 steps) and
   YOLOv5-KFIoU (900 steps, lr x 0.1 after step 400), nc = 2, from
   ``weights_init_normal`` on the synthetic set (8 train and 4 val images
   at 96 px, written by :func:`write_custom_set`, the files of
   ``tests/make_synth_data.py``), trained on the card in float32 with Adam
   at 2e-3, batch 4, no augmentation: the loss criterion (the last 10
   losses below half the first 10), the step time from CUDA events and the
   host wait; (b) ``evaluate`` of the trained weights on the val split on
   the card in float32, bf16 and int8 (the float32 graph with the wide
   convs int8) and on the CPU in float32, and on the training images in
   float32 on the card and the CPU: card against CPU within 5e-3 on both
   mAPs and both splits, the floors of ``TRAINED_FLOORS`` in float32 and
   bf16 (CSL: mAP@.5 above 0.14 on the val split, 0.5 on the training
   images; KFIoU: 0.02), bf16's and int8's mAP against float32, the int8
   graph's products exact and its decoded rows card against CPU
   (``INT8_TRAINED_BOUND``), one ``nms_mask`` and one ``nms_scan`` a card
   batch; (c) the
   trained CSL model's ``evaluate`` on 16 scenes at 800 px with 100-200
   objects at the trained pixel size, batch 8, conf 0.001, iou 0.65, timed
   as phase 8: images/s, the candidates into the NMS and the boxes kept per
   image, the post-process, ``nms_mask``, ``nms_scan`` and matcher ms a
   batch, ``nms_mask``'s bound at the pairs the far reject leaves.

Phases 11-14 and 16 run beside the YOLOv7-CSL phases that share their data:
their detect and eval after phase 9, their training (and phase 15) after
phase 10; phases 17, 18 and 19 run last.  The eval
runs of v7-CSL, v5-CSL and v7-KFIoU also count, on their second batch,
the pairs of the NMS mask that the far reject leaves, for ``nms_mask``'s
bound at the path's own shape.

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
import threading
import time
import traceback
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
SHORT_TRAIN_STEPS = 5  # YOLOv4-CSL and YOLOv5-KFIoU
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def check(ok, what):
    """Fail the run (a raise, so it holds under ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


T_START = time.perf_counter()


def log(phase, msg):
    print(f"[{phase} {time.perf_counter() - T_START:.1f} s] {msg}",
          flush=True)


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


def mask_bound(boxes, valid):
    """``nms_mask``'s bound on one batch of NMS input ``(boxes, valid)``
    (score-sorted, class-offset, degrees): the valid pairs the mask
    decides, those the far reject cannot rule out, the words it writes."""
    from ryolo_tpu_torch.ops.rotated_nms import decided_rows

    n_rows = decided_rows(valid)
    rows_total = int(n_rows.sum())
    n_pairs, n_near = pair_counts(boxes, valid, n_rows)
    words = int(sum((torch.arange(n, device=boxes.device) // 64 + 1).sum()
                    for n in n_rows.tolist()))
    t_ops = mask_ops(n_pairs, n_near, rows_total) / H100_FP32_OPS
    t_bytes = (rows_total * 20 + words * 8 + len(boxes) * 4) \
        / H100_BYTES_PER_S
    return dict(valid=valid.sum(1).tolist(), pairs=n_pairs, near=n_near,
                words=words, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


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
    mb = mask_bound(boxes, valid)
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
        bound, by = mb["bound_ms"], mb["bound_by"]
        ops_all = (mb["pairs"] * OPS_PER_PAIR
                   + rows_total * (OPS_PER_ROW_BOX + OPS_PER_COL_BOX))
        log("kernels", f"nms_mask {BATCH}x{k} (valid {n_rows.tolist()}) at "
            f"thr {thr}: {int(got.sum())} bits set, {len(diff)} differ from "
            "the plain version (each within 1e-5 of thr); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound:.5f} ms "
            f"({by}: {mb['pairs']} valid pairs, {mb['near']} not ruled out "
            f"by the far reject, {mb['words']} words written); bound with "
            f"every valid pair clipped {ops_all / H100_FP32_OPS * 1e3:.5f} ms")

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


def write_dota_split(root, names, rng, n=TRAIN_IMAGES):
    """A DOTA-format split of ``n`` images: ``images/*.png`` (1024 px) and
    ``annfiles/*.txt`` rows ``x1 y1 .. x4 y4 class-name difficulty``."""
    import cv2

    for d in ("images", "annfiles"):
        os.makedirs(os.path.join(root, d))
    for i in range(n):
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


SYNTH_NAMES = ["greenbox", "redbox"]


def write_custom_split(out_dir, n_images, img_size, rng, w_range=(0.08, 0.18),
                       ratio=(1.5, 3.0), max_obj=5, min_obj=1):
    """A custom-format split (``im*.png`` and ``im*.txt`` rows ``cx cy w h
    theta class``, pixels and radians) of ``n_images`` noisy scenes with
    filled rotated rectangles of the two classes of :data:`SYNTH_NAMES`,
    drawn from ``rng`` in the order of ``tests/make_synth_data.py``'s
    ``make_split``, so the same ``rng`` writes the same files."""
    import cv2

    from ryolo_tpu_torch.data.datasets import xywha_to_polys_np

    n_classes = len(SYNTH_NAMES)
    os.makedirs(out_dir, exist_ok=True)
    for _ in range(n_classes):  # make_split's palette draws, overwritten
        rng.integers(30, 255, 3)
    palette = [(40, 200, 40), (40, 40, 220)]
    for i in range(n_images):
        img = rng.integers(0, 60, (img_size, img_size, 3)).astype(np.uint8)
        rows = []
        for _ in range(int(rng.integers(min_obj, max_obj))):
            cls = int(rng.integers(0, n_classes))
            w = float(rng.uniform(*w_range) * img_size)
            h = min(w * float(rng.uniform(*ratio)), img_size * 0.45)
            x = float(rng.uniform(h, img_size - h))
            y = float(rng.uniform(h, img_size - h))
            t = float(rng.uniform(-np.pi / 2, np.pi / 2 - 1e-3))
            poly = xywha_to_polys_np(
                np.array([[x, y, w, h, t]], np.float32))[0].astype(np.int32)
            cv2.fillPoly(img, [poly], palette[cls])
            rows.append(f"{x:.2f} {y:.2f} {w:.2f} {h:.2f} {t:.5f} {cls}")
        cv2.imwrite(os.path.join(out_dir, f"im{i:03d}.png"), img)
        with open(os.path.join(out_dir, f"im{i:03d}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")


def write_custom_set(root, n_images, img_size, seed, w_range, ratio):
    """``<root>/train`` (``n_images``) and ``<root>/val`` (half as many,
    at least 2), as ``tests/make_synth_data.py``'s ``main`` writes them
    (its ``test`` split and ``data.yaml`` come after and are not
    needed)."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_images), ("val", max(n_images // 2, 2))):
        write_custom_split(os.path.join(root, split), n, img_size, rng,
                           w_range, ratio)


def tag(ver, mode):
    """``yolov5`` for the CSL head, ``yolov5-kfiou`` for the KFIoU head."""
    return ver if mode == "csl" else f"{ver}-{mode}"


def train_model(cfg, device, ver="yolov7", mode="csl"):
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.train import weights_init_normal

    model = Yolo(NC, cfg["model"], mode=mode, ver=ver)
    weights_init_normal(model, torch.Generator().manual_seed(SEED))
    return model.to(device)


def train_loss_fn(cfg, model, device):
    """The loss of ``model``'s head, with its anchors on ``device``."""
    from ryolo_tpu_torch.train import LOSS_FNS

    return LOSS_FNS[model.mode](model.anchors, NC, cfg["hyp"], device)


TRAIN_RUNS = (("pixel specs", False, "taps"), ("tile bank", True, "taps"),
              ("tile bank", True, "canvas"))
SPANS = ("render", "upload", "kernel", "paste_hsv", "mix_flip", "step")


def phase_train(split, names, cfg, ver="yolov7", runs=TRAIN_RUNS,
                steps=TRAIN_STEPS, mode="csl", dtype="f32"):
    """``steps`` training steps of ``ver`` with the ``mode`` head in each of
    ``runs``: by default the tap renderer with pixel specs and with the
    tile bank, then the canvas route (paste, HSV, the warp kernel B2, mixup
    and flips) with the tile bank; ``dtype`` "bf16" runs the forward in
    bf16 (``Trainer(dtype=torch.bfloat16)``)."""
    import ryolo_tpu_torch.data.device_augment as da
    import ryolo_tpu_torch.train.trainer as trainer_mod
    from ryolo_tpu_torch.data.loader import load_data
    from ryolo_tpu_torch.ops import cuda_render, cuda_warp
    from ryolo_tpu_torch.train import Trainer, one_cycle

    hyp, dev = cfg["hyp"], torch.device("cuda")
    lr0, epochs = 0.01, 80  # the train CLI's defaults
    torch.cuda.empty_cache()
    model = train_model(cfg, dev, ver, mode)
    trainer = Trainer(model, train_loss_fn(cfg, model, dev), "SGD", lr0,
                      TORCH_DTYPES[dtype])
    lf = one_cycle(1, hyp["lrf"], epochs)
    name = tag(ver, mode) + ("" if dtype == "f32" else f" {dtype}")

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
        for specs, cached, method in runs:
            run = f"{specs}, {method}"
            dataset, loader = load_data(
                split, names, "DOTA", hyp, mode == "csl", img_size=IMG,
                batch_size=BATCH, augment=True, shuffle=True,
                drop_last=True, seed=SEED, workers=4, device_augment=True,
                cache_images=True, device_cache=cached)
            bank = None
            if cached:
                t = time.perf_counter()
                bank = torch.from_numpy(dataset.build_tile_bank()).to(dev)
                log("train", f"{name}: tile bank {tuple(bank.shape)} int32, "
                    f"{bank.numel() * 4 / 1e6:.1f} MB, built and uploaded "
                    f"in {time.perf_counter() - t:.3f} s")
            iters = len(loader)
            check(iters >= steps, iters)
            nw = max(int(epochs * iters * hyp["warmup_prop"]), 1000)
            torch.cuda.reset_peak_memory_stats()
            rows, it, epoch = [], iter(loader), 0
            # the run's launches only: every count set to 0 just before
            for table, key in counts:
                table[key] = 0
            for step in range(1, steps + 1):
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
                check(all(p.dtype == torch.float32
                          for p in model.parameters()), "parameters f32")
                row = {k: sum(s.elapsed_time(e) for s, e in spans.get(k, []))
                       for k in SPANS}
                row.update(wait=wait * 1e3, wall=wall * 1e3,
                           ips=BATCH / wall,
                           mem=torch.cuda.max_memory_allocated() / 2 ** 30)
                rows.append(row)
                layout = ("bank rows" if "spec_tile_idx" in batch
                          else "pixel tiles")
                log("train", f"{name} {run} step {step} ({layout}, lr "
                    f"{lr:.3g}, "
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
            log("train", f"{name} {run}, steps 2..{steps}, mean / median "
                "[min-max] (ms; render = the whole render_batch span, "
                "upload = the host arrays it sends up, kernel = the render "
                "or warp launch; step = forward + loss + backward + "
                "optimizer; wait = host wait for the loader): "
                + ", ".join(spread(k) for k in keys + ("step", "wait",
                                                       "wall", "ips"))
                + f"; peak {steady['mem']:.2f} GiB; launches "
                f"{launches[run]} over {steps} steps")
            results[run] = dict(steady, walls=[r["wall"] for r in rows[1:]],
                                steps=[r["step"] for r in rows[1:]])
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)
    want = {f"{specs}, {method}": {"render": steps * (method == "taps"),
                                   "warp": steps * (method == "canvas")}
            for specs, _, method in runs}
    check(launches == want, f"{name} launches {launches}, expected {want}")
    return dict(render_launches=sum(v["render"] for v in launches.values()),
                warp_launches=sum(v["warp"] for v in launches.values()),
                results=results)


# kernel kinds of a profiled training step, by the kernel's name
KERNEL_KINDS = (("layout", ("nchwToNhwc", "nhwcToNchw")),
                ("batch norm", ("batch_norm", "bn_")),
                ("conv", ("conv", "xmma", "dgrad", "wgrad", "gemm")))


def phase_train_profile(split, names, cfg):
    """One v7-CSL training step of 8 at 800 px (taps, tile bank) under
    ``torch.profiler``, in bf16 and in float32, after 3 unprofiled steps:
    the wall, the device's busy time (the sum of kernel times) and its
    split by kernel kind."""
    from ryolo_tpu_torch.data.loader import load_data
    from ryolo_tpu_torch.train import Trainer

    dataset, loader = load_data(
        split, names, "DOTA", cfg["hyp"], True, img_size=IMG,
        batch_size=BATCH, augment=True, shuffle=True, drop_last=True,
        seed=SEED, workers=4, device_augment=True, cache_images=True,
        device_cache=True)
    bank = torch.from_numpy(dataset.build_tile_bank()).cuda()
    it = iter(loader)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for dtype in ("bf16", "f32"):
        model = train_model(cfg, "cuda")
        trainer = Trainer(model, train_loss_fn(cfg, model, "cuda"), "SGD",
                          0.01, TORCH_DTYPES[dtype])
        for _ in range(3):
            trainer.train_step_rendered(next(it), bank, 1e-5, 1, BATCH)
        batch = next(it)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            trainer.train_step_rendered(batch, bank, 1e-5, 1, BATCH)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        kinds = {k: 0.0 for k, _ in KERNEL_KINDS}
        kinds["other"], n = 0.0, 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            n += 1
            kind = next((k for k, keys in KERNEL_KINDS
                         if any(key in e.name for key in keys)), "other")
            kinds[kind] += e.self_device_time_total / 1e3
        busy = sum(kinds.values())
        check(n > 0 and busy > 0, "the profiler saw no kernel")
        log("train_profile", f"yolov7 {dtype} step (8 at {IMG} px, taps, "
            f"tile bank, profiled): wall {wall:.1f} ms, device busy "
            f"{busy:.1f} ms ({100 * busy / wall:.0f}% of the wall) in {n} "
            "kernels: " + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items())
            + " ms")
        del trainer, model
    del it, bank


# card against CPU, one float32 SGD step: loss items (rtol), BN statistics
# (of the tensor's largest entry), the update's L2 error in the worst tensor
# and over all parameters; cuDNN's and the CPU's convolution sums differ in
# order, and the BatchNorms amplify it
F32_STEP_BOUNDS = {"items": 1e-3, "stats": 1e-3, "tensor": 0.05,
                   "total": 0.01}
# bf16, card against CPU, each as a multiple of the CPU's own bf16-to-float32
# distance (the same quantity, the CPU's float32 step against its bf16
# one).  At random weights and train-mode BatchNorms a rounding grows with
# depth: the bf16 step departs from the float32 one by 0.004 at the first
# block, 0.69 at the last and 1.46 in the update (L2 over L2), and a card
# that rounds at the same places departs from the CPU in the same way from
# its first flipped bf16 value on.  The card and the CPU round to bf16 at
# the same places (autocast's), so on an H100 80GB HBM3 at 700 W the first
# block agrees to 0.015 of the distance, deeper blocks to 0.65 at most, the
# update of each parameter that rounding moves by less than 0.3 (``held``)
# to 0.70-1.10 of its own distance, the BN statistics to 0.52-0.74, and
# the card's bf16 step lies about 0.95 times the distance from the float32
# one.  ``held`` follows cuDNN's algorithm search, on as the train CLI sets
# it.  Its high readings come from two parameters whose update bf16 moves
# by under 1% (``neck.ia3.implicit`` 0.88%, ``neck.conv7.conv.0.bias``
# 0.94%), and go with the Hopper fprop kernel
# ``sm90_xmma_fprop_implicit_gemm_bf16..._tilesize128x128x32``, which the
# search picks for some forward convolutions and the heuristic never does:
# of 25 steps on fresh caches (scripts/torch_bf16_step_spread.py) the 12
# with it read 0.726-0.900, the 13 without 0.699-0.715; one whole-script
# run read 1.10.  Two bf16 steps that round at independent places read
# about sqrt(2) there, so the bound is 1.4.  A float32 card step reads 1.0
# at the first block and 0.003 in ``own`` (1.0 in ``held``); an unchanged
# state reads over 100 in ``held``; both fail, and the phase asserts that
# they do.
BF16_STEP_BOUNDS = {"items": 0.03, "first": 0.05, "blocks": 0.9,
                    "held_below": 0.3, "n_held": 5, "held": 1.4,
                    "stats": 1.0,
                    "own": (0.5, 2.0)}


def step_gaps(got, want, before):
    """``(BN statistics error, worst tensor's update error, all
    parameters' update error)`` of state_dict ``got`` against ``want``,
    the updates from ``before``."""
    stat_err, upd, d_gots, d_wants = 0.0, [], [], []
    for k, w in want.items():
        g = got[k]
        check(not g.is_floating_point() or g.dtype == torch.float32, k)
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
    return stat_err, max(upd), ((dg - dw).norm() / dw.norm()).item()


def card_vs_cpu_batch(split, names, cfg, mode):
    """The first 256 px, batch-2 loader batch of the card-against-CPU
    steps."""
    from ryolo_tpu_torch.data.loader import load_data

    _, loader = load_data(split, names, "DOTA", cfg["hyp"], mode == "csl",
                          img_size=256,
                          batch_size=2, augment=True, shuffle=False,
                          drop_last=True, seed=SEED + 4, workers=2,
                          device_augment=True)
    return next(iter(loader))


def phase_train_card_vs_cpu(split, names, cfg, mode="csl"):
    """The render and one YOLOv7 SGD step with the ``mode`` head, card
    against CPU at 256 px, batch 2."""
    from ryolo_tpu_torch.train import Trainer

    lr = 0.01
    name = tag("yolov7", mode)
    batch = card_vs_cpu_batch(split, names, cfg, mode)
    check_render_card_vs_cpu(batch, name)
    model = train_model(cfg, "cpu", mode=mode)
    cpu = Trainer(model, train_loss_fn(cfg, model, "cpu"), "SGD", lr)
    card = Trainer(copy.deepcopy(model).cuda(),
                   train_loss_fn(cfg, model, "cuda"), "SGD", lr)
    before = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    _, items_cpu = cpu.train_step_rendered(batch, None, lr, 1, 2)
    _, items_card = card.train_step_rendered(batch, None, lr, 1, 2)
    worst = max(abs(items_card[k].item() / items_cpu[k].item() - 1)
                for k in items_cpu)
    gaps = step_gaps({k: v.cpu() for k, v in card.model.state_dict().items()},
                     cpu.model.state_dict(), before)
    bounds = F32_STEP_BOUNDS
    log("card_vs_cpu", f"{name}: one SGD step at 256 px, batch 2: loss "
        f"items {sorted(items_cpu)} within {worst:.2e} (rtol "
        f"{bounds['items']:.3g}); BN running statistics within "
        f"{gaps[0]:.2e} of each tensor's largest entry (bound "
        f"{bounds['stats']:.3g}); parameter update error (L2 over the CPU "
        f"update's L2) {gaps[1]:.2e} in the worst tensor (bound "
        f"{bounds['tensor']:.3g}), {gaps[2]:.2e} over all parameters "
        f"(bound {bounds['total']:.3g}); parameters, gradients and "
        "statistics float32")
    check(worst <= bounds["items"],
          {k: (items_cpu[k].item(), items_card[k].item()) for k in items_cpu})
    check(all(g <= bounds[k] for g, k in zip(
        gaps, ("stats", "tensor", "total"))), (gaps, bounds))


def captured_step(model, cfg, batch, device, dtype, lr=0.01):
    """One SGD step of a copy of ``model`` on ``device`` with the forward
    in ``dtype``: ``(loss items, {block: output}, state after)`` on the
    CPU, a block being each module one level below the backbone, neck
    and head."""
    from ryolo_tpu_torch.train import Trainer

    m = copy.deepcopy(model).to(device)
    tr = Trainer(m, train_loss_fn(cfg, m, device), "SGD", lr,
                 TORCH_DTYPES[dtype])
    blocks = {}

    def keep(name):
        def hook(_module, _inputs, out):
            if torch.is_tensor(out):
                blocks[name] = out.detach().cpu()
        return hook

    hooks = [mod.register_forward_hook(keep(n))
             for n, mod in m.named_modules() if n.count(".") == 1]
    _, items = tr.train_step_rendered(batch, None, lr, 1, 2)
    for h in hooks:
        h.remove()
    return ({k: v.item() for k, v in items.items()}, blocks,
            {k: v.cpu() for k, v in m.state_dict().items()})


def bf16_step_gaps(got, cpu16, cpu32, before):
    """A bf16 step ``got`` against the CPU's bf16 step ``cpu16``, each
    distance over the CPU's float32 step ``cpu32``'s from ``cpu16`` (the
    three as :func:`captured_step` returns them; BF16_STEP_BOUNDS says
    what each holds)."""
    def rel(a, b):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        return ((a - b).norm() / b.norm()).item()

    (items, blocks, state), (items16, blocks16, state16) = got, cpu16
    blocks32, state32 = cpu32[1], cpu32[2]
    names = list(blocks16)
    env_blocks = [rel(blocks32[n], blocks16[n]) for n in names]
    ratios = [rel(blocks[n], blocks16[n]) / e
              for n, e in zip(names, env_blocks)]
    params = [k for k in state16 if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    stats = [k for k in state16 if k.endswith(("running_mean",
                                               "running_var"))]
    err, env = {}, {}
    for k in params:
        d, d16, d32 = ((sd[k] - before[k]) for sd in (state, state16, state32))
        err[k], env[k] = rel(d, d16), rel(d32, d16)
    held = [k for k in params if env[k] < BF16_STEP_BOUNDS["held_below"]]
    cat = lambda sd: torch.cat([(sd[k] - before[k]).double().reshape(-1)
                                for k in params])
    stat_gap = lambda sd: max(((sd[k] - state16[k]).abs().max()
                               / state16[k].abs().max()).item()
                              for k in stats)
    env_update = rel(cat(state32), cat(state16))
    return {"items": max(abs(items[k] / items16[k] - 1) for k in items16),
            "dtypes": all(blocks[n].dtype == blocks16[n].dtype
                          for n in names),
            "first": ratios[0], "blocks": max(ratios),
            "n_held": len(held), "held": max(err[k] / env[k] for k in held),
            "stats": stat_gap(state) / stat_gap(state32),
            "own": rel(cat(state), cat(state32)) / rel(cat(state16),
                                                        cat(state32)),
            # the CPU's own bf16-to-float32 distances: the first and the
            # last block, the update over all parameters
            "env_first": env_blocks[0], "env_last": env_blocks[-1],
            "env_update": env_update}


def bf16_step_within(g):
    b = BF16_STEP_BOUNDS
    return (g["dtypes"] and g["items"] <= b["items"]
            and g["first"] <= b["first"] and g["blocks"] <= b["blocks"]
            and g["n_held"] >= b["n_held"] and g["held"] <= b["held"]
            and g["stats"] <= b["stats"]
            and b["own"][0] <= g["own"] <= b["own"][1])


def phase_train_card_vs_cpu_bf16(split, names, cfg):
    """One YOLOv7-CSL SGD step with the forward in bf16, card against CPU
    at 256 px, batch 2: the loss items, every block's output, the update
    and the BN statistics, each against the CPU's own bf16-to-float32
    distance (BF16_STEP_BOUNDS), the card's convolutions chosen by cuDNN's
    algorithm search, as the train CLI runs them; a float32 card step and
    an unchanged state must fail the same bounds."""
    batch = card_vs_cpu_batch(split, names, cfg, "csl")
    model = train_model(cfg, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cpu16 = captured_step(model, cfg, batch, "cpu", "bf16")
    cpu32 = captured_step(model, cfg, batch, "cpu", "f32")
    torch.backends.cudnn.benchmark = True  # as the train CLI sets it
    card16 = captured_step(model, cfg, batch, "cuda", "bf16")
    card32 = captured_step(model, cfg, batch, "cuda", "f32")
    g = bf16_step_gaps(card16, cpu16, cpu32, before)
    f32 = bf16_step_gaps(card32, cpu16, cpu32, before)
    still = bf16_step_gaps(card16[:2] + (before,), cpu16, cpu32, before)
    fmt = lambda g: ", ".join(f"{k} {v:.3g}" for k, v in g.items()
                              if k != "dtypes" and not k.startswith("env"))
    log("card_vs_cpu", f"yolov7 bf16: one SGD step at 256 px, batch 2: the "
        f"CPU's own bf16-to-float32 distance (L2 over L2) {g['env_first']:.3g}"
        f" at the first block, {g['env_last']:.3g} at the last, "
        f"{g['env_update']:.3g} in the update; the card's bf16 step, "
        f"over that distance: {fmt(g)}; bounds "
        f"{BF16_STEP_BOUNDS}; a float32 card step reads {fmt(f32)}; an "
        f"unchanged state {fmt(still)}; parameters, gradients and "
        "statistics float32")
    check(all(not v.is_floating_point() or v.dtype == torch.float32
              for v in card16[2].values()), "bf16 step state dtypes")
    check(bf16_step_within(g), g)
    check(not bf16_step_within(f32) and not bf16_step_within(still),
          (f32, still))


def check_render_card_vs_cpu(batch, name):
    """The taps route: the render kernel on the card, its plain version on
    the CPU (the same float32 operations: bit for bit expected; bound:
    tests/test_pallas_warp.py:32-36)."""
    from ryolo_tpu_torch.data.device_augment import render_batch

    got = render_batch(batch, 2, device="cuda", method="taps").cpu()
    want = render_batch(batch, 2, device="cpu", method="taps")
    diff = (torch.round(got * 255) - torch.round(want * 255)).abs()
    n_diff, err = int((diff > 0).sum()), float(diff.max())
    check(err <= 1 and n_diff <= 1e-3 * diff.numel(), (n_diff, err))
    log("card_vs_cpu", f"{name}: render (taps) at 256 px, batch 2 (+"
        f"{len(batch['spec_minv']) - 2} partner slots): {n_diff} of "
        f"{diff.numel()} values differ, max {err:.0f}/255; bit-equal: "
        f"{torch.equal(got, want)}")


# With init_weights alone the v4/v5 head logits stay within about +-0.7
# (v7's reach +-4 through its RepConv and implicit heads), so no score
# passes the detect CLI's conf 0.7; shifting the obj and class biases by +2
# puts every score in 0.74-0.82 at 320 px, and the NMS runs at its full
# width (K = 5000 a batch image) at both loads, as with v7-CSL's weights.
# v7-KFIoU's scores, a product over 18 anchors' obj and class logits, stay
# below 0.7 too (0.69 at most at 256 px on the CPU); with the prior 84% of
# them pass it (v5-KFIoU: all).
SCORE_PRIOR = 2.0
# each head's obj and class channels within an anchor's features: CSL [x,
# y, w, h, obj, classes, theta bins], KFIoU [x, y, w, h, theta, obj,
# classes]
SCORE_CHANNELS = {"csl": slice(4, 5 + NC), "kfiou": slice(5, 6 + NC)}


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


def build_model(cfg, ver="yolov7", mode="csl"):
    """The detect and eval model of ``ver`` with the ``mode`` head:
    :func:`init_weights`, and but for v7-CSL the score prior of
    :data:`SCORE_PRIOR` on the obj and class channels."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.nn.blocks import ConvBlock

    model = Yolo(NC, cfg["model"], mode=mode, ver=ver)
    init_weights(model, torch.Generator().manual_seed(SEED))
    if (ver, mode) != ("yolov7", "csl"):
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, ConvBlock) and len(mod.conv) == 1:
                    # a head conv, anchor-major
                    bias = mod.conv[0].bias.view(model.na, model.nf)
                    bias[:, SCORE_CHANNELS[mode]] += SCORE_PRIOR
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


DETECT_RUNS = (("cli_default", 0.7, 0.2, "f32"),
               ("eval_load", 0.001, 0.65, "f32"),
               ("eval_load_bf16", 0.001, 0.65, "bf16"))
# the int8 deploy path (--dtype int8): dynamic activation scales at both
# loads, then static scales calibrated on the first batch
DETECT_RUNS_INT8 = (("cli_default_int8", 0.7, 0.2, "int8"),
                    ("eval_load_int8", 0.001, 0.65, "int8"),
                    ("eval_load_int8_static", 0.001, 0.65, "int8"))


def phase_main_path(tmp, model, runs=DETECT_RUNS):
    """The detect CLI on ``model`` (its weights written with the port's
    ``save_pth`` to ``<tmp>/<ver>.pth``), one run per ``(label, conf,
    iou, dtype)`` of ``runs``; returns ``(results, weights path)``."""
    import ryolo_tpu_torch.eval.postprocess as pp
    from ryolo_tpu_torch.ops import cuda_nms
    from ryolo_tpu_torch.utils.checkpoint import save_pth
    from ryolo_tpu_torch.utils.config import load_yaml

    names = load_yaml(os.path.join(REPO, "configs", "DOTA.yaml"))["names"]
    check(len(names) == NC, names)
    if not os.path.isdir(os.path.join(tmp, "test")):
        write_images(os.path.join(tmp, "test"), np.random.default_rng(SEED))
    data = os.path.join(tmp, "data.yaml")
    with open(data, "w") as f:
        json.dump({"test": os.path.join(tmp, "test"), "names": names}, f)
    weights = os.path.join(tmp, f"{tag(model.ver, model.mode)}.pth")
    save_pth(model, weights)

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
        return detect_runs(tmp, data, weights, spans, model.ver, model.mode,
                           runs), weights
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def calibration_batch(tmp):
    """The detect CLI's first batch of the test folder, letterboxed, as
    the NCHW float batch on the card."""
    from ryolo_tpu_torch.data.datasets import ImageDataset

    ds = ImageDataset(os.path.join(tmp, "test"), img_size=IMG, ext="png")
    x = np.stack([ds[j][1] for j in range(BATCH)])
    return torch.from_numpy(x).cuda().permute(0, 3, 1, 2).float() / 255.0


def detect_runs(tmp, data, weights, spans, ver, mode, runs):
    from ryolo_tpu_torch.detect import STAGES, Detect
    from ryolo_tpu_torch.nn.blocks import Int8Conv
    from ryolo_tpu_torch.nn.deploy import calibrate_static_scales
    from ryolo_tpu_torch.ops import cuda_iou, cuda_nms, int8_conv
    from ryolo_tpu_torch.utils import trace

    results = {}
    name = tag(ver, mode)
    for label, conf, iou, dtype in runs:
        args = Namespace(
            weight_path=weights, mode=mode, ver=ver, conf_thres=conf,
            nms_thres=iou, batch_size=BATCH, img_size=IMG, data=data,
            hyp=os.path.join(REPO, "configs", "hyp.yaml"), ext="png",
            dtype=dtype, packed_input=False, device="cuda")
        det = Detect(args)
        static = label.endswith("static")
        build, built = det._build_model, []

        def build_model(*a, **kw):
            model, dt = build(*a, **kw)
            if static:  # calibrated on the first batch of the run
                model = calibrate_static_scales(model,
                                                [calibration_batch(tmp)])
            built.append(model)
            return model, dt

        det._build_model = build_model
        infer, fetch = det.infer, det.fetch

        def batch_infer(*a, **kw):
            # a batch: its stage marks, and its host time from the call
            # into infer to (dets, valid) on the host
            spans.append({"nms": [], "mask": [], "scan": [], "syncs": [],
                          "stages": a[5] if len(a) > 5 else kw["stages"],
                          "t0": time.perf_counter()})
            return infer(*a, **kw)

        def batch_fetch(*a):
            out = fetch(*a)
            spans[-1]["s"] = time.perf_counter() - spans[-1]["t0"]
            return out

        det.infer, det.fetch = batch_infer, batch_fetch
        spans.clear()
        # the main path's launches only: every count set to 0 just before
        cuda_iou.LAUNCHES["rotated_iou"] = 0
        int8_conv.LAUNCHES["int8_conv2d"] = 0
        for key in cuda_nms.LAUNCHES:
            cuda_nms.LAUNCHES[key] = 0
        fetched = trace.COUNTS["sync.fetch"]
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            out = det.detect()
        finally:
            os.chdir(cwd)
        # the batches the CLI fetched (two copies each), counted by the
        # port apart from this phase's wrappers
        nb = (trace.COUNTS["sync.fetch"] - fetched) // 2
        launches = dict(cuda_nms.LAUNCHES)
        iou_launches = cuda_iou.LAUNCHES["rotated_iou"]
        int8_launches = int8_conv.LAUNCHES["int8_conv2d"]
        torch.cuda.synchronize()
        n_quant = sum(isinstance(m, Int8Conv) for m in built[0].modules())
        n_static = sum(isinstance(m, Int8Conv) and m.ascale is not None
                       for m in built[0].modules())
        # every quantized conv once a batch (and once more in the
        # calibration forward of a static run)
        check((dtype == "int8") == (n_quant > 0) and n_static == n_quant *
              static and int8_launches == n_quant * (nb + static),
              f"{label}: {n_quant} int8 convs ({n_static} static), "
              f"{int8_launches} int8 products over {nb} batches")

        check(len(out) == N_IMAGES, len(out))
        n_det = [len(d) for _, d in out]
        for _, d in out:
            check(d.shape[1:] == (7,) and np.isfinite(d).all(), "rows")
            check(((d[:, 6] >= 0) & (d[:, 6] < NC)).all(), "classes")
            check(((d[:, 5] > conf) & (d[:, 5] <= 1)).all(), "scores")
        check(max(n_det) > 0, "no detections")
        syncs = [len(b["syncs"]) for b in spans]
        per_batch = [(len(b["mask"]), len(b["scan"])) for b in spans]
        check(len(spans) == nb > 0 and all(p == (1, 1) for p in per_batch),
              f"{label}: (nms_mask, nms_scan) launches per batch {per_batch}")
        check(launches == {"nms_mask": nb, "nms_scan": nb}, launches)
        check(iou_launches == 0, f"{iou_launches} pairwise IoU launches")
        check(sum(syncs) == 0, f"{label}: NMS host syncs per batch {syncs}: "
              + "; ".join(m for b in spans for m in b["syncs"]))
        # batch 0 carries cuDNN autotuning: steady numbers from batch 2 on
        steady = [b["s"] for b in spans[1:]]
        ips = BATCH * len(steady) / sum(steady)
        stage = {k: float(np.mean([b["stages"].elapsed_ms()[i]
                                   for b in spans[1:]]))
                 for i, k in enumerate(STAGES)}
        for key in ("nms", "mask", "scan"):
            stage[key] = float(np.mean([
                sum(s.elapsed_time(e) for s, e in b[key]) for b in spans[1:]]))
        log("main", f"{name} {label} (conf {conf}, iou {iou}, {dtype}): {nb} "
            f"batches of {BATCH} at {IMG} px; {ips:.2f} images/s in infer "
            f"(batches 2..{nb}), {N_IMAGES / det.total_s:.2f} images/s wall "
            "with letterbox and drawing; ms per batch " + ", ".join(
                f"{k} {v:.3f}" for k, v in stage.items()))
        log("main", f"{name} {label}: detections per image min {min(n_det)} "
            f"max {max(n_det)}; launches {launches} over {nb} batches (one "
            f"nms_mask and one nms_scan per batch), pairwise rotated_iou "
            f"launches {iou_launches}; NMS host syncs per batch {syncs} "
            f"(sync debug mode warn); int8 convs {n_quant} ({n_static} with "
            f"static scales), int8 products {int8_launches}")
        results[label] = dict(launches=launches, iou_launches=iou_launches,
                              int8_launches=int8_launches, ips=ips,
                              stage=stage)
    return results


def phase_card_vs_cpu(model):
    from ryolo_tpu_torch.eval.postprocess import (MAX_WH, post_process_defer,
                                                  post_process_kfiou_defer)
    from ryolo_tpu_torch.nn import STRIDES, fuse_for_inference
    from ryolo_tpu_torch.nn.heads import decode_csl_defer, decode_kfiou_scores
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
    name = tag(model.ver, model.mode)
    log("card_vs_cpu", f"{name}: fused head maps within rtol 1e-3, atol "
        "1e-4*max|r|+1e-4 of the CPU")

    # the CPU's maps and scores (or CSL rows) into both post-processes
    conf, iou = 0.001, 0.65
    h_gpu = [h.cuda() for h in h_cpu]
    if model.mode == "csl":
        dec = decode_csl_defer(h_cpu, cpu_model.anchors, STRIDES, NC)
        d_cpu, v_cpu = post_process_defer(dec, h_cpu, 3, NC, conf, iou)
        d_gpu, v_gpu = post_process_defer(dec.cuda(), h_gpu, 3, NC, conf,
                                          iou)
        # theta: the same bin; the card divides by 180 as a multiplication
        # by its reciprocal, one ulp off (tests/test_postprocess.py:208-212)
        cols, close, rel = [0, 1, 2, 3, 5, 6], [4], 0.0
    else:
        scores = decode_kfiou_scores(h_cpu, cpu_model.na, NC)
        args = (cpu_model.na, cpu_model.anchors, STRIDES, conf, iou)
        d_cpu, v_cpu = post_process_kfiou_defer(scores, h_cpu, *args)
        d_gpu, v_gpu = post_process_kfiou_defer(
            tuple(s.cuda() for s in scores), h_gpu, *args)
        # boxes: the deferred decode's sigmoid and float32 steps on each
        # device, held within 1e-6 of 1 + |value| (ulps of 800 px)
        cols, close, rel = [5, 6], [0, 1, 2, 3, 4], 1.0
    d_gpu, v_gpu = d_gpu.cpu(), v_gpu.cpu()
    equal = (torch.equal(v_cpu, v_gpu)
             and torch.equal(d_cpu[..., cols], d_gpu[..., cols]))
    box_err = ((d_cpu[..., close] - d_gpu[..., close]).abs()
               / (1.0 + rel * d_cpu[..., close].abs())).max().item()
    n_edge = 0
    if equal:
        check(box_err <= 1e-6, box_err)
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
    log("card_vs_cpu", f"{name}: post-process at conf {conf}, iou {iou}: "
        f"{int(v_cpu.sum())} kept on the CPU, {int(v_gpu.sum())} on the card;"
        f" equal keep sets and detections: {equal} (columns {close} within "
        f"{box_err:.1e}" + (" of 1 + |CPU value|" if rel else "")
        + f"); knife-edge pairs {n_edge}")


H100_INT8_OPS = 1979e12  # int8 tensor cores, dense


def phase_int8_bits(model):
    """One int8 forward of ``model`` (bf16 with the wide convs int8, as
    ``--dtype int8`` deploys it) at 800 px, batch 8: every quantized conv's
    int32 accumulator from ``torch._int_mm`` against its float64 plain
    version, bit for bit; then the product of the conv with the most
    operations timed against its plain version."""
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.nn.blocks import Int8Conv
    from ryolo_tpu_torch.ops import int8_conv

    qmodel = fuse_for_inference(model, dtype=torch.bfloat16, device="cuda",
                                quantize=True)
    n_quant = sum(isinstance(m, Int8Conv) for m in qmodel.modules())
    product = int8_conv.int8_conv2d
    seen, big = [], {"mkn": (0,)}

    def compared(q, kq, stride, pad):
        acc = product(q, kq, stride, pad)
        plain = int8_conv.int8_conv2d_plain(q, kq, stride, pad)
        mkn = (q.shape[0] * acc.shape[2] * acc.shape[3], kq[0].numel(),
               kq.shape[0])
        seen.append(dict(equal=torch.equal(acc, plain),
                         err=(acc.long() - plain.long()).abs().max().item(),
                         amax=acc.abs().max().item()))
        if math.prod(mkn) > math.prod(big["mkn"]):
            big.update(mkn=mkn, args=(q, kq, stride, pad))
        return acc

    x = torch.rand(BATCH, 3, IMG, IMG, generator=torch.Generator()
                   .manual_seed(SEED + 12)).cuda().bfloat16()
    with patched([(int8_conv, "int8_conv2d", compared)]), torch.no_grad():
        qmodel(x)
    torch.cuda.synchronize()
    check(len(seen) == n_quant, f"{len(seen)} products, {n_quant} convs")
    check(all(r["equal"] for r in seen), [r["err"] for r in seen])
    q, kq, stride, pad = big["args"]
    m, k, n = big["mkn"]
    ms = cuda_ms(lambda: product(q, kq, stride, pad), 20)
    plain_ms = cuda_ms(
        lambda: int8_conv.int8_conv2d_plain(q, kq, stride, pad), 3)
    nbytes = q.numel() + kq.numel() + 4 * m * n
    ops = 2.0 * m * k * n
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_INT8_OPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes > t_ops else "operations"
    log("int8", f"yolov7 int8 forward at {IMG} px, batch {BATCH}: {n_quant} "
        f"quantized convs, each int32 accumulator from torch._int_mm equal "
        f"to the float64 plain version bit for bit (largest |sum| "
        f"{max(r['amax'] for r in seen)}); the largest product (M {m}, K "
        f"{k}, N {n}, stride {stride}): im2col + _int_mm {ms:.4f} ms, plain "
        f"(float64 conv) {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}: {nbytes} bytes, {ops:.4g} int8 operations)")
    return dict(max_abs_err=max(r["err"] for r in seen), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                shape=dict(M=m, K=k, N=n), n_quant=n_quant)


# the int8-vs-float32 envelope of tests/test_deploy.py:83-135 (decoded
# confidences 0.05, box coordinates 1.5 px), a coordinate above 300 px held
# to 0.5% of its size as tests/test_torch_int8_graph.py holds it (JAX's own
# int8 graph passes 1.5 px there: its docstring has the seed sweep)
INT8_ENVELOPE = {"conf": 0.05, "box": 1.5}


def dec_gap(a, b):
    """Largest confidence gap and largest box gap over its bound."""
    box = (a[..., :4] - b[..., :4]).abs() / torch.clamp_min(
        0.005 * b[..., :4].abs(), INT8_ENVELOPE["box"])
    return ((a[..., 5:] - b[..., 5:]).abs().max().item(),
            box.max().item())


def phase_int8_card_vs_cpu(model):
    """The int8 graph at 256 px, batch 2, card against CPU, in float32
    compute (as tests/test_deploy.py holds JAX's) with dynamic and with
    static scales, and in bf16 (the CLI's graph, logged)."""
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.nn.deploy import calibrate_static_scales

    x = torch.rand(2, 3, 256, 256,
                   generator=torch.Generator().manual_seed(SEED + 13))
    name = tag(model.ver, model.mode)
    out = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev)
        f32 = fuse_for_inference(model, device=dev)
        dyn = fuse_for_inference(model, device=dev, quantize=True)
        bf = fuse_for_inference(model, dtype=torch.bfloat16, device=dev,
                                quantize=True)
        with torch.no_grad():
            out[dev] = {
                "f32": f32(xd, decode=True)[1].cpu(),
                "dynamic": dyn(xd, decode=True)[1].cpu(),
                "static": calibrate_static_scales(dyn, [xd])(
                    xd, decode=True)[1].cpu(),
                "bf16": bf(xd.bfloat16(), decode=True)[1].cpu()}
    gaps = {}
    for key in ("dynamic", "static"):
        for ref in ("cuda", "cpu"):  # card int8 against CPU int8 / f32
            want = out["cpu"][key if ref == "cuda" else "f32"]
            gaps[f"{key} vs CPU {'int8' if ref == 'cuda' else 'f32'}"] = \
                dec_gap(out["cuda"][key], want)
    check(all(c < INT8_ENVELOPE["conf"] and b <= 1.0
              for c, b in gaps.values()), gaps)
    bf16 = dec_gap(out["cuda"]["bf16"], out["cpu"]["bf16"])
    log("int8_card_vs_cpu", f"{name} at 256 px, batch 2, decoded rows of "
        "the card's int8 graph (float32 compute) within the int8-vs-f32 "
        "envelope (confidence 0.05, box gap over its bound 1.5 px / 0.5% "
        "<= 1): " + "; ".join(f"{k}: confidence {c:.4f}, box {b:.4f}"
                               for k, (c, b) in gaps.items())
        + f"; the CLI's bf16 int8 graph, card against CPU (not bounded): "
        f"confidence {bf16[0]:.4f}, box {bf16[1]:.4f}")


EVAL_IMAGES, CLI_TRAIN, CLI_VAL = 32, 16, 8
EVAL_SPANS = ("wait", "upload", "forward", "decode", "post", "mask", "scan",
              "loss", "fetch", "matcher")


class Spans:
    """Spans of one run: CUDA event pairs (issuing thread) and host-clock
    seconds (any thread) by key, and the host syncs PyTorch reports while
    ``torch.cuda.set_sync_debug_mode("warn")`` is on, by thread."""

    def __init__(self):
        self.events, self.host, self.syncs = {}, {}, []
        self.sites = {}  # the port's innermost line of each sync: count
        self.first = self.last = None

    def cuda(self, key, fn):
        def wrapped(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.events.setdefault(key, []).append((s, e))
            return out
        return wrapped

    def clock(self, key, fn):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.last = time.perf_counter()
                self.host.setdefault(key, []).append((self.last - t) * 1e3)
        return wrapped

    def ms(self, key):
        """Per-call ms of ``key`` (read after a device sync)."""
        if key in self.events:
            return [s.elapsed_time(e) for s, e in self.events[key]]
        return self.host.get(key, [])

    def sync_counted(self, fn):
        def wrapped(*a, **kw):
            main = threading.get_ident()

            def show(message, *_a, **_kw):
                if "called a synchronizing" in str(message):
                    self.syncs.append(threading.get_ident() == main)
                    site = [f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"
                            for f in traceback.extract_stack()
                            if "ryolo_tpu_torch" in f.filename]
                    key = site[-1] if site else "outside the port"
                    self.sites[key] = self.sites.get(key, 0) + 1

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        return wrapped


class TimedLoader:
    """A loader whose every ``next`` is timed as ``wait`` (host clock);
    the first request starts the run's wall clock."""

    def __init__(self, loader, spans):
        self.loader, self.spans = loader, spans

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            if self.spans.first is None:
                self.spans.first = t
            try:
                batch = next(it)
            except StopIteration:
                return
            self.spans.host.setdefault("wait", []).append(
                (time.perf_counter() - t) * 1e3)
            yield batch


def patched(pairs):
    """Set module attributes for a ``with`` block, restoring them after."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = [(m, k, getattr(m, k)) for m, k, _ in pairs]
        for m, k, v in pairs:
            setattr(m, k, v)
        try:
            yield
        finally:
            for m, k, v in saved:
                setattr(m, k, v)
    return ctx()


def eval_spans(spans):
    """The eval path's instrumentation: every stage of a batch, on the
    modules that ``ryolo_tpu_torch.test`` drives (either head's decode,
    post-process and loss)."""
    import ryolo_tpu_torch.eval.evaluator as ev
    import ryolo_tpu_torch.nn.yolo as yolo_mod
    import ryolo_tpu_torch.test as test_mod
    import ryolo_tpu_torch.train.trainer as trainer_mod
    from ryolo_tpu_torch.ops import cuda_nms

    load = ev.load_data

    def load_data(*a, **kw):
        dataset, loader = load(*a, **kw)
        return dataset, TimedLoader(loader, spans)

    return patched([
        (ev, "load_data", load_data),
        (ev, "upload", spans.cuda("upload", ev.upload)),
        (yolo_mod.Yolo, "forward", spans.cuda("forward",
                                              yolo_mod.Yolo.forward)),
        (yolo_mod, "decode_csl_defer", spans.cuda(
            "decode", yolo_mod.decode_csl_defer)),
        (yolo_mod, "decode_kfiou_scores", spans.cuda(
            "decode", yolo_mod.decode_kfiou_scores)),
        (ev, "post_process_defer", spans.cuda("post", ev.post_process_defer)),
        (ev, "post_process_kfiou_defer", spans.cuda(
            "post", ev.post_process_kfiou_defer)),
        (cuda_nms, "nms_mask", spans.cuda("mask", cuda_nms.nms_mask)),
        (cuda_nms, "nms_scan", spans.cuda("scan", cuda_nms.nms_scan)),
        (trainer_mod, "csl_loss", spans.cuda("loss", trainer_mod.csl_loss)),
        (trainer_mod, "kfiou_loss", spans.cuda("loss",
                                               trainer_mod.kfiou_loss)),
        (ev, "_fetch", spans.clock("fetch", ev._fetch)),
        (ev, "get_batch_statistics", spans.clock("matcher",
                                                 ev.get_batch_statistics)),
        (ev, "calculate_eval_stats", spans.clock("ap",
                                                 ev.calculate_eval_stats)),
        (test_mod, "evaluate", spans.sync_counted(test_mod.evaluate)),
    ])


def phase_eval(tmp, names, weights, ver="yolov7", dtypes=("f32", "bf16"),
               mode="csl"):
    """The ``test`` CLI's ``Test(args).run()`` on a 32-image DOTA val split
    at 800 px, batch 8, conf 0.001, iou 0.65, in each of ``dtypes`` (f32
    with TF32 off, bf16); each once to warm up and once timed.  The timed
    run of the first dtype keeps its second batch's NMS input for
    :func:`mask_bound`."""
    import ryolo_tpu_torch.eval.postprocess as pp
    from ryolo_tpu_torch.ops import cuda_nms, int8_conv
    from ryolo_tpu_torch.test import Test

    split = os.path.join(tmp, "dota_val")
    if not os.path.isdir(split):
        write_dota_split(split, names, np.random.default_rng(SEED + 8),
                         EVAL_IMAGES)
    data = os.path.join(tmp, "eval.yaml")
    with open(data, "w") as f:
        json.dump({"type": "DOTA", "val": split, "names": names}, f)
    results, launches = {}, {"nms_mask": 0, "nms_scan": 0}
    int8_total = 0
    n_batches = -(-EVAL_IMAGES // BATCH)
    name = tag(ver, mode)
    nms_inputs = []
    nms = pp.nms_rotated_masked

    def keep_input(boxes, scores, valid, *a, **kw):
        nms_inputs.append((boxes.clone(), valid.clone()))
        return nms(boxes, scores, valid, *a, **kw)

    for dtype in dtypes:
        for run in ("warm-up", "timed"):
            args = Namespace(
                weight_path=weights, mode=mode, ver=ver,
                conf_thres=0.001, iou_thres=0.65, batch_size=BATCH,
                img_size=IMG, data=data,
                hyp=os.path.join(REPO, "configs", "hyp.yaml"),
                max_targets=300, dtype=dtype, device="cuda")
            spans = Spans()
            # this run's launches only: every count set to 0 just before
            for key in cuda_nms.LAUNCHES:
                cuda_nms.LAUNCHES[key] = 0
            int8_conv.LAUNCHES["int8_conv2d"] = 0
            capture = dtype == dtypes[0] and run == "timed"
            with eval_spans(spans), patched(
                    [(pp, "nms_rotated_masked", keep_input)] if capture
                    else []):
                mp, mr, map50, map5095, items = Test(args).run()
            got = dict(cuda_nms.LAUNCHES)
            int8_launches = int8_conv.LAUNCHES["int8_conv2d"]
            torch.cuda.synchronize()
            for key in launches:
                launches[key] += got[key]
            int8_total += int8_launches
            check((dtype == "int8") == (int8_launches > 0)
                  and int8_launches % n_batches == 0,
                  f"eval {name} {dtype}: {int8_launches} int8 products")
            check(got == {"nms_mask": n_batches, "nms_scan": n_batches},
                  f"eval {name} {dtype} {run}: launches {got} over "
                  f"{n_batches} batches")
            per_batch = {k: spans.ms(k) for k in EVAL_SPANS}
            check(all(len(per_batch[k]) == n_batches for k in
                      ("upload", "forward", "post", "mask", "scan", "loss",
                       "matcher")), {k: len(v) for k, v in per_batch.items()})
            metrics = (mp, mr, map50, map5095)
            check(all(0.0 <= v <= 1.0 for v in metrics), metrics)
            check(len(items) == (5 if mode == "csl" else 4)
                  and all(math.isfinite(v) for v in items.values()), items)
            wall = spans.last - spans.first
            ips = EVAL_IMAGES / wall
            main_syncs = sum(spans.syncs) / n_batches
            worker_syncs = (len(spans.syncs) - sum(spans.syncs)) / n_batches
            fwd = [f - d for f, d in zip(per_batch["forward"],
                                         per_batch["decode"])]
            per_batch["forward"] = fwd  # the forward without the decode
            log("eval", f"{name} {dtype} {run}: {EVAL_IMAGES} images, "
                f"{n_batches} batches of {BATCH} at {IMG} px; {ips:.2f} "
                f"images/s from the first batch request to the AP table ({wall:.3f} s); "
                f"launches {got}, int8 products {int8_launches}; host syncs "
                f"per batch {main_syncs:.2f} on "
                f"the issuing thread, {worker_syncs:.2f} in the matcher "
                f"threads; P {mp:.4g} R {mr:.4g} mAP@.5 {map50:.4g} "
                f"mAP@.5:.95 {map5095:.4g}; val loss " + ", ".join(
                    f"{k} {v:.4g}" for k, v in items.items()))
            if run == "timed":
                log("eval", f"{name} {dtype}: host syncs by the port's line "
                    f"that made them, over {n_batches} batches: "
                    f"{spans.sites}")
                for b in range(n_batches):
                    log("eval", f"{name} {dtype} batch {b + 1} ms: "
                        + ", ".join(f"{k} {per_batch[k][b]:.3f}"
                                    for k in EVAL_SPANS
                                    if b < len(per_batch[k])))
                med = {k: float(np.median(v[1:])) for k, v in
                       per_batch.items() if len(v) > 1}
                med["ap"] = spans.ms("ap")[0]
                log("eval", f"{name} {dtype}: median ms of batches "
                    f"2..{n_batches} "
                    "(wait = loader, host clock; upload, forward, decode, "
                    "post (= post-process, of it mask and scan), loss: CUDA "
                    "events; fetch and matcher: host clock in the matcher "
                    "threads; ap: host clock, once): " + ", ".join(
                        f"{k} {v:.3f}" for k, v in med.items()))
                results[dtype] = dict(ips=ips, wall=wall, med=med,
                                      syncs=main_syncs,
                                      worker_syncs=worker_syncs,
                                      metrics=metrics)
                if capture:
                    check(len(nms_inputs) == n_batches, len(nms_inputs))
                    mask_ms = per_batch["mask"][1]
                    bound = mask_bound(*nms_inputs[1])
                    nms_inputs.clear()
                    log("eval", f"{name} {dtype}: nms_mask on batch 2 of the "
                        f"path: valid candidates per image {bound['valid']},"
                        f" {bound['pairs']} valid pairs decided, "
                        f"{bound['near']} not ruled out by the far reject; "
                        f"bound {bound['bound_ms']:.5f} ms "
                        f"({bound['bound_by']}), measured {mask_ms:.4f} ms "
                        f"({100 * bound['bound_ms'] / mask_ms:.2f}% of it)")
                    results["mask_bound"] = dict(bound, ms=mask_ms)
    return dict(launches=launches, int8_launches=int8_total, results=results)


def phase_eval_card_vs_cpu(tmp, names, model, cfg):
    """``evaluate`` on 4 images at 256 px, batch 2, on the card and on the
    CPU with the same weights (conf 0.001, iou 0.65, up to 1000 candidates
    and 300 kept per image): the four metrics and the val loss."""
    import ryolo_tpu_torch.eval.evaluator as ev
    from ryolo_tpu_torch.eval.postprocess import MAX_WH
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.ops.cuda_iou import pairwise_rotated_iou
    from ryolo_tpu_torch.ops.rotated_iou import pairwise_rotated_iou_plain

    # the normalised batch: the card's /255 (by table) equals the host's
    x = torch.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(SEED + 9))
    table = torch.from_numpy(ev._DIV255)
    got = ev._norm_images(x.cuda(), table.cuda()).cpu()
    host = torch.from_numpy(x.numpy().astype(np.float32) / np.float32(255))
    check(torch.equal(got, ev._norm_images(x, table))
          and torch.equal(got, host.permute(0, 3, 1, 2)),
          "uint8 /255 on the card differs from the host's")
    log("eval_card_vs_cpu", f"uint8 batch {tuple(x.shape)} normalised on "
        "the card: bit-equal to the CPU's float32 division by 255")

    split = os.path.join(tmp, "dota_val4")
    write_dota_split(split, names, np.random.default_rng(SEED + 9), 4)
    data = {"type": "DOTA", "val": split, "names": names}
    out = {}
    for dev in ("cuda", "cpu"):
        seen = []
        stats = ev.get_batch_statistics

        def spy(outputs, *a):
            seen.extend(np.asarray(o) for o in outputs)
            return stats(outputs, *a)

        with patched([(ev, "get_batch_statistics", spy)]):
            # max_nms 1000: the CPU's plain NMS mask grows with its square
            res = ev.evaluate(
                fuse_for_inference(model, device=dev),
                train_loss_fn(cfg, model, dev), data, cfg["hyp"], True, 256,
                2,
                0.001, 0.65, max_nms=1000, max_det=300, progress=False,
                device=dev)
        out[dev] = (res, seen)
    (card, d_card), (cpu, d_cpu) = out["cuda"], out["cpu"]
    worst = max(abs(card[4][k] / cpu[4][k] - 1) for k in cpu[4])
    check(worst <= 1e-4, {k: (cpu[4][k], card[4][k]) for k in cpu[4]})
    diff = float(np.abs(np.array(card[:4]) - np.array(cpu[:4])).max())
    # knife edges: NMS pairs whose kernel and plain IoU lie on opposite
    # sides of 0.65 within 1e-3, and rows of one class whose scores are
    # within 1e-5 and trade places (the forwards differ by rounding)
    n_nms_edge = n_swaps = 0
    same_sets = True
    for g, w in zip(d_card, d_cpu):
        if g.shape != w.shape or not np.array_equal(np.sort(g[:, 6]),
                                                    np.sort(w[:, 6])):
            same_sets = False
            rows = torch.from_numpy(np.concatenate([g, w]))
            boxes = torch.stack([rows[:, 0] + rows[:, 6] * MAX_WH,
                                 rows[:, 1] + rows[:, 6] * MAX_WH,
                                 rows[:, 2], rows[:, 3],
                                 rows[:, 4] * (180.0 / np.pi)], -1)
            k = pairwise_rotated_iou(boxes.cuda()[None],
                                     boxes.cuda()[None])[0].cpu()
            p = pairwise_rotated_iou_plain(boxes[None], boxes[None])[0]
            n_nms_edge += int((((k > 0.65) != (p > 0.65))
                               & ((k - 0.65).abs() < 1e-3)
                               & ((p - 0.65).abs() < 1e-3)).sum())
            continue
        order = np.abs(g[:, None, :4] - w[None, :, :4]).max(-1).argmin(1)
        moved = order != np.arange(len(g))
        n_swaps += int(moved.sum())
        check(np.abs(g[moved, 5] - w[moved, 5]).max(initial=0) <= 1e-5,
              "rows trade places with scores apart")
    if diff > 1e-6:
        check(n_nms_edge > 0 or n_swaps > 0,
              f"metrics differ by {diff} without a knife-edge pair")
    log("eval_card_vs_cpu", f"4 images at 256 px, batch 2: card "
        f"{[round(float(v), 8) for v in card[:4]]}, CPU "
        f"{[round(float(v), 8) for v in cpu[:4]]}: max difference {diff:.2e}"
        f" (bound 1e-6 unless a knife-edge pair is named); equal keep sets "
        f"{same_sets}; knife-edge NMS pairs {n_nms_edge}, rows trading places"
        f" with scores within 1e-5 {n_swaps}; detections per image "
        f"{[len(d) for d in d_card]}; val loss items within {worst:.2e} "
        "(rtol 1e-4)")


def cli_data(tmp, names):
    """The train CLI's 16-image train and 8-image val DOTA splits under
    ``<tmp>/cli`` (written once) and their ``data.yaml``."""
    root = os.path.join(tmp, "cli")
    if not os.path.isdir(root):
        write_dota_split(os.path.join(root, "train"), names,
                         np.random.default_rng(SEED + 10), CLI_TRAIN)
        write_dota_split(os.path.join(root, "val"), names,
                         np.random.default_rng(SEED + 11), CLI_VAL)
    data = os.path.join(root, "data.yaml")
    with open(data, "w") as f:
        json.dump({"type": "DOTA", "train": os.path.join(root, "train"),
                   "val": os.path.join(root, "val"), "names": names}, f)
    return root, data


def phase_train_cli(tmp, names, cfg, dtype="f32"):
    """The ``train`` CLI in-process: 1 epoch at 800 px, batch 8, with the
    tap renderer and the tile bank, then ``--resume`` to 2 epochs, with
    ``--dtype`` ``dtype`` (bf16: the per-epoch eval fused in bf16)."""
    import ryolo_tpu_torch.train.__main__ as cli
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.ops import cuda_render
    from ryolo_tpu_torch.train import Trainer
    from ryolo_tpu_torch.utils.checkpoint import load_pth

    root, data = cli_data(tmp, names)
    spans = Spans()
    epochs, per_step, metrics, fused = [], [], [], []
    step = Trainer.train_step_rendered
    fuse = cli.fuse_for_inference

    def spy_fuse(*a, **kw):
        model = fuse(*a, **kw)
        fused.append(next(model.parameters()).dtype)
        return model

    def counted_step(self, *a, **kw):
        check(self.dtype == TORCH_DTYPES[dtype], self.dtype)
        before = cuda_render.LAUNCHES["render"]
        res = step(self, *a, **kw)
        per_step.append(cuda_render.LAUNCHES["render"] - before)
        return res

    train_epoch, evaluate = cli.Train._train_epoch, cli.evaluate

    def spy_epoch(self, trainer, loader, bank, epoch, *a):
        epochs.append(epoch)
        return train_epoch(self, trainer, loader, bank, epoch, *a)

    def spy_eval(*a, **kw):
        res = evaluate(*a, **kw)
        metrics.append(res)
        return res

    launches = 0
    for n_epochs, resume in ((1, False), (2, True)):
        args = Namespace(
            epochs=n_epochs, optimizer="SGD", lr=0.01, batch_size=BATCH,
            img_size=IMG, weights_path="", model_name=f"smoke_{dtype}",
            mode="csl", ver="yolov7", data=data,
            config=os.path.join(REPO, "configs", "hyp.yaml"), max_targets=300,
            yes=True, resume=resume, profile=False, dtype=dtype,
            device_augment=True, cache_images=False, device_cache=True,
            dp=1, sp=1, device="cuda")
        run = (f"--dtype {dtype} --epochs {n_epochs}"
               + (" --resume" if resume else ""))
        spans.host.clear()
        # this run's launches only: the count set to 0 just before
        cuda_render.LAUNCHES["render"] = 0
        cwd = os.getcwd()
        os.chdir(root)
        t0 = time.perf_counter()
        try:
            with patched([
                    (Trainer, "train_step_rendered", counted_step),
                    (cli.Train, "_train_epoch",
                     spans.clock("steps", spy_epoch)),
                    (cli, "evaluate", spans.clock("eval", spy_eval)),
                    (cli, "fuse_for_inference",
                     spans.clock("fuse", spy_fuse)),
                    (cli, "save_pth", spans.clock("save_pth", cli.save_pth)),
                    (cli, "save_train_state",
                     spans.clock("save_state", cli.save_train_state))]):
                cli.Train(args).train()
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t0
        launches += cuda_render.LAUNCHES["render"]
        split = {k: sum(v) for k, v in spans.host.items()}
        log("train_cli", f"{run}: {wall:.3f} s in all; the epoch: steps "
            f"{split['steps']:.1f} ms ({CLI_TRAIN // BATCH} steps, the "
            f"loader included), fuse {split['fuse']:.1f} ms, eval "
            f"{split['eval']:.1f} ms ({CLI_VAL} images at batch "
            f"{2 * BATCH}), saves {split['save_pth']:.1f} ms (.pth) + "
            f"{split['save_state']:.1f} ms (last.state); render launches "
            f"{cuda_render.LAUNCHES['render']}; metrics "
            f"{[round(float(v), 6) for v in metrics[-1][:4]]}, val loss "
            + ", ".join(f"{k} {v:.4g}" for k, v in metrics[-1][4].items()))
    steps = CLI_TRAIN // BATCH
    check(epochs == [0, 1], f"epochs trained {epochs} (the resume must "
          "start at epoch 2)")
    check(fused == [TORCH_DTYPES[dtype]] * 2, f"eval models fused in {fused}")
    check(per_step == [1] * 2 * steps, f"render launches per step "
          f"{per_step}")
    check(all(math.isfinite(v) for m in metrics for v in m[:4])
          and all(math.isfinite(v) for m in metrics for v in m[4].values()),
          metrics)
    out = os.path.join(root, "weights", f"smoke_{dtype}")
    for name in ("best.pth", "last.pth", "last.state", "opt.json"):
        check(os.path.isfile(os.path.join(out, name)), name)
    check(os.listdir(os.path.join(out, "logs")), "no logs")
    fresh = Yolo(NC, cfg["model"], mode="csl", ver="yolov7")
    sd = load_pth(os.path.join(out, "last.pth"))
    check(all(not v.is_floating_point() or v.dtype == torch.float32
              for v in sd.values()), "last.pth float32")
    fresh.load_state_dict(sd, strict=True)
    log("train_cli", f"--dtype {dtype}: eval models fused in {fused}; "
        f"files {sorted(os.listdir(out))}, logs "
        f"{sorted(os.listdir(os.path.join(out, 'logs')))}; last.pth loads "
        "strict=True into a fresh Yolo; epochs trained [1] then [2] "
        "(resumed); one render launch in each of the "
        f"{len(per_step)} steps")
    return dict(render_launches=launches)


# phase 17: data parallelism (train --dp N).  (b)'s steps a rank (the first
# is held against (a)'s first), before its train CLI runs
DP_SHARED_STEPS = 3
# the learning rate of the first step, the one compared, as phase 7's
# (the warm-up's 1e-5 moves a BatchNorm weight near 1 by a few ulps, which
# rounding then decides); the steps after it take the warm-up's
DP_CHECK_LR = 0.01
# a --dp step against another on the same global batch: loss items (rtol),
# BN statistics (of the tensor's largest entry), the update's L2 error in
# the worst tensor and over all parameters.  The items and statistics agree
# to ~1e-6 (H100 80GB HBM3, 700 W); the update only to ~1e-2, and that is
# float32 summation order, not the ranks: scripts/torch_dp_grad_probe.py
# (same card) finds the plain one-process model's gradient on the same 8
# images in the two ranks' order 1.29e-2 from its gradient in the loader's
# order (run twice in one order: 2.9e-6), one rank of a world-1 group 5.0e-3
# from itself in the two orders, and the two gloo ranks 1.43e-2 from that
# world-1 rank in their order; in every pair the first parameter of the
# backward (the last head's implicit prior) already parts by ~5e-5 (the
# loss's sums in another order) and the gap grows past 1e-2 at the same
# depth, through the backward of the random-weight train-mode BatchNorms.
# So the bound stays 0.03 (ROADMAP §C1).  Ranks averaging per-rank means
# instead miss the update by ~0.5 (tests/test_torch_parallel_step.py).
DP_STEP_BOUNDS = {"items": 1e-5, "stats": 1e-4, "tensor": 0.05,
                  "total": 0.03}


def spread(v):
    """``median [min-max]`` of a list of ms."""
    return f"{np.median(v):.1f} [{min(v):.1f}-{max(v):.1f}]"


def dp_loader(split, names, cfg, shard, batch, dev):
    """Phase 6's spec loader (taps, tile bank, the same seed) at ``batch``
    a rank, sharded ``shard=(rank, n)``, and the bank on ``dev``."""
    from ryolo_tpu_torch.data.loader import load_data

    dataset, loader = load_data(
        split, names, "DOTA", cfg["hyp"], True, img_size=IMG,
        batch_size=batch, augment=True, shuffle=True, drop_last=True,
        seed=SEED, workers=4, shard=shard, device_augment=True,
        cache_images=True, device_cache=True)
    return loader, torch.from_numpy(dataset.build_tile_bank()).to(dev)


def seeded_model(cfg, dev, ver="yolov7"):
    """Phase 6's v7-CSL (or phase 11's ``ver``) with the implicit priors
    (which ``weights_init_normal`` leaves) drawn from a fixed seed too, so
    that every process builds the same weights."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return train_model(cfg, dev, ver)


def dp_trainer(cfg, mesh, dev, ver="yolov7", reducer=None):
    """Phase 6's model and optimizer under ``mesh``: synced BatchNorms,
    global loss means (over ``reducer``, default the mesh's groups),
    summed gradients; under ``sp`` the Trainer splits the rows."""
    from ryolo_tpu_torch.parallel import convert_sync_bn, replicate
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer

    model = replicate(convert_sync_bn(seeded_model(cfg, dev, ver)), mesh)
    loss_fn = LOSS_FNS["csl"](model.anchors, NC, cfg["hyp"], dev,
                              reducer=reducer or mesh)
    return Trainer(model, loss_fn, "SGD", 0.01, mesh=mesh)


def warmup_step(step, iters, cfg):
    """Phase 6's warm-up ``(accumulate, lr)`` at global step ``step``; step
    1, the compared one, at ``DP_CHECK_LR``."""
    from ryolo_tpu_torch.train import one_cycle

    if step == 1:
        return 1, DP_CHECK_LR
    nw = max(int(80 * iters * cfg["hyp"]["warmup_prop"]), 1000)
    acc = max(1, int(np.interp(step, [0, nw], [1, NBS / BATCH]).round()))
    lr = float(np.interp(step, [0, nw],
                         [0.0, 0.01 * one_cycle(1, cfg["hyp"]["lrf"], 80)(0)]))
    return acc, lr


def cpu_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def check_step(name, got, items, want, want_items, before):
    """One step's state and loss items against another's, within
    ``DP_STEP_BOUNDS``."""
    bounds = DP_STEP_BOUNDS
    worst = max(abs(items[k] / want_items[k] - 1) for k in want_items)
    gaps = step_gaps(got, want, before)
    log("dp", f"{name}: loss items within {worst:.2e} (rtol "
        f"{bounds['items']:.3g}); BN running statistics within {gaps[0]:.2e}"
        f" of each tensor's largest entry (bound {bounds['stats']:.3g}); "
        f"update error {gaps[1]:.2e} in the worst tensor (bound "
        f"{bounds['tensor']:.3g}), {gaps[2]:.2e} over all parameters (bound "
        f"{bounds['total']:.3g})")
    check(worst <= bounds["items"], (name, items, want_items))
    check(all(g <= bounds[k] for g, k in zip(
        gaps, ("stats", "tensor", "total"))), (name, gaps, bounds))


def collectives_by_kind(prof):
    """Device ms of a profiled step in the ``dp.<name>`` ranges that
    :func:`dp_ranges` opens (each all-reduce by what it reduces; the synced
    BatchNorm's forward and backward, their all-reduces included), and of
    every NCCL kernel."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith("dp."):
            out[e.key[3:]] = getattr(e, "device_time_total",
                                     getattr(e, "cuda_time_total", 0)) / 1e3
    out["nccl_kernels"] = sum(
        e.self_device_time_total for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "nccl" in e.name.lower()) / 1e3
    return out


def dp_ranges():
    """Profiler ranges for a step of the ``--dp`` path: each
    ``torch.distributed.all_reduce`` named by the ``COLLECTIVES`` count
    its caller has just raised (``dp.bn``, ``dp.loss``, ``dp.grad``), and
    the synced BatchNorm's forward and backward (``dp.bn_forward``,
    ``dp.bn_backward``)."""
    import torch.distributed as dist
    from ryolo_tpu_torch.parallel import COLLECTIVES, sync_bn

    seen, orig = dict(COLLECTIVES), dist.all_reduce
    fn = sync_bn._SyncBatchNormFn

    def all_reduce(*a, **kw):
        kind = next((k for k in COLLECTIVES if COLLECTIVES[k] != seen[k]),
                    "other")
        seen.update(COLLECTIVES)
        with torch.profiler.record_function(f"dp.{kind}"):
            return orig(*a, **kw)

    def ranged(name, f):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(f"dp.{name}"):
                return f(*a, **kw)
        return staticmethod(wrapped)

    import contextlib

    @contextlib.contextmanager
    def ctx():
        # the class's own staticmethod objects, put back as they were
        saved = {k: fn.__dict__[k] for k in ("forward", "backward")}
        fn.forward = ranged("bn_forward", fn.forward)
        fn.backward = ranged("bn_backward", fn.backward)
        try:
            with patched([(dist, "all_reduce", all_reduce)]):
                yield
        finally:
            for k, v in saved.items():
                setattr(fn, k, v)
    return ctx()


def phase_dp_world1(split, names, cfg, phase6, device="cuda:0",
                    backend="nccl"):
    """Phase 17(a): the ``--dp`` path in one rank of a world-1 ``backend``
    group on ``device`` (synced BatchNorms, global loss means, the
    gradient all-reduce), phase 6's run (v7-CSL, 800 px, batch 8, taps +
    bank) for ``TRAIN_STEPS`` steps; its first update against the plain
    ``Trainer``'s on the same batch; one profiled step."""
    from ryolo_tpu_torch.ops import cuda_render
    from ryolo_tpu_torch.parallel import COLLECTIVES, close_mesh, make_mesh
    from ryolo_tpu_torch.parallel.mesh import free_port
    from ryolo_tpu_torch.train import Trainer

    dev = torch.device(device)
    torch.cuda.empty_cache()
    loader, bank = dp_loader(split, names, cfg, (0, 1), BATCH, dev)
    iters, it = len(loader), iter(loader)
    batches = [next(it) for _ in range(TRAIN_STEPS + 1)]
    acc, lr = warmup_step(1, iters, cfg)
    plain = {}
    # the plain Trainer's first step with cuDNN's benchmarked algorithms
    # (the train CLI's setting, and the --dp runs') and with its default
    # ones: the envelope of the convolutions' rounding alone
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        model = seeded_model(cfg, dev)
        before = cpu_state(model)
        trainer = Trainer(model, train_loss_fn(cfg, model, dev), "SGD", 0.01)
        _, items = trainer.train_step_rendered(batches[0], bank, lr, acc,
                                               BATCH)
        plain[benchmark] = (cpu_state(model),
                            {k: v.item() for k, v in items.items()})
        del trainer, model
    torch.cuda.empty_cache()
    envelope = step_gaps(plain[False][0], plain[True][0], before)
    item_env = max(abs(v / plain[True][1][k] - 1)
                   for k, v in plain[False][1].items())
    log("dp", "(a) the plain Trainer's first step, cuDNN's default "
        f"algorithms against its benchmarked ones: loss items within "
        f"{item_env:.2e}, BN statistics {envelope[0]:.2e}, update error "
        f"{envelope[1]:.2e} in the worst tensor, {envelope[2]:.2e} over all "
        "parameters")
    plain_sd, plain_items = plain[True]

    mesh = make_mesh(1, device=device, backend=backend,
                     init_method=f"tcp://localhost:{free_port()}", rank=0)
    try:
        trainer = dp_trainer(cfg, mesh, dev)
        walls, steps, first = [], [], None
        collectives = dict(COLLECTIVES)
        # the run's launches only: the count set to 0 just before
        cuda_render.LAUNCHES["render"] = 0
        for step in range(1, TRAIN_STEPS + 1):
            acc, lr = warmup_step(step, iters, cfg)
            before_launch = cuda_render.LAUNCHES["render"]
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    s.record()
                    _, items = trainer.train_step_rendered(
                        batches[step - 1], bank, lr, acc, BATCH)
                    e.record()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            steps.append(s.elapsed_time(e))
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            check(step == 1 or syncs == 0, f"(a) step {step}: {syncs} host "
                  "syncs: " + "; ".join(str(w.message)[:200] for w in caught))
            check(cuda_render.LAUNCHES["render"] - before_launch == 1,
                  f"(a) step {step}: render launches")
            vals = {k: v.item() for k, v in items.items()}
            check(all(math.isfinite(v) for v in vals.values()), vals)
            if step == 1:
                first = (cpu_state(trainer.model), vals)
        launches = cuda_render.LAUNCHES["render"]
        per_step = {k: (COLLECTIVES[k] - collectives[k]) / TRAIN_STEPS
                    for k in COLLECTIVES}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        acc, lr = warmup_step(TRAIN_STEPS + 1, iters, cfg)
        torch.cuda.synchronize()
        with dp_ranges(), torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            trainer.train_step_rendered(batches[-1], bank, lr, acc, BATCH)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        kinds = {k: 0.0 for k, _ in KERNEL_KINDS}
        kinds["other"] = 0.0
        for e in prof.events():  # kernels, not the dp ranges' annotations
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith("dp.")):
                kind = next((k for k, keys in KERNEL_KINDS
                             if any(key in e.name for key in keys)), "other")
                kinds[kind] += e.self_device_time_total / 1e3
        busy = sum(kinds.values())
        coll = collectives_by_kind(prof)
        del trainer
    finally:
        close_mesh()
    check_step("(a) the world-1 --dp step against the plain Trainer's, the "
               "same first batch", first[0], first[1], plain_sd,
               plain_items, before)
    ref = phase6["tile bank, taps"]
    log("dp", f"(a) yolov7, a 1-rank {backend} group on {device}, {IMG} px, "
        f"batch {BATCH}, taps + bank, steps 2..{TRAIN_STEPS}: step "
        f"{spread(steps[1:])} ms, wall {spread(walls[1:])} ms (median [min-max]); phase 6 "
        f"(native BatchNorm, no group): step {spread(ref['steps'])} ms, wall "
        f"{spread(ref['walls'])} ms; render launches {launches} over "
        f"{TRAIN_STEPS} steps; collectives a step {per_step}")
    log("dp", f"(a) one profiled step: wall {prof_wall:.1f} ms, device busy "
        f"{busy:.1f} ms: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                       kinds.items())
        + " ms (phase 15's float32 step for the native BatchNorm); device ms "
        "in the dp ranges: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in coll.items()))
    check(launches == TRAIN_STEPS, launches)
    return dict(render_launches=launches, before=before, first=first,
                plain=(plain_sd, plain_items))


def dp_rank(out, split, cli_root, names, cfg, steps):
    """One rank of phase 17(b)/(c), in a process of its own: ``steps``
    steps of phase 6's run on this rank's share (b = 8 / dp), then the
    train CLI for an epoch and ``--resume`` to a second; what it saw goes
    to ``<out>/rank<r>.pt``."""
    from ryolo_tpu_torch.ops import cuda_render
    from ryolo_tpu_torch.parallel import current_mesh
    from ryolo_tpu_torch.utils.device import set_float32_math

    mesh = current_mesh()
    dev, b = mesh.device, BATCH // mesh.dp
    set_float32_math(dev)  # a new process: TF32 off, as phase 1 sets it
    torch.backends.cudnn.benchmark = True  # as in (a) and the train CLI
    loader, bank = dp_loader(split, names, cfg, (mesh.rank, mesh.dp), b, dev)
    trainer = dp_trainer(cfg, mesh, dev)
    res = {"rank": mesh.rank, "device": str(dev), "walls": [],
           "step_launches": [], "mixups": []}
    it = iter(loader)
    cuda_render.LAUNCHES["render"] = 0
    for step in range(1, steps + 1):
        batch = next(it)
        res["mixups"].append(int((batch["spec_mix_idx"] >= 0).sum()))
        acc, lr = warmup_step(step, len(loader), cfg)
        n0 = cuda_render.LAUNCHES["render"]
        t0 = time.perf_counter()
        _, items = trainer.train_step_rendered(batch, bank, lr, acc, b)
        torch.cuda.synchronize()
        res["walls"].append((time.perf_counter() - t0) * 1e3)
        res["step_launches"].append(cuda_render.LAUNCHES["render"] - n0)
        if step == 1:
            first = batch
            res["first"] = (cpu_state(trainer.model),
                            {k: v.item() for k, v in items.items()})
    res["render_launches"] = cuda_render.LAUNCHES["render"]
    res["extra_slots"] = loader.extra_slots
    # the control: each rank's loss a mean over its own rows, the gradients
    # averaged (what a DistributedDataParallel wrapper around the
    # single-process loss computes), the BatchNorms still synced
    del trainer
    torch.cuda.empty_cache()
    trainer = dp_trainer(cfg, mesh, dev)
    per_rank = train_loss_fn(cfg, trainer.model, dev)
    trainer.loss_fn = lambda out, batch: (
        per_rank(out, batch)[0] / mesh.dp, {})
    trainer.train_step_rendered(first, bank, DP_CHECK_LR, 1, b)
    res["averaged"] = cpu_state(trainer.model)
    del trainer, bank, it
    torch.cuda.empty_cache()

    res.update(cli_in_rank(mesh, cli_root, cfg))
    torch.save(res, os.path.join(out, f"rank{mesh.rank}.pt"))


def cli_in_rank(mesh, cli_root, cfg):
    """The train CLI in this rank of ``mesh`` (``--dp``, ``--sp`` its own):
    an epoch, then ``--resume`` to a second, in ``cli_root``; the render
    launches of each step, the epochs run, each eval's ``nms_mask`` and
    ``nms_scan`` launches, metrics and time, the checkpoint writes."""
    import ryolo_tpu_torch.train.__main__ as cli
    from ryolo_tpu_torch.ops import cuda_nms, cuda_render
    from ryolo_tpu_torch.train import Trainer

    writes, epochs, per_step, evals = [], [], [], []
    step_fn, train_epoch, evaluate = (Trainer.train_step_rendered,
                                      cli.Train._train_epoch, cli.evaluate)

    def counted_step(self, *a, **kw):
        n0 = cuda_render.LAUNCHES["render"]
        out = step_fn(self, *a, **kw)
        per_step.append(cuda_render.LAUNCHES["render"] - n0)
        return out

    def spy_epoch(self, trainer, loader, bank, epoch, *a):
        epochs.append(epoch)
        return train_epoch(self, trainer, loader, bank, epoch, *a)

    def spy_eval(*a, **kw):
        n0 = dict(cuda_nms.LAUNCHES)
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        evals.append({"metrics": [float(v) for v in out[:4]],
                      "loss": out[4], "ms": (time.perf_counter() - t0) * 1e3,
                      **{k: cuda_nms.LAUNCHES[k] - n0[k] for k in n0}})
        return out

    def counted(name):
        fn = getattr(cli, name)

        def wrapped(*a, **kw):
            writes.append(name)
            return fn(*a, **kw)
        return wrapped

    cwd = os.getcwd()
    os.chdir(cli_root)
    cli_walls = []
    try:
        with patched([(Trainer, "train_step_rendered", counted_step),
                      (cli.Train, "_train_epoch", spy_epoch),
                      (cli, "evaluate", spy_eval),
                      (cli, "save_pth", counted("save_pth")),
                      (cli, "save_train_state",
                       counted("save_train_state"))]):
            for n_epochs, resume in ((1, False), (2, True)):
                args = Namespace(
                    epochs=n_epochs, optimizer="SGD", lr=0.01,
                    batch_size=BATCH, img_size=IMG, weights_path="",
                    model_name=f"smoke_dp{mesh.dp}_sp{mesh.sp}", mode="csl",
                    ver="yolov7", data=os.path.join(cli_root, "data.yaml"),
                    config=os.path.join(REPO, "configs", "hyp.yaml"),
                    max_targets=300, yes=True, resume=resume, profile=False,
                    dtype="f32", device_augment=True, cache_images=False,
                    device_cache=True, dp=mesh.dp, sp=mesh.sp, device="cuda")
                t0 = time.perf_counter()
                cli.Train(args).train()
                cli_walls.append(time.perf_counter() - t0)
    finally:
        os.chdir(cwd)
    return dict(writes=writes, epochs=epochs, cli_step_launches=per_step,
                evals=evals, cli_walls=cli_walls)


def check_cli_ranks(ranks, what, cli_root, cfg, dp, sp):
    """Phase 17/18's train CLI in each rank: one render launch a step, the
    epochs [0, 1], one ``nms_mask`` and one ``nms_scan`` a rank an eval,
    the same metrics on every rank, checkpoints from rank 0 alone that
    load strict into a fresh model."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.utils.checkpoint import load_pth

    for r in ranks:
        check(r["epochs"] == [0, 1], f"{what}: epochs {r['epochs']}")
        check(r["cli_step_launches"] == [1] * (2 * CLI_TRAIN // BATCH),
              f"{what}: CLI render launches {r['cli_step_launches']}")
        check([(e["nms_mask"], e["nms_scan"]) for e in r["evals"]]
              == [(1, 1)] * 2, f"{what}: eval launches {r['evals']}")
        check(all(math.isfinite(v) for e in r["evals"] for v in e["metrics"]),
              r["evals"])
        check([e["metrics"] for e in r["evals"]]
              == [e["metrics"] for e in ranks[0]["evals"]],
              f"{what}: ranks' metrics differ")
        if r is not ranks[0]:
            check(r["writes"] == [], f"{what}: rank writes {r['writes']}")
    a = ranks[0]
    check(a["writes"] == ["save_pth", "save_pth", "save_train_state",
                          "save_pth", "save_train_state"]
          or a["writes"] == ["save_pth", "save_pth", "save_train_state",
                             "save_pth", "save_pth", "save_train_state"],
          f"{what}: rank 0 writes {a['writes']}")
    sd = load_pth(os.path.join(cli_root, "weights", f"smoke_dp{dp}_sp{sp}",
                               "last.pth"))
    check(not any(k.startswith("module.") for k in sd), "module. keys")
    Yolo(NC, cfg["model"], mode="csl", ver="yolov7").load_state_dict(
        sd, strict=True)


def phase_dp_ranks(tmp, split, names, cfg, world1, label, device, backend):
    """Phase 17(b) or (c): 2 ranks by ``ryolo_tpu_torch.parallel.launch``
    (``device``, ``backend``) through :func:`dp_rank`; the first step held
    against (a)'s on the same global batch, one render launch a rank a
    step, the train CLI's sharded eval (one ``nms_mask`` and one
    ``nms_scan`` a rank a batch), checkpoints from rank 0 alone."""
    from ryolo_tpu_torch.parallel import launch

    out = os.path.join(tmp, f"dp_{label}")
    os.makedirs(out)
    cli_root = os.path.join(tmp, "cli")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch(f"{__name__}:dp_rank", 2,
           (out, split, cli_root, names, cfg, DP_SHARED_STEPS), device=device,
           backend=backend)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    what = f"({label}) 2 ranks, {backend}, " + " and ".join(
        r["device"] for r in ranks)
    for r in ranks:
        log("dp", f"{what}: rank {r['rank']}: step walls "
            f"{[round(w, 1) for w in r['walls']]} ms (the first includes "
            f"the warm-up), mixup draws {r['mixups']} in "
            f"{r['extra_slots']} partner slots; train CLI {r['epochs']} "
            f"epochs in {[round(w, 1) for w in r['cli_walls']]} s, evals "
            + "; ".join(f"{e['ms']:.0f} ms, nms_mask {e['nms_mask']}, "
                        f"nms_scan {e['nms_scan']}, metrics "
                        f"{[round(v, 6) for v in e['metrics']]}"
                        for e in r["evals"])
            + f"; checkpoint writes {r['writes']}")
    a, b = ranks
    for k, v in a["first"][0].items():
        check(torch.equal(v, b["first"][0][k]), f"{what}: ranks differ {k}")
    check(a["first"][1] == b["first"][1], "ranks' loss items differ")
    if max(a["mixups"][0], b["mixups"][0]) > a["extra_slots"]:
        log("dp", f"{what}: a mixup draw beyond the partner slots took the "
            "host-rendered fallback in the first batch")
    check_step(f"({label}) the first step against (a)'s world-1 step, the "
               "same global batch", a["first"][0], a["first"][1],
               world1["first"][0], world1["first"][1], world1["before"])
    averaged = step_gaps(a["averaged"], world1["first"][0], world1["before"])
    log("dp", f"({label}) the control, per-rank loss means averaged: BN "
        f"statistics {averaged[0]:.2e}, update error {averaged[1]:.2e} in the "
        f"worst tensor, {averaged[2]:.2e} over all parameters (bound "
        f"{DP_STEP_BOUNDS['total']:.3g}, which it must exceed)")
    check(averaged[2] > DP_STEP_BOUNDS["total"],
          f"({label}) averaged per-rank means pass the update bound: "
          f"{averaged}")
    for r in ranks:
        check(r["step_launches"] == [1] * DP_SHARED_STEPS,
              f"rank {r['rank']} render launches {r['step_launches']}")
    check_cli_ranks(ranks, what, cli_root, cfg, 2, 1)
    log("dp", f"{what}: {wall:.1f} s in all (two processes' start, build "
        "and bank included); the step walls are two processes sharing "
        "one card, not a speed of data parallelism" if backend == "gloo"
        else f"{what}: {wall:.1f} s in all")
    return dict(render_launches=sum(r["render_launches"] for r in ranks),
                cli_render_launches=sum(sum(r["cli_step_launches"])
                                        for r in ranks),
                nms={k: sum(e[k] for r in ranks for e in r["evals"])
                     for k in ("nms_mask", "nms_scan")},
                walls=[w for r in ranks for w in r["walls"][1:]])


# phase 18: spatial sharding (train --dp N --sp S).  The steps a rank of
# (a), the first held against the plain Trainer's on the same global batch
SP_STEPS = 3
SP_VERS = ("yolov7", "yolov5")
# the gathered head maps of (a)'s forward (training mode, before any
# update): the largest difference over the map's largest entry, against
# one process's forward on the card at the same weights, with the same
# synced BatchNorm (a world-1 group: the split alone differs) and with
# cuDNN's (the plain model).  The CPU test (tests/test_torch_spatial_step.py)
# measures the split at ~1e-6 of the maps in eval mode; in training mode at
# random weights the BatchNorms amplify any rounding, and probes on an H100
# 80GB HBM3 at 700 W read 1.2e-4 to 2.9e-4 (cuDNN's default and
# benchmarked algorithms gave bit-equal maps).  So the bound is
# SP_FWD_FACTOR times the card's own envelope of the plain forward, measured
# each run: the same forward in channels-last layout (other cuDNN kernels,
# the same sums) and on the batch in reverse order (BatchNorm's sums in
# another order), the larger of the two distances
SP_FWD_FACTOR = 5.0


def max_rel(got, want):
    """The largest difference of the maps ``got`` and ``want`` over the
    largest entry of ``want``, the worst map's."""
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max()).item() for g, w in zip(got, want))


def quiet_collectives(calls):
    """``torch.distributed``'s all-reduce and all-gather with the CUDA sync
    debug mode off while they run (gloo stages CUDA tensors through the
    host, so it synchronizes inside each call by design), each call
    appended to ``calls``: a step's other host syncs still show."""
    import torch.distributed as dist

    def wrap(name):
        fn = getattr(dist, name)

        def call(*a, **kw):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                calls.append(name)
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call
    return patched([(dist, n, wrap(n)) for n in ("all_reduce", "all_gather")])


def halo_windows(model):
    """The windows of ``model`` that cross the row split: every conv wider
    than 1x1 and the three same-size pools of its SPP block."""
    return 3 + sum(m.kernel_size[0] > 1 for m in model.modules()
                   if isinstance(m, torch.nn.Conv2d))


def plain_forward_and_step(cfg, ver, spec, bank, dev):
    """On the card, one process: the training-mode head maps of phase 6's
    first batch with cuDNN's BatchNorm (and their envelope: the batch in
    reverse order, channels-last) and with the synced one in a world-1
    gloo group, then the plain Trainer's first step on it, as phase 17(a)
    computes it."""
    from ryolo_tpu_torch.data.device_augment import render_batch
    from ryolo_tpu_torch.parallel import close_mesh, convert_sync_bn, make_mesh
    from ryolo_tpu_torch.parallel.mesh import free_port
    from ryolo_tpu_torch.train import Trainer

    images = render_batch(spec, BATCH, bank=bank, device=dev)
    heads = {}
    with torch.no_grad():
        model = seeded_model(cfg, dev, ver).train()
        heads["plain"] = [h.cpu() for h in model(images)]
        envelope = [[h.flip(0).cpu() for h in model(images.flip(0))]]
        model.to(memory_format=torch.channels_last)
        envelope.append([h.cpu() for h in model(
            images.contiguous(memory_format=torch.channels_last))])
        del model
        make_mesh(1, device=str(dev), backend="gloo", rank=0,
                  init_method=f"tcp://localhost:{free_port()}")
        try:
            heads["synced"] = [h.cpu() for h in convert_sync_bn(
                seeded_model(cfg, dev, ver)).train()(images)]
        finally:
            close_mesh()
    model = seeded_model(cfg, dev, ver)
    before = cpu_state(model)
    trainer = Trainer(model, train_loss_fn(cfg, model, dev), "SGD", 0.01)
    _, items = trainer.train_step_rendered(spec, bank, DP_CHECK_LR, 1, BATCH)
    res = dict(heads=heads, before=before,
               envelope=[max_rel(e, heads["plain"]) for e in envelope],
               plain=(cpu_state(model),
                      {k: v.item() for k, v in items.items()}))
    del trainer, model
    torch.cuda.empty_cache()
    return res


def sp_rank(out, split, cli_root, names, cfg, steps):
    """One rank of phase 18(a)/(c), in a process of its own, for each of
    ``SP_VERS``: the forward of its rows of the group's first batch, the
    head maps gathered (and again with every borrowed halo row zeroed, the
    control that must fail); ``steps`` steps from the seeded weights (one
    render a rank a step, the halo exchanges, host syncs outside the
    collectives, peak memory); one step with the loss counts summed over
    all ranks (the control that must fail); then the train CLI for an
    epoch and ``--resume`` (v7).  Writes ``<out>/rank<r>.pt``."""
    import dataclasses

    from ryolo_tpu_torch.data.device_augment import render_batch
    from ryolo_tpu_torch.ops import cuda_render
    from ryolo_tpu_torch.parallel import COLLECTIVES, current_mesh, spatial
    from ryolo_tpu_torch.utils.device import set_float32_math

    mesh = current_mesh()
    dev, b = mesh.device, BATCH // mesh.groups
    set_float32_math(dev)
    torch.backends.cudnn.benchmark = True
    loader, bank = dp_loader(split, names, cfg, (mesh.group, mesh.groups), b,
                             dev)
    it = iter(loader)
    batches = [next(it) for _ in range(steps)]
    del it
    res = {"rank": mesh.rank, "device": str(dev), "vers": {},
           "paths": list(batches[0]["paths"])}
    cuda_render.LAUNCHES["render"] = 0
    for ver in SP_VERS:
        r = res["vers"][ver] = {"walls": [], "step_launches": [],
                                "syncs": [], "collectives": []}
        trainer = dp_trainer(cfg, mesh, dev, ver)
        r["halo_windows"] = halo_windows(trainer.model)
        images = render_batch(batches[0], b, bank=bank, device=dev)
        with torch.no_grad():
            heads = [h.cpu() for h in spatial.spatial_forward(
                trainer.model.train(), images, mesh)]
            plan = spatial._halo_plan

            def zeroed(*a):  # every borrowed row a fill row
                up, down, rows = plan(*a)
                return ([(None, 0, p1 - p0) for _, p0, p1 in up],
                        [(None, 0, p1 - p0) for _, p0, p1 in down], rows)
            with patched([(spatial, "_halo_plan", zeroed)]):
                zero = [h.cpu() for h in spatial.spatial_forward(
                    trainer.model, images, mesh)]
        r["fingerprint"] = [float(h.double().sum()) for h in heads]
        r["control_rel"] = max_rel(zero, heads)
        if mesh.rank == 0:
            r["heads"] = heads
        del trainer, images, zero, heads
        torch.cuda.empty_cache()

        trainer = dp_trainer(cfg, mesh, dev, ver)
        r["before"] = cpu_state(trainer.model) if mesh.rank == 0 else None
        torch.cuda.reset_peak_memory_stats(dev)
        for step in range(1, steps + 1):
            acc, lr = warmup_step(step, len(loader), cfg)
            n0, c0 = cuda_render.LAUNCHES["render"], dict(COLLECTIVES)
            calls = []
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with quiet_collectives(calls):
                        _, items = trainer.train_step_rendered(
                            batches[step - 1], bank, lr, acc, b)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize(dev)
            r["walls"].append((time.perf_counter() - t0) * 1e3)
            r["step_launches"].append(cuda_render.LAUNCHES["render"] - n0)
            r["syncs"].append([str(w.message)[:160] for w in caught
                               if "synchroniz" in str(w.message)])
            r["collectives"].append(dict(
                {k: COLLECTIVES[k] - c0[k] for k in COLLECTIVES},
                calls=len(calls)))
            vals = {k: v.item() for k, v in items.items()}
            check(all(math.isfinite(v) for v in vals.values()), vals)
            if step == 1:
                r["first"] = (cpu_state(trainer.model) if mesh.rank == 0
                              else None, vals)
                r["first_fingerprint"] = sum(
                    float(p.double().sum())
                    for p in trainer.model.parameters())
                r["first_mem"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                torch.cuda.reset_peak_memory_stats(dev)
        r["mem"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        del trainer
        torch.cuda.empty_cache()
        # the control: the loss counts and items summed over every rank,
        # each target counted sp times
        trainer = dp_trainer(cfg, mesh, dev, ver,
                             reducer=dataclasses.replace(mesh, dp_group=None))
        trainer.train_step_rendered(batches[0], bank, DP_CHECK_LR, 1, b)
        r["all_ranks"] = cpu_state(trainer.model) if mesh.rank == 0 else None
        del trainer
        torch.cuda.empty_cache()
    res["render_launches"] = cuda_render.LAUNCHES["render"]
    del bank
    torch.cuda.empty_cache()
    res.update(cli_in_rank(mesh, cli_root, cfg))
    torch.save(res, os.path.join(out, f"rank{mesh.rank}.pt"))


def phase_sp(tmp, split, names, cfg, plain_mem, label="a", dp=2,
             device="cuda:0", backend="gloo"):
    """Phase 18(a) or (c): ``dp`` ranks, ``sp = 2``, by
    ``ryolo_tpu_torch.parallel.launch`` through :func:`sp_rank`; for v7-CSL
    and v5-CSL the gathered forward against the plain one-process forward
    and the first update against the plain Trainer's (both computed here
    first, on the same global batch), the controls, the counts, each rank's
    peak memory against ``plain_mem`` (phase 6 and 11's, GiB); then the
    train CLI with ``--dp dp --sp 2``."""
    from ryolo_tpu_torch.parallel import launch
    from ryolo_tpu_torch.parallel.spatial import row_split

    sp = 2
    dev = torch.device("cuda:0")
    loader, bank = dp_loader(split, names, cfg, (0, 1), BATCH, dev)
    first = next(iter(loader))
    first["paths"] = list(first["paths"])
    torch.backends.cudnn.benchmark = True
    plain = {ver: plain_forward_and_step(cfg, ver, first, bank, dev)
             for ver in SP_VERS}
    del loader, bank
    torch.cuda.empty_cache()
    out = os.path.join(tmp, f"sp_{label}")
    os.makedirs(out)
    cli_root = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    launch(f"{__name__}:sp_rank", dp,
           (out, split, cli_root, names, cfg, SP_STEPS), device=device,
           backend=backend, sp=sp)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(dp)]
    what = f"({label}) {dp} ranks, sp {sp}, {backend}, " + " and ".join(
        r["device"] for r in ranks)
    rows = row_split(IMG, sp)
    failed = []  # every reading is logged before the first failure stops

    def expect(ok, what):
        if not ok:
            failed.append(what)

    for ver in SP_VERS:
        p = plain[ver]
        a = ranks[0]["vers"][ver]
        # rank 0 holds group 0's images: their rows of the whole batch
        idx = [first["paths"].index(q) for q in ranks[0]["paths"]]
        fwd = {k: max_rel(a["heads"], [m[idx] for m in h])
               for k, h in p["heads"].items()}
        bound = SP_FWD_FACTOR * max(p["envelope"])
        log("sp", f"{what}, {ver}: rows {rows} of {IMG}; gathered head maps "
            f"within {fwd['synced']:.2e} of the largest entry of one "
            f"process's forward with the synced BatchNorm, {fwd['plain']:.2e} "
            "of the plain model's; the plain forward's own envelope: "
            f"{p['envelope'][0]:.2e} on the batch reversed, "
            f"{p['envelope'][1]:.2e} channels-last (bound {SP_FWD_FACTOR:g} x "
            f"the larger: {bound:.2e}); the halo rows zeroed: "
            f"{a['control_rel']:.2e} (must exceed the bound)")
        for k, v in fwd.items():
            expect(v <= bound, f"{ver} forward ({k}) {v} > {bound}")
        expect(a["control_rel"] > bound,
               f"{ver} zeroed halos pass: {a['control_rel']}")
        for r in ranks:
            v = r["vers"][ver]
            expect(v["fingerprint"] == ranks[r["rank"] // sp * sp][
                "vers"][ver]["fingerprint"],
                f"{ver}: the gathered maps differ within a group")
            expect(v["first_fingerprint"] == a["first_fingerprint"]
                   and v["first"][1] == a["first"][1],
                   f"{ver}: ranks' first steps differ")
            expect(v["step_launches"] == [1] * SP_STEPS,
                   f"{ver} rank {r['rank']} render launches "
                   f"{v['step_launches']}")
            expect(all(not s for s in v["syncs"][1:]),
                   f"{ver} rank {r['rank']} host syncs {v['syncs']}")
            want_halo = 2 * v["halo_windows"] - 1
            expect(all(c["halo"] == want_halo and c["rows"] == 3
                       for c in v["collectives"]),
                   f"{ver}: collectives {v['collectives']}, halo {want_halo}")
            log("sp", f"{what}, {ver}, rank {r['rank']}: step walls "
                f"{[round(w, 1) for w in v['walls']]} ms (two processes "
                "sharing one card, not a speed; the first includes the "
                f"warm-up); peak memory {v['first_mem']:.2f} GiB in step 1, "
                f"{v['mem']:.2f} GiB in steps 2..{SP_STEPS} against "
                f"{plain_mem.get(ver, float('nan')):.2f} GiB of the "
                "one-process run (phase 6/11); per step "
                f"{v['collectives'][-1]} (halo: {v['halo_windows']} windows "
                "forward, all but the stem's backward), host syncs outside "
                f"the collectives {[len(s) for s in v['syncs']]}")
        gaps = step_gaps(a["first"][0], p["plain"][0], p["before"])
        worst = max(abs(a["first"][1][k] / w - 1)
                    for k, w in p["plain"][1].items())
        ctl = step_gaps(a["all_ranks"], p["plain"][0], p["before"])
        log("sp", f"({label}) {ver}: the first step against the plain "
            f"Trainer's on the same global batch: loss items within "
            f"{worst:.2e}, BN statistics {gaps[0]:.2e}, update error "
            f"{gaps[1]:.2e} in the worst tensor, {gaps[2]:.2e} over all "
            f"parameters (bounds {DP_STEP_BOUNDS}); the control, loss counts "
            f"summed over all ranks: BN statistics {ctl[0]:.2e}, update "
            f"{ctl[2]:.2e} (must exceed {DP_STEP_BOUNDS['total']:.3g})")
        expect(worst <= DP_STEP_BOUNDS["items"], f"{ver} items {worst}")
        expect(all(g <= DP_STEP_BOUNDS[k] for g, k in zip(
            gaps, ("stats", "tensor", "total"))), f"{ver} step {gaps}")
        expect(ctl[2] > DP_STEP_BOUNDS["total"], f"{ver}: all-rank counts "
               f"pass the update bound: {ctl}")
    for r in ranks:
        # the CLI part is (b) of the one-card run
        log("sp", f"({'b' if label == 'a' else label}) {what[4:]}: rank "
            f"{r['rank']}: train CLI "
            f"--dp {dp} --sp {sp}, {r['epochs']} epochs "
            f"in {[round(w, 1) for w in r['cli_walls']]} s, evals "
            + "; ".join(f"{e['ms']:.0f} ms, nms_mask {e['nms_mask']}, "
                        f"nms_scan {e['nms_scan']}, metrics "
                        f"{[round(v, 6) for v in e['metrics']]}"
                        for e in r["evals"])
            + f"; checkpoint writes {r['writes']}")
    log("sp", f"{what}: {wall:.1f} s in all (the processes' start, build and "
        "bank included)")
    check(not failed, failed)
    check_cli_ranks(ranks, what, cli_root, cfg, dp, sp)
    return dict(render_launches=sum(r["render_launches"] for r in ranks),
                cli_render_launches=sum(sum(r["cli_step_launches"])
                                        for r in ranks),
                nms={k: sum(e[k] for r in ranks for e in r["evals"])
                     for k in ("nms_mask", "nms_scan")})


def sp_phases(tmp, split, names, cfg, plain_mem):
    """Phase 18: (a) on ``cuda:0`` over gloo, (c) over NCCL on four cards
    where there are four; ``{label: phase_sp's counts}``."""
    runs = {"a": phase_sp(tmp, split, names, cfg, plain_mem)}
    if torch.cuda.device_count() >= 4:
        runs["c"] = phase_sp(tmp, split, names, cfg, plain_mem, "c", 4,
                             "cuda", "nccl")
    else:
        log("sp", f"(c) not run: {torch.cuda.device_count()} card; it runs "
            "--dp 4 --sp 2 over NCCL, one card a rank")
    return runs


# phase 19: trained weights, the recipe of tests/test_torch_e2e.py
# (tests/test_trained_parity.py:124-186): YOLOv5 with nc = 2 from
# weights_init_normal on the synthetic set, Adam at 2e-3 with a 50-step
# warm-up (KFIoU: x 0.1 after step 400), the custom loader at 96 px, batch 4,
# no augmentation; the last 10 losses below half the first 10
TRAINED_SET = dict(n_images=8, img_size=96, seed=11, w_range=(0.18, 0.28),
                   ratio=(1.2, 1.6))
TRAINED_BATCH = 4
TRAINED_STEPS = {"csl": 520, "kfiou": 900}
# two evaluations of one checkpoint within 5e-3 on both mAPs
# (tests/test_trained_parity.py:257-258).  The floors on mAP@.5: JAX's
# (:260) are 0.5 (CSL) and 0.02 (KFIoU) on the val split's 9 targets,
# where one detection's rank moves mAP@.5 by ~0.1.  CSL endpoints of this
# recipe that differ only in float32 summation order score 0.276 to 0.755
# there on the card (17 trainings: this phase,
# scripts/torch_trained_spread.py and scripts/torch_trained_phase.py) and
# 0.388 to 0.808 on the CPU (5: 1-4 threads, oneDNN on and off,
# scripts/torch_trained_spread_cpu.py), six and one of them below 0.5.  So the CSL val floor is 0.14, half the
# lowest of both (a model that learned nothing scores ~0.001); KFIoU keeps
# JAX's; and JAX's CSL floor holds on the 8 training images' 24 targets,
# which those endpoints score 0.777 to 0.995 (card) and 0.797 to 0.970
TRAINED_FLOORS = {"csl": {"val": 0.14, "train": 0.5, "jax_val": 0.5},
                  "kfiou": {"val": 0.02, "train": 0.02, "jax_val": 0.02}}
MAP_BOUND = 5e-3
# 19(c): the eval load of a trained model at the users' size, 800 px scenes
# with DOTA-like density (100-200 objects) at the trained objects' pixel
# size (0.18-0.28 x 96 px = 0.0216-0.0336 x 800 px)
TRAINED_LOAD = dict(n_images=16, img_size=800, w_range=(0.0216, 0.0336),
                    ratio=(1.2, 1.6), min_obj=100, max_obj=201)
# the trained int8 graph's decoded rows, card against CPU (int8_gaps),
# each distance over the CPU's own int8-to-float32 one.  On trained
# weights the int8 graph turns on its input's last bit: the CPU's own
# rows, its images nudged up by one ulp, part from its rows by 0.32
# (confidences) and 0.55 (boxes) (scripts/torch_trained_spread_cpu.py),
# and the card's part from the CPU's by 0.19-0.67 and 0.12-0.78 (nine
# readings of six endpoints: scripts/torch_trained_phase.py and this
# phase; on 800 px scenes the card read 0.458 / 0.387 where the CPU
# nudged read 0.458 / 0.380), while every int8 product is exact.  Two int8
# graphs that quantize independently read about sqrt(2), so ``apart`` is
# 1.4; the card's float32 graph in the int8 graph's place reads ~0 from
# the CPU's float32 rows, so the int8 rows must lie at least half the
# distance from them (``quantized``)
INT8_TRAINED_BOUND = {"apart": 1.4, "quantized": 0.5}


def trained_model_train(root, cfg, mode):
    """Phase 19(a): the recipe on ``cuda:0`` (float32, TF32 off), the loss
    read once at the end; CUDA events around each ``train_step``, the host
    clock around each wait for the loader.  Returns the model in eval
    mode."""
    from ryolo_tpu_torch.data.loader import load_data
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.ops.render import to_device
    from ryolo_tpu_torch.train import LOSS_FNS, Trainer, weights_init_normal

    dev, hyp = torch.device("cuda"), cfg["hyp"]
    model = Yolo(len(SYNTH_NAMES), cfg["model"], mode=mode, ver="yolov5")
    weights_init_normal(model, torch.Generator().manual_seed(1))
    model.to(dev)
    trainer = Trainer(model, LOSS_FNS[mode](model.anchors, len(SYNTH_NAMES),
                                            hyp, dev), "Adam", 2e-3)
    _, loader = load_data(os.path.join(root, "train"), SYNTH_NAMES, "custom",
                          hyp, csl=mode == "csl", img_size=TRAINED_SET[
                              "img_size"], batch_size=TRAINED_BATCH,
                          augment=False, shuffle=True, max_targets=16)
    steps = TRAINED_STEPS[mode]
    losses, events, waits = [], [], []
    t_run = time.perf_counter()
    while len(losses) < steps:
        it = iter(loader)
        while len(losses) < steps:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            waits.append((time.perf_counter() - t) * 1e3)
            step = len(losses)
            base = 2e-3 if (mode == "csl" or step < 400) else 2e-4
            lr = base * min(1.0, (step + 1) / 50)
            arrays = {k: to_device(v, dev) for k, v in batch.items()
                      if k != "paths"}
            arrays["images"] = arrays["images"].permute(0, 3, 1, 2)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            loss, _ = trainer.train_step(arrays, lr, 1)
            e.record()
            losses.append(loss)
            events.append((s, e))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    losses = torch.stack(losses).cpu().numpy()
    ms = [s.elapsed_time(e) for s, e in events]
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(np.isfinite(losses).all(), f"trained {mode}: non-finite loss")
    check(last < 0.5 * first, f"trained {mode}: loss first 10 {first}, "
          f"last 10 {last}: not below half")
    log("trained", f"yolov5-{mode} trained on the card: {steps} steps at "
        f"{TRAINED_SET['img_size']} px, batch {TRAINED_BATCH}, Adam 2e-3; "
        f"loss first 10 {first:.5f}, last 10 {last:.5f} (criterion: below "
        f"half); steps 2..{steps}: step {spread(ms[1:])} ms (CUDA events "
        f"around train_step), host wait for the loader "
        f"{np.median(waits[1:]):.3f} [{min(waits[1:]):.3f}-"
        f"{max(waits[1:]):.3f}] ms; {wall:.1f} s in all, "
        f"{steps / wall:.1f} steps/s")
    return model.eval()


def trained_eval(model, cfg, data, mode, device, dtype=None, quantize=False,
                 img=TRAINED_SET["img_size"], batch=TRAINED_BATCH,
                 max_targets=32):
    """``fuse_for_inference`` + ``evaluate`` of ``model`` on ``device`` at
    conf 0.001, iou 0.65 and, by default, 32 targets an image
    (tests/test_trained_parity.py:215-218): ``((mp, mr, map50, map5095),
    {nms kernel: launches})``."""
    from ryolo_tpu_torch.eval.evaluator import evaluate
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.ops import cuda_nms

    fused = fuse_for_inference(model, dtype=dtype, device=device,
                               quantize=quantize)
    # this run's launches only: every count set to 0 just before
    for key in cuda_nms.LAUNCHES:
        cuda_nms.LAUNCHES[key] = 0
    res = evaluate(fused, None, data, cfg["hyp"], mode == "csl", img, batch,
                   conf_thres=0.001, iou_thres=0.65,
                   max_targets=max_targets, progress=False, device=device)
    return res[:4], dict(cuda_nms.LAUNCHES)


def trained_images(cfg, path, mode, img, n):
    """The first ``n`` images of the custom split at ``path`` as the
    loader gives them, ``(n, 3, img, img)`` float32 on the CPU."""
    from ryolo_tpu_torch.data.loader import load_data

    _, loader = load_data(path, SYNTH_NAMES, "custom", cfg["hyp"],
                          mode == "csl", img_size=img, batch_size=n,
                          augment=False, shuffle=False, workers=1)
    return torch.as_tensor(np.asarray(next(iter(loader))["images"])).permute(
        0, 3, 1, 2).float().contiguous()


def graph_rows(model, x, device):
    """The trained ``model``'s fused float32 graph and its int8 graph
    (dynamic scales, float32 compute, as phase 19 evaluates it) on images
    ``x``, on ``device``: ``{"f32": decoded rows, "int8": decoded rows}``
    on the CPU."""
    from ryolo_tpu_torch.nn import fuse_for_inference

    out = {}
    for key, quantize in (("f32", False), ("int8", True)):
        with torch.no_grad():
            out[key] = fuse_for_inference(model, device=device,
                                          quantize=quantize)(
                x.to(device), decode=True)[1].cpu()
    return out


def int8_gaps(got, want):
    """:func:`graph_rows` ``got`` against ``want`` (the same weights and
    images), each distance as a multiple of ``want``'s own int8-to-float32
    distance (L2 over L2, of the confidences and of the box coordinates):
    ``got``'s int8 rows from ``want``'s int8 rows (``conf``, ``box``) and
    from ``want``'s float32 rows (``conf to f32``, ``box to f32``); the
    largest gaps of the int8 rows and of the float32 rows
    (:func:`dec_gap`)."""
    def l2(a, b, cols):
        return (a[..., cols] - b[..., cols]).double().norm().item()

    q, wq, wf = got["int8"], want["int8"], want["f32"]
    out = {}
    for name, cols in (("conf", slice(5, None)), ("box", slice(0, 4))):
        own = l2(wq, wf, cols)
        out[name] = l2(q, wq, cols) / own
        out[f"{name} to f32"] = l2(q, wf, cols) / own
    out["max conf"], out["max box"] = dec_gap(q, wq)
    out["f32 max conf"], out["f32 max box"] = dec_gap(got["f32"], wf)
    return out


def fmt_gaps(g):
    return ", ".join(f"{k} {v:.4g}" for k, v in g.items())


def int8_within(g):
    b = INT8_TRAINED_BOUND
    return all(g[k] <= b["apart"] and g[f"{k} to f32"] >= b["quantized"]
               for k in ("conf", "box"))


def trained_int8_card_vs_cpu(model, cfg, path, mode, img, n):
    """The trained ``model``'s int8 graph on the first ``n`` images at
    ``path`` on the card, each int32 accumulator equal to its plain
    version bit for bit, then card against CPU (:func:`int8_gaps`), held
    to :data:`INT8_TRAINED_BOUND`; the card's float32 graph in the int8
    graph's place must fail it.  Returns the gaps (with the count of
    products checked), and the CPU's own int8
    graph against itself on the images nudged up by one float32 ulp (the
    graph's sensitivity to its input's last bit, not bounded)."""
    from ryolo_tpu_torch.ops import int8_conv

    x = trained_images(cfg, path, mode, img, n)
    product, exact = int8_conv.int8_conv2d, []

    def compared(q, kq, stride, pad):
        acc = product(q, kq, stride, pad)
        exact.append(torch.equal(acc.cpu(), int8_conv.int8_conv2d_plain(
            q.cpu(), kq.cpu(), stride, pad)))
        return acc

    with patched([(int8_conv, "int8_conv2d", compared)]):
        got = graph_rows(model, x, "cuda")
    check(exact and all(exact), f"trained {mode} int8 at {img} px: "
          f"{exact.count(False)} of {len(exact)} products differ from the "
          "plain version")
    want = graph_rows(model, x, "cpu")
    gaps = dict(int8_gaps(got, want), products=len(exact))
    check(int8_within(gaps), f"trained {mode} int8 at {img} px, card "
          f"against CPU: {gaps}")
    check(not int8_within(int8_gaps({"int8": got["f32"], "f32": got["f32"]},
                                    want)),
          f"trained {mode} at {img} px: the card's float32 rows pass the "
          "int8 bound")
    nudged = graph_rows(model, torch.nextafter(x, torch.tensor(2.0)), "cpu")
    return gaps, int8_gaps(nudged, want)


def phase_trained(tmp, cfg):
    """Phase 19(a)-(b): YOLOv5-CSL and YOLOv5-KFIoU trained on the card
    (:func:`trained_model_train`), then ``evaluate`` of the trained weights
    on the val split on the card in float32, bf16 and int8 (the float32
    graph with the wide convs int8, as tests/test_trained_parity.py:264
    fuses) and on the CPU in float32; on the training images in float32 on
    the card and the CPU.  Checks one ``nms_mask`` and one ``nms_scan`` a
    card batch, card against CPU within 5e-3 on both mAPs and both splits,
    the floors of :data:`TRAINED_FLOORS` in float32 and bf16, and the int8
    graph on the val images, its products exact and its decoded rows card
    against CPU (:func:`trained_int8_card_vs_cpu`); reports bf16's and
    int8's mAP against float32.  Returns ``{mode: nms_mask (and nms_scan) launches}``
    and the trained CSL model."""
    root = os.path.join(tmp, "trained_synth")
    write_custom_set(root, **TRAINED_SET)
    splits = {s: {"val": os.path.join(root, s), "names": SYNTH_NAMES,
                  "type": "custom"} for s in ("val", "train")}
    n_batches = {s: -(-len([f for f in os.listdir(d["val"])
                            if f.endswith(".png")]) // TRAINED_BATCH)
                 for s, d in splits.items()}
    runs = (("f32", "val", "cuda", None, False),
            ("bf16", "val", "cuda", torch.bfloat16, False),
            ("int8", "val", "cuda", None, True),
            ("cpu f32", "val", "cpu", None, False),
            ("train f32", "train", "cuda", None, False),
            ("train cpu f32", "train", "cpu", None, False))
    out, csl_model = {}, None
    for mode in ("csl", "kfiou"):
        torch.cuda.empty_cache()
        model = trained_model_train(root, cfg, mode)
        maps, n_launch = {}, 0
        for key, split, device, dtype, quantize in runs:
            maps[key], launches = trained_eval(
                model, cfg, splits[split], mode, device, dtype, quantize)
            want = n_batches[split] if device == "cuda" else 0
            check(launches == {"nms_mask": want, "nms_scan": want},
                  f"trained {mode} {key}: launches {launches}")
            n_launch += launches["nms_mask"]

        def gap(a, b):
            return [abs(maps[a][i] - maps[b][i]) for i in (2, 3)]
        gaps = {k: gap(k, "f32") for k in ("bf16", "int8", "cpu f32")}
        gaps["train cpu f32"] = gap("train cpu f32", "train f32")
        int8, nudged = trained_int8_card_vs_cpu(
            model, cfg, splits["val"]["val"], mode, TRAINED_SET["img_size"],
            TRAINED_BATCH)
        floors = TRAINED_FLOORS[mode]
        log("trained", f"yolov5-{mode} trained weights, conf 0.001, iou "
            f"0.65, batch {TRAINED_BATCH} at {TRAINED_SET['img_size']} px "
            "(val: 4 images, train: 8): " + "; ".join(
                f"{k} mAP@.5 {v[2]:.6f} mAP@.5:.95 {v[3]:.6f}"
                for k, v in maps.items())
            + "; gaps (mAP@.5, mAP@.5:.95): " + "; ".join(
                f"{k} {g[0]:.2e} / {g[1]:.2e}" for k, g in gaps.items())
            + f"; JAX's val floor {floors['jax_val']}: "
            + ("met" if maps["f32"][2] > floors["jax_val"] else "not met")
            + f"; launches {n_launch} nms_mask and nms_scan over "
            f"{len(runs) - 2} card evals; the int8 graph's decoded rows on "
            "the 4 val images, card against CPU, over the CPU's int8-to-f32 "
            f"distance (bounds {INT8_TRAINED_BOUND}): " + fmt_gaps(int8)
            + "; the CPU against itself with "
            "the images nudged by one ulp: " + fmt_gaps(nudged))
        for key in ("f32", "bf16"):
            check(maps[key][2] > floors["val"], f"trained {mode} {key}: "
                  f"val mAP@.5 {maps[key][2]}, floor {floors['val']}")
        check(maps["train f32"][2] > floors["train"], f"trained {mode}: "
              f"train mAP@.5 {maps['train f32'][2]}, floor "
              f"{floors['train']}")
        for key in ("cpu f32", "train cpu f32"):
            check(max(gaps[key]) <= MAP_BOUND,
                  f"trained {mode}: card against CPU, {key} {gaps[key]}")
        if mode == "csl":
            csl_model = model
        out[mode] = n_launch
        del model
    return out, csl_model


def phase_trained_load(tmp, cfg, model):
    """Phase 19(c): the trained CSL model's ``evaluate`` on 16 scenes at
    800 px with 100-200 objects at the trained pixel size, batch 8, conf
    0.001, iou 0.65, once to warm up and once timed with phase 8's spans:
    images/s, the candidates into the NMS and the boxes kept per image,
    post-process, ``nms_mask``, ``nms_scan`` and matcher ms a batch, the
    pairs the far reject leaves on batch 2 with ``nms_mask``'s bound at
    that shape; one ``nms_mask`` and one ``nms_scan`` a batch.  Returns the
    launches of the timed run and the bound's numbers."""
    import ryolo_tpu_torch.eval.evaluator as ev
    import ryolo_tpu_torch.eval.postprocess as pp
    from ryolo_tpu_torch.nn import fuse_for_inference
    from ryolo_tpu_torch.ops import cuda_nms

    kw = dict(TRAINED_LOAD)
    n, img = kw.pop("n_images"), kw.pop("img_size")
    split = os.path.join(tmp, "trained_load")
    write_custom_split(split, n, img, np.random.default_rng(SEED + 19), **kw)
    data = {"val": split, "names": SYNTH_NAMES, "type": "custom"}
    fused = fuse_for_inference(model, device="cuda")
    n_batches = -(-n // BATCH)
    nms = pp.nms_rotated_masked
    for run in ("warm-up", "timed"):
        seen = []

        def keep_input(boxes, scores, valid, *a, **kw):
            order, keep = nms(boxes, scores, valid, *a, **kw)
            seen.append((boxes.clone(), valid.clone(), keep.sum(1)))
            return order, keep

        spans = Spans()
        for key in cuda_nms.LAUNCHES:
            cuda_nms.LAUNCHES[key] = 0
        with eval_spans(spans), patched([(pp, "nms_rotated_masked",
                                          keep_input)]):
            mp, mr, map50, map5095, _ = spans.sync_counted(ev.evaluate)(
                fused, None, data, cfg["hyp"], True, img, BATCH, 0.001,
                0.65, progress=False, device="cuda")
        launches = dict(cuda_nms.LAUNCHES)
        torch.cuda.synchronize()
        check(launches == {"nms_mask": n_batches, "nms_scan": n_batches},
              f"trained load {run}: launches {launches} over {n_batches} "
              "batches")
        check(len(seen) == n_batches, len(seen))
        wall = spans.last - spans.first
        per_batch = {k: spans.ms(k) for k in EVAL_SPANS}
        # the real images' rows (the last batch is padded to BATCH)
        cands = [int(v) for _, valid, _ in seen for v in valid.sum(1)][:n]
        kept = [int(v) for _, _, k in seen for v in k][:n]
        log("trained_load", f"yolov5-csl trained, {run}: {n} images of "
            f"{img} px, {n_batches} batches of {BATCH}; {n / wall:.2f} "
            f"images/s ({wall:.3f} s); P {mp:.4g} R {mr:.4g} mAP@.5 "
            f"{map50:.4g} mAP@.5:.95 {map5095:.4g}; launches {launches}; "
            f"host syncs per batch {sum(spans.syncs) / n_batches:.2f} on "
            "the issuing thread; candidates into the NMS per image "
            f"{cands}; kept per image {kept}")
    for b in range(n_batches):
        log("trained_load", f"batch {b + 1} ms: " + ", ".join(
            f"{k} {per_batch[k][b]:.3f}" for k in EVAL_SPANS
            if b < len(per_batch[k])))
    bound = mask_bound(*seen[1][:2])
    mask_ms = per_batch["mask"][1]
    log("trained_load", f"nms_mask on batch 2: valid candidates per image "
        f"{bound['valid']}, {bound['pairs']} valid pairs decided, "
        f"{bound['near']} not ruled out by the far reject "
        f"({100 * bound['near'] / max(bound['pairs'], 1):.2f}%); bound "
        f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}), measured "
        f"{mask_ms:.4f} ms ({100 * bound['bound_ms'] / mask_ms:.2f}% of it)")
    return dict(launches=launches, mask_bound=dict(bound, ms=mask_ms))


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
        main_res, weights = phase_main_path(tmp, model)
        phase_card_vs_cpu(model)
        evals = phase_eval(tmp, names, weights)
        phase_eval_card_vs_cpu(tmp, names, model, cfg)
        # phase 11: YOLOv5 (the CLIs' default --ver); phase 12: YOLOv4
        model = build_model(cfg, "yolov5")
        det_v5, weights = phase_main_path(tmp, model)
        phase_card_vs_cpu(model)
        eval_v5 = phase_eval(tmp, names, weights, "yolov5", ("f32",))
        model = build_model(cfg, "yolov4")
        det_v4, _ = phase_main_path(tmp, model, DETECT_RUNS[1:2])
        # phase 13: YOLOv7-KFIoU; phase 14: YOLOv5-KFIoU
        model = build_model(cfg, "yolov7", "kfiou")
        det_kf, weights = phase_main_path(tmp, model)
        phase_card_vs_cpu(model)
        eval_kf = phase_eval(tmp, names, weights, "yolov7", ("f32",), "kfiou")
        model = build_model(cfg, "yolov5", "kfiou")
        det_v5_kf, _ = phase_main_path(tmp, model, DETECT_RUNS[1:2])
        # phase 16: the int8 deploy path, YOLOv7-CSL with dynamic and
        # static scales, and YOLOv5-CSL at eval load
        model = build_model(cfg)
        det_int8, weights = phase_main_path(tmp, model, DETECT_RUNS_INT8)
        int8 = phase_int8_bits(model)
        phase_int8_card_vs_cpu(model)
        eval_int8 = phase_eval(tmp, names, weights, "yolov7", ("int8",))
        model = build_model(cfg, "yolov5")
        det_v5_int8, _ = phase_main_path(tmp, model, DETECT_RUNS_INT8[1:2])
        del model
        bounds = {tag(v, m): e["results"]["mask_bound"] for v, m, e in (
            ("yolov7", "csl", evals), ("yolov5", "csl", eval_v5),
            ("yolov7", "kfiou", eval_kf))}
        split = os.path.join(tmp, "dota_train")
        write_dota_split(split, names, np.random.default_rng(SEED + 2))
        train = phase_train(split, names, cfg)
        phase_train_card_vs_cpu(split, names, cfg)
        cli = phase_train_cli(tmp, names, cfg)
        bank_taps = TRAIN_RUNS[1:2]
        train_v5 = phase_train(split, names, cfg, "yolov5", bank_taps)
        train_v4 = phase_train(split, names, cfg, "yolov4", bank_taps,
                               steps=SHORT_TRAIN_STEPS)
        train_kf = phase_train(split, names, cfg, "yolov7", bank_taps,
                               mode="kfiou")
        phase_train_card_vs_cpu(split, names, cfg, "kfiou")
        train_v5_kf = phase_train(split, names, cfg, "yolov5", bank_taps,
                                  steps=SHORT_TRAIN_STEPS, mode="kfiou")
        # phase 15: bf16 training, YOLOv7-CSL
        train_bf16 = phase_train(split, names, cfg, "yolov7", bank_taps,
                                 dtype="bf16")
        phase_train_card_vs_cpu_bf16(split, names, cfg)
        cli_bf16 = phase_train_cli(tmp, names, cfg, "bf16")
        phase_train_profile(split, names, cfg)
        # phase 17: data parallelism (train --dp): (a) one rank of an NCCL
        # group, (b) 2 gloo ranks sharing the card, (c) 2 NCCL ranks on two
        # cards where there are two
        dp_world1 = phase_dp_world1(split, names, cfg, train["results"])
        dp_runs = {"b": phase_dp_ranks(tmp, split, names, cfg, dp_world1, "b",
                                       "cuda:0", "gloo")}
        if torch.cuda.device_count() >= 2:
            dp_runs["c"] = phase_dp_ranks(tmp, split, names, cfg, dp_world1,
                                          "c", "cuda", "nccl")
        else:
            log("dp", f"(c) not run: {torch.cuda.device_count()} card; it "
                "runs (b)'s 2 ranks over NCCL, one card each")
        # phase 18: spatial sharding (train --dp N --sp 2): (a) 2 gloo
        # ranks sharing the card, one group; (c) 4 NCCL ranks on four cards
        # where there are four
        plain_mem = {"yolov7": train["results"]["tile bank, taps"]["mem"],
                     "yolov5": train_v5["results"]["tile bank, taps"]["mem"]}
        sp_runs = sp_phases(tmp, split, names, cfg, plain_mem)
        # phase 19: trained weights, (a)-(b) YOLOv5-CSL and -KFIoU trained
        # and evaluated, (c) the trained CSL model's eval load at 800 px
        trained, csl_model = phase_trained(tmp, cfg)
        trained_load = phase_trained_load(tmp, cfg, csl_model)
        del csl_model

    # each path's launches, counted from 0 around its own runs
    by_path = {key: {path: sum(r["launches"][key] for r in res.values())
                     for path, res in (("detect", main_res),
                                       ("detect_v5", det_v5),
                                       ("detect_v4", det_v4),
                                       ("detect_kfiou", det_kf),
                                       ("detect_v5_kfiou", det_v5_kf),
                                       ("detect_int8", det_int8),
                                       ("detect_v5_int8", det_v5_int8))}
               for key in ("nms_mask", "nms_scan")}
    for key in by_path:
        by_path[key].update(eval=evals["launches"][key],
                            eval_v5=eval_v5["launches"][key],
                            eval_kfiou=eval_kf["launches"][key],
                            eval_int8=eval_int8["launches"][key])
        for label, run in dp_runs.items():
            by_path[key][f"eval_dp2_{label}"] = run["nms"][key]
        for label, run in sp_runs.items():
            by_path[key][f"eval_sp2_{label}"] = run["nms"][key]
        for mode, n in trained.items():
            by_path[key][f"eval_trained_{mode}"] = n
        by_path[key]["eval_trained_load"] = trained_load["launches"][key]
    by_path["render"] = {"train": train["render_launches"],
                         "train_cli": cli["render_launches"],
                         "train_v5": train_v5["render_launches"],
                         "train_v4": train_v4["render_launches"],
                         "train_kfiou": train_kf["render_launches"],
                         "train_v5_kfiou": train_v5_kf["render_launches"],
                         "train_bf16": train_bf16["render_launches"],
                         "train_cli_bf16": cli_bf16["render_launches"],
                         "train_dp1": dp_world1["render_launches"]}
    for label, run in dp_runs.items():
        by_path["render"][f"train_dp2_{label}"] = run["render_launches"]
        by_path["render"][f"train_cli_dp2_{label}"] = run[
            "cli_render_launches"]
    for label, run in sp_runs.items():
        by_path["render"][f"train_sp2_{label}"] = run["render_launches"]
        by_path["render"][f"train_cli_sp2_{label}"] = run[
            "cli_render_launches"]
    launches = {key: sum(v.values()) for key, v in by_path.items()}
    iou_launches = sum(r["iou_launches"] for res in (main_res, det_v5, det_v4,
                                                     det_kf, det_v5_kf,
                                                     det_int8, det_v5_int8)
                       for r in res.values())
    int8_by_path = {path: sum(r["int8_launches"] for r in res.values())
                    for path, res in (("detect_int8", det_int8),
                                      ("detect_v5_int8", det_v5_int8))}
    int8_by_path["eval_int8"] = eval_int8["int8_launches"]
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
        "launches": launches["nms_mask"],
        "launches_by_path": by_path["nms_mask"], **nms["mask"],
        "path_bounds": dict(bounds, trained_load=trained_load[
            "mask_bound"]),
        "library_ms": None}, {
        "name": "nms_scan", "route": "cuda", "source": nms_src,
        "replaces": "ryolo_tpu/ops/rotated_nms.py:152-212 (XLA while_loop; "
                    "no Pallas kernel)",
        "launches": launches["nms_scan"],
        "launches_by_path": by_path["nms_scan"], **nms["scan"],
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
        "launches": launches["render"],
        "launches_by_path": by_path["render"],
        "max_abs_err": render["max_abs_err"],
        "ms": render["ms"], "plain_ms": render["plain_ms"],
        "bound_ms": render["bound_ms"], "bound_by": render["bound_by"],
        "library_ms": None}],
        # not a kernel of the port: the int8 deploy conv's product is a
        # library call, as the JAX package leaves it to XLA
        "library_products": [{
            "name": "int8_conv2d", "route": "torch._int_mm (cuBLASLt)",
            "source": "ryolo_tpu_torch/ops/int8_conv.py",
            "replaces": "ryolo_tpu/nn/blocks.py:357-362 and :676-681 (XLA "
                        "conv_general_dilated into int32; no Pallas kernel)",
            "launches": sum(int8_by_path.values()),
            "launches_by_path": int8_by_path,
            "max_abs_err": int8["max_abs_err"], "ms": int8["ms"],
            "plain_ms": int8["plain_ms"], "bound_ms": int8["bound_ms"],
            "bound_by": int8["bound_by"], "shape": int8["shape"],
            "library_ms": None}]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
