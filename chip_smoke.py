#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ryolo_tpu_torch``) on one NVIDIA GPU.

Usage, from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device: the card's name and power limit, torch and CUDA versions, the
   TF32 flags (both off: every float32 number here is float32);
2. build: every CUDA kernel of the port from ``ryolo_tpu_torch/ops/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it plus probes, and their times;
4. main path: YOLOv7-CSL, nc = 16, seeded random weights, deploy-fused,
   f32, 800 px, batch 8, driven through ``ryolo_tpu_torch.detect.Detect``
   on a folder of synthetic images at the CLI default (conf 0.7, iou 0.2)
   and at eval load (conf 0.001, iou 0.65), with the kernel launches, and
   once more at eval load in bf16;
5. card against CPU at 256 px, batch 2: fused head maps, and equal keep
   sets from post-processing on the card (kernel) and on the CPU (plain).

Then one JSON line with every kernel's numbers and, last, the result line.
Any failure raises: the script exits non-zero and prints no result.  It
refuses to run without a CUDA device.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from argparse import Namespace

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NC = 16
IMG, BATCH, N_IMAGES = 800, 8, 40
H100_FP32_OPS = 67e12      # FP32 outside the tensor cores, dense
H100_BYTES_PER_S = 3.35e12  # HBM3


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

    t = time.perf_counter()
    _build.build(["rotated_iou"])
    log("build", f"rotated_iou built in {time.perf_counter() - t:.3f} s")
    for line in _build.ptxas_report("rotated_iou").splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())


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
    from ryolo_tpu_torch.detect import Detect
    from ryolo_tpu_torch.ops import cuda_iou, rotated_nms
    from ryolo_tpu_torch.utils.config import load_yaml

    names = load_yaml(os.path.join(REPO, "configs", "DOTA.yaml"))["names"]
    check(len(names) == NC, names)
    write_images(os.path.join(tmp, "test"), np.random.default_rng(SEED))
    data = os.path.join(tmp, "data.yaml")
    with open(data, "w") as f:
        json.dump({"test": os.path.join(tmp, "test"), "names": names}, f)
    weights = os.path.join(tmp, "w.pth")
    torch.save(model.state_dict(), weights)

    # time every NMS call and kernel launch with CUDA events, by batch
    # (wrapping the module functions; the launch count stays the wrapper's)
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

    pp.nms_rotated_masked = timed("nms", pp.nms_rotated_masked)
    cuda_iou._launch = timed("kernel", cuda_iou._launch)

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
            spans.append({"nms": [], "kernel": []})
            return infer(*a, **kw)

        det.infer = batch_infer
        spans.clear()
        cuda_iou.LAUNCHES["rotated_iou"] = 0
        rotated_nms.SYNCS["nms"] = 0
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            out = det.detect()
        finally:
            os.chdir(cwd)
        launches = cuda_iou.LAUNCHES["rotated_iou"]
        syncs = rotated_nms.SYNCS["nms"]
        torch.cuda.synchronize()

        check(len(out) == N_IMAGES, len(out))
        n_det = [len(d) for _, d in out]
        for _, d in out:
            check(d.shape[1:] == (7,) and np.isfinite(d).all(), "rows")
            check(((d[:, 6] >= 0) & (d[:, 6] < NC)).all(), "classes")
            check(((d[:, 5] > conf) & (d[:, 5] <= 1)).all(), "scores")
        check(max(n_det) > 0, "no detections")
        nb = len(det.batch_s)
        # batch 0 carries cuDNN autotuning: steady numbers from batch 2 on
        steady = det.batch_s[1:]
        ips = BATCH * len(steady) / sum(steady)
        stage = {k: float(np.mean([s[k] for s in det.stage_ms[1:]]))
                 for k in det.stage_ms[0]}
        for key in ("nms", "kernel"):
            stage[key] = float(np.mean([
                sum(s.elapsed_time(e) for s, e in b[key]) for b in spans[1:]]))
        log("main", f"{label} (conf {conf}, iou {iou}, {dtype}): {nb} batches "
            f"of {BATCH} at {IMG} px; {ips:.2f} images/s in infer (batches "
            f"2..{nb}), {N_IMAGES / det.total_s:.2f} images/s wall with "
            "letterbox and drawing; ms per batch " + ", ".join(
                f"{k} {v:.3f}" for k, v in stage.items()))
        log("main", f"{label}: detections per image min {min(n_det)} max "
            f"{max(n_det)}; rotated_iou launches {launches} "
            f"({launches / nb:.1f} per batch); NMS host syncs {syncs} "
            f"({syncs / nb:.1f} per batch)")
        results[label] = dict(launches=launches, ips=ips, stage=stage)
    check(results["eval_load"]["launches"] > 0, "kernel never launched")
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

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kern = phase_kernels()
    cfg = load_yaml(os.path.join(REPO, "configs", "hyp.yaml"))
    model = build_model(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        main_res = phase_main_path(tmp, model)
    phase_card_vs_cpu(model)

    launches = sum(r["launches"] for r in main_res.values())
    print(json.dumps({"kernels": [{
        "name": "rotated_iou", "route": "cuda",
        "source": "ryolo_tpu_torch/ops/csrc/rotated_iou.cu",
        "replaces": "ryolo_tpu/ops/pallas_iou.py:76",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None}]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
