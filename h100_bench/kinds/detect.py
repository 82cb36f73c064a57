"""Detect: the port's ``Detect.infer`` on letterboxed uint8 batches, then
``(dets, valid)`` fetched to the host, in a closed loop with one batch in
flight.

Set-up draws the scenes and the weights from the seed (with a score prior:
fixed, or calibrated on the reference's forward so that about
``candidates_per_image`` candidates an image pass the threshold), builds
the port's deploy-fused model from those weights and runs every distinct
batch once (cuDNN's search).  The window cycles the batches.  For a sample
of the window's batches drawn from the seed, the fused model's head maps
are copied aside, and the neck features that the head convolutions take;
once the window has closed the reference's unfused float32 forward on the
same images bounds the share of the features' channels that lie more than
3% from it (``channels_off``); the reference's head convolutions, in
float32 on the port's own features, bound the port's head maps channel by
channel (``head_gap``); and the candidates that the reference re-derives
from the port's head maps hold its ``(dets, valid)`` to greedy NMS
(``nms_faults``, exact).  The three stages follow one another, each from
the port's own output of the stage before.
"""

from __future__ import annotations

import time
from argparse import Namespace

import numpy as np

from h100_bench import harness, peaks, roofline, synth
from h100_bench.reference import compare


def _calibrate(ref, batches, nc, conf, target, dev, torch):
    """The score prior that puts the median image at ``target``
    candidates above ``conf`` (bisection on the reference's logits)."""
    obj, cls = [], []
    for images in batches:
        heads, _ = compare.forward_heads(ref, images, dev)
        for h in heads:
            b, c, gh, gw = h.shape
            v = h.view(b, ref.na, c // ref.na, gh * gw)
            obj.append(v[:, :, 4].reshape(b, -1))
            cls.append(v[:, :, 5:5 + nc].amax(2).reshape(b, -1))
    obj, cls = torch.cat(obj, 1), torch.cat(cls, 1)

    def count(p):
        score = torch.sigmoid(obj + p) * torch.sigmoid(cls + p)
        return float((score > conf).sum(1).float().median())
    lo, hi = -30.0, 30.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if count(mid) < target else (lo, mid)
    return hi, count(hi)


def _plant(det, model, fault, compare):
    """Break the timed call for a fault run: ``half_batch`` (the second
    half of the batch gets no detections), ``altered`` (one kept box
    moves), ``stale`` (each batch returns the previous batch's answer),
    ``head_bias`` (the fused head convolutions' obj biases raised by 1, as
    a score prior applied twice)."""
    if fault == "head_bias":
        for conv in compare.head_convs(model):
            conv.bias.data.view(model.na, model.nf)[:, 4] += 1.0
        return
    infer = det.infer
    prev = []

    def broken(*a, **kw):
        dets, valid = infer(*a, **kw)
        if fault == "half_batch":
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = False
        elif fault == "altered":
            dets = dets.clone()
            dets[0, 0, 0] += 1.0
        elif fault == "stale":
            prev.append((dets, valid))
            dets, valid = prev[-2] if len(prev) > 1 else prev[-1]
        return dets, valid
    if fault is None:
        return
    if fault not in ("half_batch", "altered", "stale", "head_bias"):
        raise ValueError(f"no fault {fault!r} for detect")
    det.infer = broken


def run(ctx) -> dict:
    torch = ctx.torch
    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cuda = dev.type == "cuda"
    import ryolo_tpu_torch.eval.postprocess as pp
    from ryolo_tpu_torch.detect import Detect, _Stages
    from ryolo_tpu_torch.nn import Yolo, fuse_for_inference
    from ryolo_tpu_torch.utils.device import DTYPES, set_float32_math

    steps = {}
    t = time.perf_counter()
    if cuda:
        from ryolo_tpu_torch.ops import _build
        _build.build(["rotated_nms"])
    steps["nvcc build (rotated_nms.cu), or the built library found"] = \
        time.perf_counter() - t

    bs, size, nc = traffic["batch"], cfg["img_size"], cfg["nc"]
    conf, iou = traffic["conf_thres"], traffic["iou_thres"]
    t = time.perf_counter()
    rng = np.random.default_rng([ctx.seed, 1])
    scenes = synth.scenes(bs * traffic["distinct_batches"], size, rng)
    host = [scenes[i:i + bs] for i in range(0, len(scenes), bs)]
    steps["scenes from the seed"] = time.perf_counter() - t

    t = time.perf_counter()
    compare.float32_math(tf32=False)
    ref = compare.build_model(cfg, dev, train=False)
    prior = traffic.get("score_prior", 0.0)
    synth.seeded_weights(ref, ctx.seed, cfg["weights"], dev, prior)
    if "candidates_per_image" in traffic:
        prior, got = _calibrate(ref, host, nc, conf,
                                traffic["candidates_per_image"], dev, torch)
        synth.add_score_prior(ref, prior)
        harness.log(f"score prior {prior:.6f}: median {got} candidates an "
                    f"image above conf {conf} (reference, float32)")
    state = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
    del ref
    steps["weights from the seed" + (", the prior's calibration"
                                     if "candidates_per_image" in traffic
                                     else "")] = time.perf_counter() - t
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t = time.perf_counter()
    with torch.device(dev):
        model = Yolo(nc, cfg["model"], mode=cfg["mode"], ver=cfg["ver"])
    model.load_state_dict(state, strict=True)
    dtype_name = "int8" if ctx.control else cfg["dtype"]
    dtype = DTYPES[dtype_name]
    if cuda and dtype == torch.float32:
        set_float32_math(dev)
    model = fuse_for_inference(model, dtype=dtype, device=dev,
                               quantize=dtype_name == "int8")
    if cuda:
        torch.backends.cudnn.benchmark = True  # fixed shapes, as the CLI
    det = Detect(Namespace(conf_thres=conf, nms_thres=iou))
    _plant(det, model, ctx.fault, compare)
    steps[f"the port's fused {dtype_name} model"] = time.perf_counter() - t

    # the fused model's head maps of the sampled batches, copied aside
    levels = [size // s for s in (8, 16, 32)]
    n_check = traffic["check_batches"]
    sampled = set(np.random.default_rng([ctx.seed, 2]).choice(
        max(n_check, int(ctx.seconds * traffic["check_from_per_s"])),
        n_check, replace=False).tolist())
    ch = model.na * model.nf
    convs = compare.head_convs(model)
    store = [[torch.empty((bs, ch, g, g), dtype=dtype, device=dev)
              for g in levels] for _ in range(n_check)]
    fstore = [[torch.empty((bs, c.in_channels, g, g), dtype=dtype, device=dev)
               for c, g in zip(convs, levels)] for _ in range(n_check)]
    # the copies are the harness's, not the deployment's: left out of the
    # peak (the allocator rounds each block up to 512 bytes)
    copies_bytes = sum(-(-t.nbytes // 512) * 512
                       for slot in store + fstore for t in slot)
    capture = {"slot": None}

    def keep_heads(_mod, _inp, out):
        if capture["slot"] is not None:
            for buf, h in zip(store[capture["slot"]], out):
                buf.copy_(h)
    model.register_forward_hook(keep_heads)
    for lvl, conv in enumerate(convs):
        def keep_feature(_mod, inp, lvl=lvl):
            if capture["slot"] is not None:
                fstore[capture["slot"]][lvl].copy_(inp[0])
        conv.register_forward_pre_hook(keep_feature)

    def one(images):
        stages = _Stages(dev)
        a = time.perf_counter()
        dets, valid = det.infer(model, images, dtype, dev, nc, stages)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        return time.perf_counter() - a, dets, valid, stages.elapsed_ms()

    t = time.perf_counter()
    for images in host:  # every shape, cuDNN's search
        one(images)
    if cuda:
        torch.cuda.synchronize(dev)
    steps["one pass over the distinct batches (cuDNN's search)"] = \
        time.perf_counter() - t

    for k, v in steps.items():
        harness.log(f"set-up: {k} {v:.3f} s")
    setup_end = time.perf_counter()
    lat, stage_ms, checked, failed = [], [], [], 0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        images = host[i % len(host)]
        capture["slot"] = len(checked) if i in sampled else None
        s, dets, valid, ms = one(images)
        lat.append(s)
        stage_ms.append(ms)
        failed += int(not np.isfinite(dets).all())
        if capture["slot"] is not None:
            checked.append((i % len(host), dets, valid))
        i += 1
    window_s = time.perf_counter() - t0
    capture["slot"] = None
    device = harness.device_entry(torch, dev, 1)
    if cuda:
        device["memory_peak_bytes"] -= copies_bytes
    n = len(lat)
    cands = [int(v.sum(1).mean()) for _, _, v in checked]
    record = {"kind": "detect", "window_s": window_s, "batches": n,
              "images": n * bs,
              "forward_ms": [m[0] for m in stage_ms],
              "post_ms": [m[1] + m[2] for m in stage_ms],
              "batch_flops": ctx.forward_flops(cfg, bs, size),
              "peak_flops": peaks.FLOPS[str(dtype).replace("torch.", "")]}
    harness.log(f"window: {n} batches in {window_s:.3f} s, p95 "
                f"{harness.percentile(lat, 95) * 1e3:.3f} ms; kept an image "
                f"(sampled batches) {cands}; peak memory "
                f"{device['memory_peak_bytes']} B without the harness's "
                f"{copies_bytes} B of copies; {harness.smi()}")
    trace = None
    if ctx.trace:
        trace = _traced(ctx, pp, one, host, traffic["trace_batches"], record)
        record["trace"] = trace
    _log_launches()
    e2e = {"detect_img_s": n * bs / window_s,
           "detect_p95_ms": harness.percentile(lat, 95) * 1e3}

    del model, det
    if cuda:
        torch.cuda.empty_cache()
    ctx.after_window()

    t = time.perf_counter()
    compare.float32_math(tf32=False)
    if cuda:
        torch.backends.cudnn.benchmark = False
    ref = compare.build_model(cfg, dev, train=False)
    ref.load_state_dict(state)
    # nothing checked is no pass
    share = head_gap = float("inf") if not checked else 0.0
    gap = fgap = chan = 0.0
    faults = {}
    for slot, (j, dets, valid) in enumerate(checked):
        want, wfeat = compare.forward_heads(ref, host[j], dev)
        gaps = compare.channel_gaps(fstore[slot], wfeat)
        share = max(share, float((gaps > compare.CHANNEL_OFF).double()
                                 .mean(1).max()))
        chan = max(chan, float(gaps.mean(1).max()))
        gap = max(gap, compare.rel_gap(store[slot], want))
        fgap = max(fgap, compare.rel_gap(fstore[slot], wfeat))
        # the head stage alone: the port's maps against the reference's
        # head convolutions on the port's own features; in the control the
        # reference in float8 stands in the port's place
        heads = compare.head_maps(ref, fstore[slot], fp8=True) \
            if ctx.control else store[slot]
        head_gap = max(head_gap, float(compare.head_gaps(
            heads, compare.head_maps(ref, fstore[slot])).max()))
        rows, cvalid, boxes = compare.candidates(store[slot], ref.anchors,
                                                 ref.na, nc, conf)
        for k, v in compare.nms_faults(dets, valid, rows, cvalid, boxes, iou,
                                       pp.MAX_DET).items():
            faults[k] = faults.get(k, 0) + v
    harness.log(f"reference: {len(checked)} sampled batches in "
                f"{time.perf_counter() - t:.3f} s; neck features: share of "
                f"channels off by more than {compare.CHANNEL_OFF} {share!r}, "
                f"mean channel gap {chan!r}, gap {fgap!r}; head maps: gap "
                f"{gap!r} from the reference's forward (not compared: the "
                f"int8 control leaves the head convolutions in bf16), worst "
                f"channel's gap {head_gap!r} from the reference's head "
                f"convolutions on the port's features; NMS faults {faults}")
    limits = cfg["limits"]
    checks = {"channels_off": {"value": share,
                               "limit": limits["channels_off"]},
              "head_gap": {"value": head_gap, "limit": limits["head_gap"]},
              "nms_faults": {"value": sum(faults.values()),
                             "limit": limits["nms_faults"]}}
    return {"setup_end": setup_end, "e2e": e2e, "record": record,
            "attempted": n, "failed": failed, "checks": checks,
            "trace": trace, "device": device}


def _traced(ctx, pp, one, host, n, record):
    """``n`` more batches under the profiler, after the window, with the
    NMS's inputs kept for its kernels' least times."""
    torch, dev = ctx.torch, ctx.device
    cuda = dev.type == "cuda"
    nms_in = []
    nms = pp.nms_rotated_masked

    def kept_nms(boxes, scores, valid, thr, max_keep=1500, presorted=False):
        order, keep = nms(boxes, scores, valid, thr, max_keep=max_keep,
                          presorted=presorted)
        nms_in.append((boxes, valid, keep, max_keep))
        return order, keep
    pp.nms_rotated_masked = kept_nms
    try:
        if cuda:
            torch.cuda.synchronize(dev)
        with harness.Trace(torch, dev) as tr:
            t0 = time.perf_counter()
            for i in range(n):
                with torch.profiler.record_function("detect.batch"):
                    one(host[i % len(host)])
            window_s = time.perf_counter() - t0
    finally:
        pp.nms_rotated_masked = nms
    red = tr.reduce(window_s)
    mask_s = sum(roofline.mask_bound(b, v.bool())[0]
                 for b, v, _, _ in nms_in)
    scan_s = sum(roofline.scan_bound(k, v.bool(), m) for _, v, k, m in nms_in)
    mask_t, scan_t = tr.kernels("nms_mask_kernel"), tr.kernels(
        "nms_scan_kernel")
    record.update(nms_mask_bound_s=mask_s if mask_t else None,
                  nms_mask_s=sum(mask_t), nms_scan_bound_s=scan_s
                  if scan_t else None, nms_scan_s=sum(scan_t))
    harness.log(f"traced {n} batches in {window_s:.3f} s: busy "
                f"{red['busy_s']:.4f} s; {len(nms_in)} NMS calls, nms_mask "
                f"{len(mask_t)} launches {sum(mask_t):.6f} s (least "
                f"{mask_s:.6f} s), nms_scan {len(scan_t)} launches "
                f"{sum(scan_t):.6f} s (least {scan_s:.6f} s); valid "
                f"candidates an image {[int(v.sum()) for _, v, _, _ in nms_in[:2]]}")
    return red


def _log_launches():
    from ryolo_tpu_torch.ops import cuda_nms, int8_conv
    harness.log(f"launches: {dict(cuda_nms.LAUNCHES)} "
                f"{dict(int8_conv.LAUNCHES)}")
