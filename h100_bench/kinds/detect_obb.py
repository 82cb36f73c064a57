"""Detect with YOLO11l-OBB: the port's ``Detect.infer`` on letterboxed
uint8 batches, then ``(dets, valid)`` fetched to the host, in a closed loop
with one batch in flight, as ``kinds/detect.py`` runs the anchor heads.

Set-up draws the scenes and the weights from the seed (the reference's
model, ``reference/yolo11_obb.py``, filled by ``synth.seeded_weights``),
builds the port's deploy-fused model from those weights and runs every
distinct batch once (cuDNN's search).  The window cycles the batches.  For
a sample of the window's batches drawn from the seed, the fused model's
head maps are copied aside, and the three neck features its head takes;
once the window has closed the reference's unfused float32 forward on the
same images bounds the share of the features' channels that lie more than
3% from it (``channels_off``); the reference's head branches, in float32 on
the port's own features, bound the port's head maps channel by channel
(``head_gap``); and the candidates that the reference re-derives from the
port's head maps by the full DFL decode hold its ``(dets, valid)`` to
greedy NMS (``nms_faults``, exact).  ``--control`` puts the reference
computed in float8 (every convolution's input and kernel rounded to e4m3,
one scale a tensor) in the port's place: its forward in the feature
stage, its head in the head stage.

The record is a ``detect`` record, so the detect metrics read it as they
read ``kinds/detect.py``'s; a traced run adds the busy device time inside
the port's ``detect.psa`` and ``detect.obb_head`` spans.
"""

from __future__ import annotations

import copy
import time
from argparse import Namespace

import numpy as np
import torch

from h100_bench import harness, peaks, synth
from h100_bench.kinds import detect as anchor_detect
from h100_bench.reference import compare
from h100_bench.reference import yolo11_obb as ref_obb

# the port's spans whose kernels a traced run times, by record key
SPAN_KEYS = {"detect.psa": "psa_kernel_ms",
             "detect.obb_head": "obb_head_kernel_ms"}


def _reference(cfg, device):
    """The reference model on ``device``, its storage uninitialised."""
    with torch.device("meta"):
        model = ref_obb.Yolo11OBB(cfg["nc"])
    return model.to_empty(device=device).eval()


def batch_flops(cfg, batch: int, size: int) -> float:
    """Operations of one forward of ``batch`` images at ``size`` px: 2 x
    the multiply-adds of every convolution and of the attention's two
    matmuls (``q^T k`` and ``v attn^T``), from the reference's shapes on
    the meta device."""
    model = _reference(cfg, "meta")
    total = [0]

    def conv(mod, _inp, out):
        kh, kw = mod.kernel_size
        total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    def attention(mod, inp, _out):
        b, _, h, w = inp[0].shape
        n = h * w
        total[0] += 2 * b * mod.num_heads * n * n * (mod.key_dim
                                                     + mod.head_dim)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, ref_obb.Attention):
            m.register_forward_hook(attention)
    with torch.no_grad():
        model(torch.empty(batch, 3, size, size, device="meta"))
    return float(total[0])


def _fp8_copy(module):
    """A copy of ``module`` whose convolutions take their inputs and
    kernels rounded to float8 e4m3 (the precision control)."""
    out = copy.deepcopy(module)
    for m in out.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.data = compare._fp8(m.weight.data)
            m.register_forward_pre_hook(
                lambda _m, inp: (compare._fp8(inp[0]),))
    return out


def _class_convs(model):
    """The head's last class convolutions (``nc`` outputs), level order."""
    return [branch[2] for branch in model.head.cv3]


def _plant(det, model, fault):
    """``head_bias``: the class biases raised by 1 (a score prior applied
    twice); the other faults as ``kinds/detect.py`` plants them."""
    if fault == "head_bias":
        for conv in _class_convs(model):
            conv.bias.data += 1.0
        return
    anchor_detect._plant(det, model, fault, compare)


def _span_busy_ms(tr, n_batches):
    """Busy device ms a batch (union of kernel intervals) of the kernels
    launched inside each span of :data:`SPAN_KEYS`, matched to their
    launches by the profiler's correlation ids; ``None`` where no kernel
    was found (no card, or a port without the span)."""
    out = {}
    launches = [e for e in tr.events if e.get("cat") in ("cuda_runtime",
                                                         "cuda_driver")
                and "correlation" in e.get("args", {})]
    kernels = {}
    for e in tr.device_events():
        c = e.get("args", {}).get("correlation")
        if c is not None:
            kernels.setdefault(c, []).append(e)
    for span, key in SPAN_KEYS.items():
        ranges = [(e["ts"], e["ts"] + e["dur"]) for e in tr.events
                  if e.get("cat") == "user_annotation" and e["name"] == span]
        ivals = sorted((float(k["ts"]), float(k["ts"]) + float(k["dur"]))
                       for e in launches
                       if any(lo <= e["ts"] <= hi for lo, hi in ranges)
                       for k in kernels.get(e["args"]["correlation"], ()))
        busy, end = 0.0, -float("inf")
        for s, e in ivals:
            if e > end:
                busy += e - max(s, end)
                end = e
        out[key] = busy * 1e-3 / n_batches if ivals else None
    return out


def _traced(ctx, pp, one, host, n, record):
    """``kinds/detect.py``'s traced batches, with the profiler's events kept
    for :func:`_span_busy_ms`."""
    kept = []

    class Kept(harness.Trace):
        def __exit__(self, *exc):
            kept.append(self)
            return super().__exit__(*exc)
    trace_cls = harness.Trace
    harness.Trace = Kept
    try:
        red = anchor_detect._traced(ctx, pp, one, host, n, record)
    finally:
        harness.Trace = trace_cls
    spans = _span_busy_ms(kept[0], n)
    record.update(spans)
    harness.log(f"busy device ms a batch inside the port's spans: {spans}")
    return red


def run(ctx) -> dict:
    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cuda = dev.type == "cuda"
    import ryolo_tpu_torch.eval.postprocess as pp
    from ryolo_tpu_torch.detect import Detect, _Stages
    from ryolo_tpu_torch.nn import Yolo, fuse_for_inference
    from ryolo_tpu_torch.utils.device import DTYPES

    with torch.device("meta"):  # a port without this model fails here
        Yolo(cfg["nc"], cfg["model"], mode=cfg["mode"], ver=cfg["ver"])
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
    ref_obb.float32_math()
    ref = _reference(cfg, dev)
    synth.seeded_weights(ref, ctx.seed, cfg["weights"], dev)
    state = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
    del ref
    steps["weights from the seed"] = time.perf_counter() - t
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t = time.perf_counter()
    with torch.device(dev):
        model = Yolo(nc, cfg["model"], mode=cfg["mode"], ver=cfg["ver"])
    model.load_state_dict(state, strict=True)
    dtype = DTYPES[cfg["dtype"]]
    model = fuse_for_inference(model, dtype=dtype, device=dev)
    if cuda:
        torch.backends.cudnn.benchmark = True  # fixed shapes, as the CLI
    det = Detect(Namespace(conf_thres=conf, nms_thres=iou))
    _plant(det, model, ctx.fault)
    steps[f"the port's fused {cfg['dtype']} model"] = time.perf_counter() - t

    # the fused model's head maps and the head's input features of the
    # sampled batches, copied aside
    levels = [size // s for s in ref_obb.STRIDES]
    n_check = traffic["check_batches"]
    sampled = set(np.random.default_rng([ctx.seed, 2]).choice(
        max(n_check, int(ctx.seconds * traffic["check_from_per_s"])),
        n_check, replace=False).tolist())
    feat_ch = [branch[0].conv[0].in_channels for branch in model.head.cv2]
    store = [[torch.empty((bs, model.nf, g, g), dtype=dtype, device=dev)
              for g in levels] for _ in range(n_check)]
    fstore = [[torch.empty((bs, c, g, g), dtype=dtype, device=dev)
               for c, g in zip(feat_ch, levels)] for _ in range(n_check)]
    # the copies are the harness's, not the deployment's: left out of the
    # peak (the allocator rounds each block up to 512 bytes)
    copies_bytes = sum(-(-t.nbytes // 512) * 512
                       for slot in store + fstore for t in slot)
    capture = {"slot": None}

    def keep_heads(_mod, _inp, out):
        if capture["slot"] is not None:
            for buf, h in zip(store[capture["slot"]], out):
                buf.copy_(h)

    def keep_features(_mod, inp):
        if capture["slot"] is not None:
            for buf, f in zip(fstore[capture["slot"]], inp[0]):
                buf.copy_(f)
    model.register_forward_hook(keep_heads)
    model.head.register_forward_pre_hook(keep_features)

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
    kept = [int(v.sum(1).mean()) for _, _, v in checked]
    record = {"kind": "detect", "window_s": window_s, "batches": n,
              "images": n * bs,
              "forward_ms": [m[0] for m in stage_ms],
              "post_ms": [m[1] + m[2] for m in stage_ms],
              "batch_flops": batch_flops(cfg, bs, size),
              "peak_flops": peaks.FLOPS[str(dtype).replace("torch.", "")]}
    harness.log(f"window: {n} batches in {window_s:.3f} s, p95 "
                f"{harness.percentile(lat, 95) * 1e3:.3f} ms; kept an image "
                f"(sampled batches) {kept}; peak memory "
                f"{device['memory_peak_bytes']} B without the harness's "
                f"{copies_bytes} B of copies; {harness.smi()}")
    trace = None
    if ctx.trace:
        trace = _traced(ctx, pp, one, host, traffic["trace_batches"], record)
        record["trace"] = trace
    anchor_detect._log_launches()
    e2e = {"detect_img_s": n * bs / window_s,
           "detect_p95_ms": harness.percentile(lat, 95) * 1e3}

    del model, det
    if cuda:
        torch.cuda.empty_cache()
    ctx.after_window()

    t = time.perf_counter()
    ref_obb.float32_math()
    if cuda:
        torch.backends.cudnn.benchmark = False
    ref = _reference(cfg, dev)
    ref.load_state_dict(state)
    ref8 = _fp8_copy(ref) if ctx.control else None
    # nothing checked is no pass
    share = head_gap = float("inf") if not checked else 0.0
    gap = fgap = chan = 0.0
    faults = {}
    with torch.no_grad():
        for slot, (j, dets, valid) in enumerate(checked):
            x = torch.from_numpy(host[j]).to(dev).permute(0, 3, 1, 2)
            x = x.float() / 255.0
            wfeat = ref.features(x)
            want = ref.head(wfeat)
            # the feature stage: the port's features, or in the control
            # the reference's own in float8
            feats = ref8.features(x) if ctx.control else fstore[slot]
            gaps = compare.channel_gaps(feats, wfeat)
            share = max(share, float((gaps > compare.CHANNEL_OFF).double()
                                     .mean(1).max()))
            chan = max(chan, float(gaps.mean(1).max()))
            gap = max(gap, compare.rel_gap(store[slot], want))
            fgap = max(fgap, compare.rel_gap(fstore[slot], wfeat))
            # the head stage alone, on the port's own features: the port's
            # maps, or in the control the reference's head in float8
            pfeat = [f.float() for f in fstore[slot]]
            heads = ref8.head(pfeat) if ctx.control else store[slot]
            head_gap = max(head_gap, float(compare.head_gaps(
                heads, ref.head(pfeat)).max()))
            rows, cvalid, boxes = ref_obb.candidates(
                [h.float() for h in store[slot]], nc, conf)
            for k, v in compare.nms_faults(dets, valid, rows, cvalid, boxes,
                                           iou, pp.MAX_DET).items():
                faults[k] = faults.get(k, 0) + v
    harness.log(f"reference: {len(checked)} sampled batches in "
                f"{time.perf_counter() - t:.3f} s; neck features: share of "
                f"channels off by more than {compare.CHANNEL_OFF} {share!r}, "
                f"mean channel gap {chan!r}, gap {fgap!r}; head maps: gap "
                f"{gap!r} from the reference's forward, worst channel's gap "
                f"{head_gap!r} from the reference's head on the port's "
                f"features; NMS faults {faults}")
    limits = cfg["limits"]
    checks = {"channels_off": {"value": share,
                               "limit": limits["channels_off"]},
              "head_gap": {"value": head_gap, "limit": limits["head_gap"]},
              "nms_faults": {"value": sum(faults.values()),
                             "limit": limits["nms_faults"]}}
    return {"setup_end": setup_end, "e2e": e2e, "record": record,
            "attempted": n, "failed": failed, "checks": checks,
            "trace": trace, "device": device}
