"""Device time of YOLO11l-OBB's deploy-fused forward by kind of layer, on a
card.

    python3 scripts/torch_obb_profile.py [--dtype bf16] [--batch 8]
        [--size 1024] [--iters 5] [--layout infer|nchw]

Builds ``Yolo(15, {}, mode="obb", ver="yolo11")`` with ``chip_smoke.py``'s
``init_weights``, fuses it (``fuse_for_inference``), runs cuDNN's search on
a batch laid out as ``Detect.infer`` lays it out (``--layout infer``: the
uint8 NHWC batch permuted, so channels_last strides) or contiguous NCHW
(``--layout nchw``), then queues each timed forward behind a sleep
kernel, so that the card runs it back to back without waiting for the
host.  CUDA events
before and after every convolution (with its activation), every attention
and the head give their device times.  Prints, a batch (the median of
``--iters``), the ms and the share of the forward of: depthwise 3x3
convolutions; other 3x3 convolutions up to 64 channels out, and wider; 1x1
convolutions; the attention's matmuls and softmax (its own time less its
convolutions'); the rest (residual adds, concats, chunks, pools,
upsampling); and, across those, the head's three branches and the PSA
blocks; each with its operations and their rate against the card's dense
peak in the dtype.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PEAK = {"bf16": 989e12, "f32": 67e12}
# ~0.2 s at 1.98 GHz: longer than the host takes to launch a forward
SLEEP_CYCLES = 400_000_000


def _convs(model):
    """``{name: (module, its conv)}``: every ConvBlock, and every bare
    ``nn.Conv2d`` outside one (the head's last convs)."""
    from ryolo_tpu_torch.nn.blocks import ConvBlock

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, ConvBlock):
            out[name] = (mod, mod.conv[0])
        elif isinstance(mod, torch.nn.Conv2d) and \
                not name.endswith(".conv.0"):
            out[name] = (mod, mod)
    return out


def _kind(conv):
    if conv.groups > 1 and conv.groups == conv.in_channels:
        return "depthwise 3x3"
    if conv.kernel_size == (1, 1):
        return "1x1"
    return "3x3, <= 64 out" if conv.out_channels <= 64 else "3x3, > 64 out"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", default="bf16", choices=sorted(PEAK))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--layout", default="infer", choices=["infer", "nchw"])
    args = p.parse_args(argv)

    from chip_smoke import init_weights
    from ryolo_tpu_torch.nn import Yolo, fuse_for_inference
    from ryolo_tpu_torch.nn.blocks import Attention
    from ryolo_tpu_torch.utils.device import DTYPES, set_float32_math

    dev = torch.device("cuda")
    dtype = DTYPES[args.dtype]
    if dtype == torch.float32:
        set_float32_math(dev)
    torch.backends.cudnn.benchmark = True
    model = Yolo(15, {}, mode="obb", ver="yolo11")
    init_weights(model, torch.Generator().manual_seed(0))
    model = fuse_for_inference(model.eval(), dtype=dtype, device=dev)
    x = torch.randint(0, 256, (args.batch, args.size, args.size, 3),
                      dtype=torch.uint8, device=dev)
    x = (x.permute(0, 3, 1, 2).float() / 255.0).to(dtype)
    if args.layout == "nchw":
        x = x.contiguous()

    marks, flops = {}, {}
    convs = _convs(model)
    attns = {n: m for n, m in model.named_modules()
             if isinstance(m, Attention)}

    def hook(name, mod):
        def pre(_m, inp):
            if isinstance(mod, Attention):
                b, _, h, w = inp[0].shape
                flops[name] = 2 * b * mod.num_heads * (h * w) ** 2 * (
                    mod.key_dim + mod.head_dim)
            marks[name] = [torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)]
            marks[name][0].record()

        def post(_m, _i, out):
            marks[name][1].record()
            if name in convs:
                c = convs[name][1]
                kh, kw = c.kernel_size
                flops[name] = 2 * out.numel() * c.in_channels // c.groups \
                    * kh * kw
        mod.register_forward_pre_hook(pre)
        mod.register_forward_hook(post)

    for name, (mod, _) in convs.items():
        hook(name, mod)
    for name, mod in attns.items():
        hook(name, mod)
    for name in ("head", "backbone.b10.m"):
        hook(name, model.get_submodule(name))

    runs = []
    with torch.no_grad():
        for i in range(args.iters + 2):  # two to warm up
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(x)
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                runs.append((start.elapsed_time(end),
                             {k: a.elapsed_time(b)
                              for k, (a, b) in marks.items()}))

    total = statistics.median(r[0] for r in runs)

    def ms(keys):
        return statistics.median(sum(r[1][k] for k in keys) for r in runs)
    groups = {}
    for name, (_, conv) in convs.items():
        groups.setdefault(_kind(conv), []).append(name)
    rows = [(g, ms(keys), sum(flops[k] for k in keys))
            for g, keys in sorted(groups.items())]
    own = [f"{a}.{c}" for a in attns for c in ("qkv", "proj", "pe")]
    core = ms(list(attns)) - ms(own)
    rows.append(("attention matmuls + softmax", core,
                 sum(flops[a] for a in attns)))
    rows.append(("rest (adds, concats, chunks, pools, upsampling)",
                 total - sum(r[1] for r in rows), 0))
    rows.append(("of which: the head's branches", ms(["head"]),
                 sum(flops[k] for k in convs if k.startswith("head."))))
    rows.append(("of which: the PSA blocks", ms(["backbone.b10.m"]),
                 sum(flops[k] for k in list(convs) + list(attns)
                     if k.startswith("backbone.b10.m."))))
    print(f"{torch.cuda.get_device_name(dev)}; YOLO11l-OBB fused "
          f"{args.dtype}, batch {args.batch} at {args.size} px, input "
          f"layout {args.layout}: forward "
          f"{total:.3f} ms a batch on the device (median of {args.iters}); "
          f"{len(convs)} convolutions")
    print(f"{'group':48s} {'ms':>8s} {'share':>7s} {'GFLOP':>9s} "
          f"{'TFLOP/s':>8s} {'of peak':>8s}")
    for g, t, f in rows:
        rate = f / (t * 1e-3) if t > 0 else 0.0
        print(f"{g:48s} {t:8.3f} {100 * t / total:6.1f}% {f / 1e9:9.1f} "
              f"{rate / 1e12:8.1f} {100 * rate / PEAK[args.dtype]:7.1f}%")


if __name__ == "__main__":
    main()
