"""Inference CLI: ``python -m ryolo_tpu_torch.detect``.

Port of the JAX ``detect.py`` (:34-203) with the same arguments plus
``--device`` (default ``cuda``; the CPU only when asked, and no fallback
when no card is found).  The ``.pth`` is deploy-fused
(:func:`ryolo_tpu_torch.nn.deploy.fuse_for_inference`), each batch runs
forward -> deferred decode (CSL: rows without theta; KFIoU: scores alone)
-> post-process with rotated NMS on the device, and a background thread
letterboxes the next batches meanwhile.
Decode and post-process stay float32 under ``--dtype bf16`` and ``int8``.
``--dtype int8`` is the bf16 graph with its wide BN-backed convs and
RepConvs int8 x int8 -> int32 (per-output-channel weight scales, a dynamic
per-tensor activation scale over the whole batch), as the JAX ``detect.py``
(:64-69) builds it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ryolo_tpu_torch.data.datasets import ImageDataset
from ryolo_tpu_torch.eval.postprocess import (post_process_defer,
                                              post_process_kfiou_defer)
from ryolo_tpu_torch.nn import STRIDES, Yolo, fuse_for_inference
from ryolo_tpu_torch.nn.heads import decode_csl_defer, decode_kfiou_scores
from ryolo_tpu_torch.utils import trace
from ryolo_tpu_torch.utils.checkpoint import load_pth
from ryolo_tpu_torch.utils.config import load_yaml
from ryolo_tpu_torch.utils.device import (DTYPES, resolve_device,
                                          set_float32_math)
from ryolo_tpu_torch.utils.logger import logger
from ryolo_tpu_torch.utils.plot import plot_boxes

STAGES = ("forward", "decode", "post_process")


class _Stages:
    """Per-batch stage times: pooled CUDA events on the card
    (:func:`ryolo_tpu_torch.utils.trace.event`), the host clock on the CPU.
    Read after the batch's results reached the host; reading gives the
    events back to the pool."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self._ms = None

    def mark(self):
        self.marks.append(trace.event() if self.cuda
                          else time.perf_counter_ns())

    def elapsed_ms(self):
        if self._ms is None:
            m = self.marks
            if self.cuda:
                self._ms = [m[i].elapsed_time(m[i + 1])
                            for i in range(len(m) - 1)]
                trace.release(*m)
            else:
                self._ms = [(m[i + 1] - m[i]) * 1e-6
                            for i in range(len(m) - 1)]
        return self._ms


class Detect:
    def __init__(self, args):
        self.args = args
        self.total_s = 0.0  # the whole run's seconds, set by detect()

    def _build_model(self, nc: int, config, device: torch.device):
        args = self.args
        model = Yolo(nc, config["model"], mode=args.mode, ver=args.ver)
        model.load_state_dict(load_pth(args.weight_path), strict=True)
        logger.info(f"Loaded {len(model.state_dict())} tensors from "
                    f"{args.weight_path}")
        dtype = DTYPES[args.dtype]
        if device.type == "cuda" and dtype == torch.float32:
            # cuDNN convolutions default to TF32; the f32 path is f32
            set_float32_math(device)
            logger.info("TF32 off: cudnn.allow_tf32=%s matmul.allow_tf32=%s"
                        % (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32))
        return fuse_for_inference(model, dtype=dtype, device=device,
                                  quantize=args.dtype == "int8"), dtype

    @torch.no_grad()
    def infer(self, model: Yolo, images: np.ndarray, dtype, device, nc: int,
              stages: _Stages):
        """uint8 ``(B, S, S, 3)`` RGB batch -> ``(dets, valid)`` on device.
        ``stages`` marks forward (the conversion and the model), decode and
        post-process; the spans (:mod:`ryolo_tpu_torch.utils.trace`) split
        the upload, the conversion and the model apart."""
        mark = stages.mark
        with trace.span("detect.infer", device):
            with trace.span("detect.upload", device):
                # a pageable copy: the host waits for the stream
                trace.count("sync.upload")
                x = torch.from_numpy(images).to(device)
            mark()
            with trace.span("detect.convert", device):
                x = (x.permute(0, 3, 1, 2).float() / 255.0).to(dtype)
            with trace.span("detect.model", device):
                heads = model(x)
            mark()
            conf, iou = float(self.args.conf_thres), float(self.args.nms_thres)
            csl = model.mode == "csl"
            with trace.span("detect.decode", device):
                dec = (decode_csl_defer(heads, model.anchors, STRIDES, nc)
                       if csl else decode_kfiou_scores(heads, model.na, nc))
            mark()
            with trace.span("detect.post_process", device):
                if csl:
                    dets, valid = post_process_defer(dec, heads, model.na,
                                                     nc, conf, iou)
                else:
                    dets, valid = post_process_kfiou_defer(
                        dec, heads, model.na, model.anchors, STRIDES, conf,
                        iou)
            mark()
        return dets, valid

    @staticmethod
    def fetch(dets: torch.Tensor, valid: torch.Tensor):
        """``infer``'s ``(dets, valid)`` as numpy arrays on the host: two
        blocking copies (``sync.fetch``)."""
        trace.count("sync.fetch", 2)
        return dets.cpu().numpy(), valid.cpu().numpy()

    def detect(self):
        """Run the CLI; returns ``[(path, (n, 7) detections)]``."""
        args = self.args
        device = resolve_device(args.device)
        data = load_yaml(args.data)
        config = load_yaml(args.hyp)
        nc = len(data["names"])

        dataset = ImageDataset(data["test"], img_size=args.img_size,
                               ext=args.ext)
        if not len(dataset):
            logger.error(f"No .{args.ext} images found under {data['test']}")
            sys.exit(1)
        if not os.path.isfile(args.weight_path):
            logger.error("Model weight not found.")
            sys.exit(1)
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True  # fixed input shape
        model, dtype = self._build_model(nc, config, device)

        save_folder = os.path.join("outputs", "inference")
        os.makedirs(save_folder, exist_ok=True)
        bs = args.batch_size

        def load_batch(i):
            items = [dataset[j] for j in range(i, min(i + bs, len(dataset)))]
            return [p for p, _ in items], np.stack([im for _, im in items])

        results = []
        start = time.time()
        starts = list(range(0, len(dataset), bs))
        with ThreadPoolExecutor(max_workers=2) as pool:
            # bounded prefetch: at most DEPTH letterboxed batches in flight
            DEPTH = 2

            def batches():
                pending = [pool.submit(load_batch, s) for s in starts[:DEPTH]]
                nxt = DEPTH
                while pending:
                    fut = pending.pop(0)
                    if nxt < len(starts):
                        pending.append(pool.submit(load_batch, starts[nxt]))
                        nxt += 1
                    yield fut.result()

            for paths, images in batches():
                stages = _Stages(device)
                dets, valid = self.fetch(*self.infer(model, images, dtype,
                                                     device, nc, stages))
                ms = dict(zip(STAGES, stages.elapsed_ms()))

                boxes = [dets[b][valid[b]] for b in range(len(paths))]
                num = sum(len(b) for b in boxes)
                logger.info("-----------------------------------")
                logger.info("{}-> {} objects found".format(paths, num))
                logger.info("Inference time : " + "%10.4g"
                            % round((ms["forward"] + ms["decode"]) / 1e3, 5))
                logger.info("Post-processing time : " + "%10.4g"
                            % round(ms["post_process"] / 1e3, 5))
                logger.info("-----------------------------------")

                for path, box in zip(paths, boxes):
                    plot_boxes(path, box, data["names"], args.img_size,
                               save_folder)
                    results.append((path, box))

        self.total_s = time.time() - start
        logger.info("-----------------------------------")
        logger.info("Total detecting time : " + "%10.4g"
                    % round(self.total_s, 5))
        logger.info("-----------------------------------")
        return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--weight_path", type=str, default="")
    parser.add_argument("--mode", default="csl", nargs="?",
                        choices=["csl", "kfiou"])
    parser.add_argument("--ver", default="yolov5", nargs="?",
                        choices=["yolov4", "yolov5", "yolov7"])
    parser.add_argument("--conf_thres", type=float, default=0.7)
    parser.add_argument("--nms_thres", type=float, default=0.2)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--img_size", type=int, default=608)
    parser.add_argument("--data", type=str, default="")
    parser.add_argument("--hyp", type=str, default="")
    parser.add_argument("--ext", type=str, default="png",
                        choices=["png", "jpg"])
    parser.add_argument("--dtype", default="f32",
                        choices=["f32", "bf16", "int8"],
                        help="deployed compute dtype (decode stays f32; "
                             "int8: bf16 with the wide convs int8)")
    parser.add_argument("--packed_input", action="store_true",
                        help="accepted for the JAX CLI's surface; the S2D "
                             "input packing is a TPU layout trick and is "
                             "ignored here")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args)
    Detect(args).detect()
