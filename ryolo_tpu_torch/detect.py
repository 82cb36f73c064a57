"""Inference CLI: ``python -m ryolo_tpu_torch.detect``.

Port of the JAX ``detect.py`` (:34-203) with the same arguments plus
``--device`` (default ``cuda``; the CPU only when asked, and no fallback
when no card is found).  The ``.pth`` is deploy-fused
(:func:`ryolo_tpu_torch.nn.deploy.fuse_for_inference`), each batch runs
forward -> deferred decode (CSL: rows without theta; KFIoU and YOLO11's
OBB: scores alone) -> post-process with rotated NMS on the device, and a
background thread letterboxes the next batches meanwhile.
Decode and post-process stay float32 under ``--dtype bf16`` and ``int8``,
and run as the steps of ``eval/postprocess.py`` (:class:`_DecodePost`): on
a card replayed as CUDA graphs, captured at the first batch of each input
signature; on the CPU eagerly.  The model runs eagerly.
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
from ryolo_tpu_torch.eval.postprocess import (MAX_DET, MAX_NMS,
                                              candidate_count, compact,
                                              deferred_theta, nms_fields,
                                              nms_keep, select_rows,
                                              select_scores, tail_width)
from ryolo_tpu_torch.nn import STRIDES, Yolo, fuse_for_inference
from ryolo_tpu_torch.nn.heads import (decode_csl_defer, decode_kfiou_scores,
                                      decode_obb_scores, deferred_kfiou_box,
                                      deferred_obb_box)
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


class _Segment:
    """``fn(*args)``: eager without a graph memory pool; with one, a CUDA
    graph captured at the first call (after one eager run, as capture
    requires, on the side ``stream`` that then captures) and replayed at
    every call, which returns the capture's own output tensors.  A replay
    reads the tensors the first call passed: every call passes the same
    ones, refreshed in place."""

    def __init__(self, fn, pool=None, stream=None):
        self.fn, self.pool, self.stream = fn, pool, stream
        self.graph = self.out = None

    def __call__(self, *args):
        if self.pool is None:
            return self.fn(*args)
        if self.graph is None:
            current = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self.fn(*args)
            current.wait_stream(self.stream)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  stream=self.stream):
                self.out = self.fn(*args)
            trace.count("graph.capture")
        self.graph.replay()
        trace.count("graph.replay")
        return self.out


class _DecodePost:
    """The decode and post-process of one input signature (the head maps'
    shapes and dtype, the head, the thresholds) as segments between the
    points where the host acts: (a) the decode; (b) the class max, the
    selection and the candidate count, which the host reads to pick the
    width ``k``; (c_k) the top-k selection and the NMS's inputs; the NMS,
    eager, through ``eval.postprocess``; (d_k) the compaction.  The same
    steps as ``post_process_defer``, ``post_process_kfiou_defer`` and
    ``post_process_obb_defer``, which the evaluator calls.  The OBB head's
    deferred box decode resolves ``B * k`` rows a call, counted as
    ``obb.box_decode`` on the host from the shapes.

    Without a graph memory pool (the CPU) the segments run eagerly.  With
    one each segment is a CUDA graph (:class:`_Segment`): the head maps
    and the NMS's ``keep`` are copied into static buffers, and the NMS's
    inputs and the results are copied out of the graphs' own, so that they
    belong to the call."""

    def __init__(self, model, nc: int, conf_thres: float, iou_thres: float,
                 pool=None, stream=None):
        mode, na, anchors = model.mode, model.na, model.anchors
        csl = mode == "csl"
        self.obb = mode == "obb"
        self.iou_thres = iou_thres
        self.graphed = pool is not None
        self.segment = lambda fn: _Segment(fn, pool, stream)
        self.heads = None
        self.tails = {}  # k -> (c_k, d_k, keep buffer)

        def decode(heads):
            if csl:
                return decode_csl_defer(heads, anchors, STRIDES, nc)
            if self.obb:
                return decode_obb_scores(heads, nc)
            return decode_kfiou_scores(heads, na, nc)

        def select(dec):
            payload, sel = (select_rows if csl else select_scores)(
                dec, conf_thres)
            return payload, sel, candidate_count(sel)

        def fields(k, heads, payload, sel):
            if csl:
                return nms_fields(payload, sel, k, theta_fn=lambda idx:
                                  deferred_theta(heads, idx, na, nc))
            if self.obb:
                return nms_fields(payload, sel, k, box_fn=lambda idx:
                                  deferred_obb_box(heads, idx, nc, STRIDES))
            return nms_fields(payload, sel, k, box_fn=lambda idx:
                              deferred_kfiou_box(heads, idx, na, anchors,
                                                 STRIDES))

        self._decode, self._select = self.segment(decode), self.segment(select)
        self._fields = fields

    def decode(self, heads):
        if not self.graphed:
            self.heads = heads
        else:
            if self.heads is None:
                self.heads = [torch.empty_like(h) for h in heads]
            for buf, h in zip(self.heads, heads):
                buf.copy_(h)
        return self._decode(self.heads)

    def post_process(self, dec):
        payload, sel, count = self._select(dec)
        k = tail_width(sel, MAX_NMS, count)
        if k not in self.tails:
            keep = (torch.empty((sel.shape[0], k), dtype=torch.bool,
                                device=sel.device) if self.graphed else None)
            self.tails[k] = (
                self.segment(lambda *a: self._fields(k, *a)),
                self.segment(lambda rows, keep: compact(rows, keep, MAX_DET)),
                keep)
        fields, compact_k, keep_buf = self.tails[k]
        rows, boxes, scores, valid = fields(self.heads, payload, sel)
        if self.obb:
            trace.count("obb.box_decode", sel.shape[0] * k)
        if not self.graphed:
            return compact_k(rows, nms_keep(boxes, scores, valid,
                                            self.iou_thres, MAX_DET))
        keep = nms_keep(boxes.clone(), scores, valid.clone(), self.iou_thres,
                        MAX_DET)
        dets, valid = compact_k(rows, keep_buf.copy_(keep))
        return dets.clone(), valid.clone()


class Detect:
    def __init__(self, args):
        self.args = args
        self.total_s = 0.0  # the whole run's seconds, set by detect()
        # _DecodePost by input signature; on a card one graph memory pool
        # and one capture stream for all their graphs
        self._chains = {}
        self._pool = self._stream = None

    def _chain(self, model, heads, nc: int, device) -> _DecodePost:
        conf, iou = float(self.args.conf_thres), float(self.args.nms_thres)
        key = (model.mode, model.na, nc, conf, iou,
               tuple(np.asarray(a, np.float32).tobytes()
                     for a in model.anchors),
               tuple((h.shape, h.dtype, h.device) for h in heads))
        chain = self._chains.get(key)
        if chain is None:
            pool = stream = None
            if device.type == "cuda":
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                    self._stream = torch.cuda.Stream(device)
                pool, stream = self._pool, self._stream
            chain = self._chains[key] = _DecodePost(model, nc, conf, iou,
                                                    pool, stream)
        return chain

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
        """uint8 ``(B, S, S, 3)`` RGB batch -> ``(dets, valid)`` on device,
        tensors of this call's own.  ``stages`` marks forward (the
        conversion and the model), decode and post-process; the spans
        (:mod:`ryolo_tpu_torch.utils.trace`) split the upload, the
        conversion and the model apart.  The decode and the post-process
        run as :class:`_DecodePost`'s segments: on a card replaying the
        CUDA graphs of the batch's signature (captured at its first
        batch), on the CPU eagerly."""
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
            chain = self._chain(model, heads, nc, device)
            with trace.span("detect.decode", device):
                dec = chain.decode(heads)
            mark()
            with trace.span("detect.post_process", device):
                dets, valid = chain.post_process(dec)
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
                        choices=["csl", "kfiou", "obb"],
                        help="obb: YOLO11's anchor-free head, with --ver "
                             "yolo11 (f32 or bf16)")
    parser.add_argument("--ver", default="yolov5", nargs="?",
                        choices=["yolov4", "yolov5", "yolov7", "yolo11"])
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
