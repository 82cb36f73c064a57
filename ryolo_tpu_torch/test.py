"""Evaluation CLI: ``python -m ryolo_tpu_torch.test``.

Port of the JAX ``test.py`` (:27-97) with the same arguments plus
``--device`` (default ``cuda``; the CPU only when asked, and no fallback
when no card is found): the rotated mAP@.5:.95 protocol with the val loss
on the val split of a dataset yaml, through the deploy-fused model
(:func:`ryolo_tpu_torch.eval.evaluator.evaluate`).  ``--ver yolo11 --mode
obb`` (YOLO11's OBB head) has no loss in the port yet: its val loss is not
reported.  ``--dtype int8`` is the
bf16 graph with the wide convs int8 (JAX ``test.py:62-66``); the dynamic
activation scale spans the whole batch, the zero-padded rows of a short
final batch included, as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ryolo_tpu_torch.eval.evaluator import evaluate
from ryolo_tpu_torch.nn import Yolo, fuse_for_inference
from ryolo_tpu_torch.train.trainer import LOSS_FNS
from ryolo_tpu_torch.utils.checkpoint import load_pth
from ryolo_tpu_torch.utils.config import load_yaml
from ryolo_tpu_torch.utils.device import (DTYPES, resolve_device,
                                          set_float32_math)
from ryolo_tpu_torch.utils.logger import logger


class Test:
    def __init__(self, args):
        self.args = args

    def run(self):
        """Returns ``evaluate``'s ``(mp, mr, map50, map50_95, loss
        items)``."""
        args = self.args
        device = resolve_device(args.device)
        config = load_yaml(args.hyp)
        model_cfg, hyp_cfg = config["model"], config["hyp"]
        data = load_yaml(args.data)
        nc = len(data["names"])

        if not os.path.isfile(args.weight_path):
            logger.error("Model weight not found.")
            sys.exit(1)

        model = Yolo(nc, model_cfg, mode=args.mode, ver=args.ver)
        model.load_state_dict(load_pth(args.weight_path), strict=True)
        logger.info(f"Loaded {len(model.state_dict())} tensors from "
                    f"{args.weight_path}")
        loss_fn = (None if args.mode == "obb" else
                   LOSS_FNS[args.mode](model.anchors, nc, hyp_cfg, device))
        if DTYPES[args.dtype] == torch.float32:
            set_float32_math(device)
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True  # fixed input shape
        # deploy-fused inference graph (BN fold + RepConv merge)
        model = fuse_for_inference(model, dtype=DTYPES[args.dtype],
                                   device=device,
                                   quantize=args.dtype == "int8")
        return evaluate(model, loss_fn, data, hyp_cfg, args.mode == "csl",
                        args.img_size, args.batch_size, args.conf_thres,
                        args.iou_thres, max_targets=args.max_targets,
                        device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--weight_path", type=str, default="")
    parser.add_argument("--mode", default="csl", nargs="?",
                        choices=["csl", "kfiou", "obb"],
                        help="obb: YOLO11's anchor-free head, with --ver "
                             "yolo11 (f32 or bf16; no val loss)")
    parser.add_argument("--ver", default="yolov5", nargs="?",
                        choices=["yolov4", "yolov5", "yolov7", "yolo11"])
    parser.add_argument("--conf_thres", type=float, default=0.001)
    parser.add_argument("--iou_thres", type=float, default=0.65)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--img_size", type=int, default=608)
    parser.add_argument("--data", type=str, default="")
    parser.add_argument("--hyp", type=str, default="")
    parser.add_argument("--max_targets", type=int, default=300)
    parser.add_argument("--dtype", default="f32",
                        choices=["f32", "bf16", "int8"],
                        help="deployed compute dtype (decode and the val "
                             "loss stay f32; int8: bf16 with the wide convs "
                             "int8)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args)
    Test(args).run()
