"""Visual spot-check that augmented images and rotated labels align:
``python -m ryolo_tpu_torch.display_inputs``.

Port of the JAX ``display_inputs.py`` (:1-51) with the same arguments:
``--n`` samples of the train split, augmented by the port's host loader
(:func:`ryolo_tpu_torch.data.loader.load_data`, batch 1, NHWC RGB in
[0, 1] as JAX's yields them), each drawn with its rotated labels' outlines
and written as ``outputs/display/<image name>`` under the current
directory.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

from ryolo_tpu_torch.data.datasets import xywha_to_polys_np
from ryolo_tpu_torch.data.loader import load_data
from ryolo_tpu_torch.utils.config import load_yaml


def main(args):
    config = load_yaml(args.config)
    data = load_yaml(args.data)
    _, loader = load_data(
        data["train"], data["names"], data["type"], config["hyp"], False,
        img_size=args.img_size, batch_size=1, augment=True,
    )
    out_dir = os.path.join("outputs", "display")
    os.makedirs(out_dir, exist_ok=True)

    for i, batch in enumerate(loader):
        if i >= args.n:
            break
        # RGB -> BGR for cv2
        img = (batch["images"][0, :, :, ::-1] * 255).astype(np.uint8).copy()
        tgt = batch["tgt"][0][batch["tgt_mask"][0]]
        if len(tgt):
            boxes = tgt[:, 1:6].copy()
            boxes[:, :4] *= img.shape[0]
            polys = xywha_to_polys_np(boxes).astype(np.intp)
            for poly in polys:
                cv2.drawContours(img, [poly], 0, (255, 0, 0), 1)
        name = os.path.basename(batch["paths"][0])
        cv2.imwrite(os.path.join(out_dir, name), img)
        print(f"wrote {name} with {len(tgt)} targets")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="configs/DOTA.yaml")
    parser.add_argument("--config", type=str, default="configs/hyp.yaml")
    parser.add_argument("--img_size", type=int, default=608)
    parser.add_argument("--n", type=int, default=8)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
