"""The training targets worked out again from the split's annotation files
and the spec batch's own geometry, to hold the loader's label stage by
itself.

A spec batch places, for each output image ``b`` (and its mixup partner
``mix_idx[b]``), up to nine bank rows on a canvas: row ``tile_idx[k]``'s
tile-local point ``p`` lies at ``p + offset[k]``, and counts where it falls
inside ``region[k]``; ``minv`` maps an output pixel back to the canvas.
A target is an annotated polygon of a placed tile whose centre lies
strictly inside its region and, once carried to the output, strictly
inside the image; then flipped with the image, as ``[cls, x, y, w, h,
theta]`` (normalised, the long side ``h``) with its 180-bin CSL window.
The polygon conversion and the window are frozen copies of
``ryolo_tpu_torch/data/datasets.py`` ``polys_to_xywha_np`` and
``ryolo_tpu_torch/geometry.py`` ``csl_gaussian_labels_np`` at commit
d329eff; the rest follows the spec's contract, not the loader's code.
"""

from __future__ import annotations

import struct
from typing import Dict, Sequence

import numpy as np

# a target matches a candidate within these (normalised x, y, w, h; rad)
TOL = (1e-4, 1e-4, 1e-4, 1e-4, 1e-3)
# a candidate whose centre lies this close (px) to a filter's edge may be
# in the targets or not: float32 and float64 part at the edge
EDGE_PX = 1e-2


def polys_to_xywha(polys: np.ndarray) -> np.ndarray:
    """``(N, 8)`` corner polygons -> ``(N, 5)`` ``[x, y, w, h, theta]``
    (long side h, theta in [-pi/2, pi/2))."""
    x1, y1, x2, y2, x3, y3, x4, y4 = [polys[:, i] for i in range(8)]
    x = (x1 + x2 + x3 + x4) / 4
    y = (y1 + y2 + y3 + y4) / 4
    w = (np.hypot(x2 - x3, y2 - y3) + np.hypot(x1 - x4, y1 - y4)) / 2
    h = (np.hypot(x1 - x2, y1 - y2) + np.hypot(x4 - x3, y4 - y3)) / 2
    theta = -(np.arctan2(y1 - y2, x1 - x2) + np.arctan2(y4 - y3, x4 - x3)) / 2
    swap = w >= h
    w2 = np.where(swap, h, w)
    h2 = np.where(swap, w, h)
    theta = np.where(swap, np.where(theta > 0, theta - np.pi / 2,
                                    theta + np.pi / 2), theta)
    theta = np.where(theta >= np.pi / 2, theta - np.pi, theta)
    theta = np.where(theta < -np.pi / 2, theta + np.pi, theta)
    return np.stack([x, y, w2, h2, theta], -1)


def csl_window(theta_deg_plus90: np.ndarray, num_bins: int = 180,
               sig: float = 6.0) -> np.ndarray:
    """Gaussian window of std ``sig`` rolled onto the truncated integer
    bin of ``theta * 180/pi + 90``; ``(..., num_bins)`` float32."""
    theta_deg_plus90 = np.asarray(theta_deg_plus90, dtype=np.float64)
    x = np.arange(-num_bins / 2, num_bins / 2, dtype=np.float64)
    y_sig = np.exp(-(x ** 2) / (2 * sig ** 2))
    index = np.trunc(num_bins / 2 - theta_deg_plus90).astype(np.int64)
    j = np.arange(num_bins)
    return y_sig[np.mod(j + index[..., None], num_bins)].astype(np.float32)


def _png_size(path: str):
    """``(h, w)`` from a PNG's header."""
    with open(path, "rb") as f:
        w, h = struct.unpack(">II", f.read(24)[16:24])
    return h, w


class Annotations:
    """Each split entry's annotated polygons, in the pixels of its bank
    tile (resized as the bank resizes: the long side to ``img_size``)."""

    def __init__(self, img_files: Sequence[str], names: Sequence[str],
                 img_size: int):
        self.files, self.size = list(img_files), img_size
        self.category = {n.replace(" ", "-"): i for i, n in enumerate(names)}
        self._cache: Dict[int, tuple] = {}

    def __call__(self, row: int):
        if row not in self._cache:
            path = self.files[row]
            h0, w0 = _png_size(path)
            r = self.size / max(h0, w0)
            h, w = (int(h0 * r), int(w0 * r)) if r != 1 else (h0, w0)
            ann = path.replace("images", "annfiles").replace(".png", ".txt")
            polys, cls = [], []
            with open(ann) as f:
                for line in f:
                    parts = line.split(" ")
                    if len(parts) < 9:
                        continue
                    polys.append([float(v) for v in parts[:8]])
                    cls.append(self.category[parts[8].strip()])
            p = np.asarray(polys, np.float64).reshape(-1, 8)
            p[:, 0::2] *= w / w0
            p[:, 1::2] *= h / h0
            self._cache[row] = (p, np.asarray(cls, np.float64))
        return self._cache[row]


def _slot_candidates(batch: dict, slot: int, ann: Annotations, s: int):
    """Polygons (output pixels) of one spec slot, with each one's class
    and whether its centre lies clear of every filter's edge."""
    a = np.asarray(batch["spec_minv"][slot], np.float64)
    inv = np.linalg.inv(a[:, :2])
    polys, cls, clear = [], [], []
    for k in range(batch["spec_region"].shape[1]):
        x1, y1, x2, y2 = np.asarray(batch["spec_region"][slot, k], np.float64)
        if x2 <= x1 or y2 <= y1:
            continue
        p, c = ann(int(batch["spec_tile_idx"][slot, k]))
        if not len(p):
            continue
        canvas = p.reshape(-1, 4, 2) + np.asarray(batch["spec_offset"][slot, k],
                                                  np.float64)
        cx, cy = canvas[..., 0].mean(1), canvas[..., 1].mean(1)
        d = np.minimum.reduce([cx - x1, x2 - cx, cy - y1, y2 - cy])
        out = (canvas - a[:, 2]) @ inv.T
        ox, oy = out[..., 0].mean(1), out[..., 1].mean(1)
        e = np.minimum.reduce([ox, s - ox, oy, s - oy])
        keep = (d > -EDGE_PX) & (e > -EDGE_PX)
        polys.append(out[keep].reshape(-1, 8))
        cls.append(c[keep])
        clear.append(np.minimum(d, e)[keep] > EDGE_PX)
    if not polys:
        return np.zeros((0, 8)), np.zeros(0), np.zeros(0, bool)
    return np.concatenate(polys), np.concatenate(cls), np.concatenate(clear)


def _same_box(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``(G, W)``: rows that are the same rotated box (either side taken
    as the long one where the sides are near equal)."""
    tol = np.asarray(TOL)
    d = np.abs(got[:, None, :4] - want[None, :, :4])
    dt = np.abs(got[:, None, 4] - want[None, :, 4])
    dt = np.minimum(dt, np.pi - dt)
    same = (d <= tol[:4]).all(-1) & (dt <= tol[4])
    swapped = got[:, [0, 1, 3, 2]]
    d2 = np.abs(swapped[:, None] - want[None, :, :4])
    dt2 = np.abs(np.abs(got[:, None, 4] - want[None, :, 4]) - np.pi / 2)
    return same | ((d2 <= tol[:4]).all(-1) & (dt2 <= tol[4]))


def target_faults(batch: dict, ann: Annotations, s: int) -> Dict[str, int]:
    """A spec batch's targets held to the annotations that its geometry
    places.  Counts: ``rows_off``, targets that are no placed annotation
    of their image (class, box); ``missed``, placed annotations clear of
    every edge that are no target (while the image's target rows are not
    full); ``csl_off``, targets whose CSL window is not their angle's."""
    out = dict(rows_off=0, missed=0, csl_off=0)
    tgt, mask, csl = batch["tgt"], batch["tgt_mask"], batch["tgt_csl"]
    for b in range(len(tgt)):
        slots = [b] + ([int(batch["spec_mix_idx"][b])]
                       if batch["spec_mix_idx"][b] >= 0 else [])
        parts = [_slot_candidates(batch, j, ann, s) for j in slots]
        polys = np.concatenate([p for p, _, _ in parts]) / s
        cls = np.concatenate([c for _, c, _ in parts])
        clear = np.concatenate([k for _, _, k in parts])
        flip_lr, flip_ud = batch["spec_flip"][b]
        if flip_lr:
            polys[:, 0::2] = 1.0 - polys[:, 0::2]
        if flip_ud:
            polys[:, 1::2] = 1.0 - polys[:, 1::2]
        want = polys_to_xywha(polys)
        got = np.asarray(tgt[b][mask[b]], np.float64)
        same = _same_box(got[:, 1:], want) & (got[:, :1] == cls[None])
        out["rows_off"] += int((~same.any(1)).sum())
        if mask[b].sum() < mask.shape[1]:
            out["missed"] += int((clear & ~same.any(0)).sum())
        theta = np.asarray(tgt[b][mask[b]][:, 5], np.float32)
        window = csl_window(theta * 180 / np.pi + 90)
        out["csl_off"] += int((~(window == csl[b][mask[b]]).all(1)).sum())
    return out

