"""Dataset parsers and the per-sample pipeline, on the host (numpy/cv2).

Copy of ``ryolo_tpu/data/datasets.py`` (which reaches jax through
``ryolo_tpu.geometry``): ``pack_tile_u32`` :43 (here :func:`pack_tile_i32`),
``polys_to_xywha_np`` :54, ``xywha_to_polys_np`` :72, ``mosaic4_spans``
:101, ``mosaic9_box`` :115, ``ImageDataset`` :152, ``BaseDataset`` :176
(host ``get_sample`` :367 and the device-augmentation ``get_render_spec``
:549), ``DOTADataset`` :670, ``UCASAODDataset`` :702, ``CustomDataset``
:729.  The rng draws run in the same order, so for the same
``np.random.Generator`` the render specs and labels are byte-identical to
the JAX package's (``tests/test_torch_data.py``).

Packed tile words (``R | G<<8 | B<<16``, and the paste's owner id in the
top byte) are carried as int32: they fit in 28 bits, and PyTorch's uint32
shifts and masks are partial.
"""

from __future__ import annotations

import glob
import math
import os
from typing import List, Optional

import cv2
import numpy as np

from ryolo_tpu_torch.data.augment import (filter_by_center, horizontal_flip,
                                          hsv_augment, mixup,
                                          normalize_targets, pad_to_square,
                                          random_warping, vertical_flip)
from ryolo_tpu_torch.geometry import csl_gaussian_labels_np

PAD_VALUE = (114, 114, 114)
MAX_TILES = 9  # spec slots: mosaic-9 is the widest layout


def pack_tile_i32(img_bgr: np.ndarray) -> np.ndarray:
    """(h, w, 3) BGR uint8 -> (w, h) int32 packed RGB, x-major: word
    ``R | G<<8 | B<<16`` at ``[x, y]`` for pixel (row y, column x)."""
    rgb = img_bgr[:, :, ::-1].astype(np.int32)
    return (rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16)).T


def polys_to_xywha_np(polys: np.ndarray) -> np.ndarray:
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


def xywha_to_polys_np(boxes: np.ndarray) -> np.ndarray:
    """``(N, 5)`` ``[x, y, w, h, theta]`` -> corners ``(N, 4, 2)``."""
    x, y, w, h, t = [boxes[:, i] for i in range(5)]
    c, s = np.cos(t), np.sin(t)
    dx = np.stack([-h, h, h, -h], -1) / 2
    dy = np.stack([-w, -w, w, w], -1) / 2
    px = x[:, None] + c[:, None] * dx + s[:, None] * dy
    py = y[:, None] - s[:, None] * dx + c[:, None] * dy
    return np.stack([px, py], -1)


def _anchored_span(anchor: int, extent: int, limit: int, forward: bool):
    """1-D placement of an image side of length ``extent`` anchored at
    ``anchor``, growing forward or backward, clipped to ``[0, limit]``.
    Returns the canvas span and the matching source span ``(c1, c2, s1,
    s2)``."""
    if forward:
        c1, c2 = anchor, min(anchor + extent, limit)
        s1, s2 = 0, c2 - c1
    else:
        c1, c2 = max(anchor - extent, 0), anchor
        s1, s2 = extent - (c2 - c1), extent
    return c1, c2, s1, s2


def mosaic4_spans(i: int, xc: int, yc: int, w: int, h: int, s: int):
    """Quadrant placement of tile ``i`` of the 4-mosaic: right of the
    centre ``(xc, yc)`` if ``i & 1``, below it if ``i >> 1``."""
    x = _anchored_span(xc, w, 2 * s, forward=bool(i & 1))
    y = _anchored_span(yc, h, 2 * s, forward=bool(i >> 1))
    return x, y


def mosaic9_box(i: int, size, base, prev, s: int):
    """Unclipped canvas box of tile ``i`` of the 9-mosaic ring: the first
    tile at ``[s, s]``, the other eight clockwise around it (top, top-right,
    right, bottom-right, bottom, bottom-left, left, top-left).  ``size``,
    ``base`` and ``prev`` are the ``(w, h)`` of this, the centre and the
    previous tile."""
    w, h = size
    w0, h0 = base
    wp, hp = prev
    left = top = s
    right, bottom = s + w0, s + h0
    anchor_x, anchor_y, grow_x, grow_y = [
        (left, top, 1, 1),            # 0: center
        (left, top, 1, -1),           # 1: top, on the upper edge
        (left + wp, top, 1, -1),      # 2: top-right, shifted past tile 1
        (right, top, 1, 1),           # 3: right, on the right edge
        (right, top + hp, 1, 1),      # 4: bottom-right, below tile 3
        (right, bottom, -1, 1),       # 5: bottom, under the lower edge
        (right - wp, bottom, -1, 1),  # 6: bottom-left, past tile 5
        (left, bottom, -1, -1),       # 7: left, on the left edge
        (left, bottom - hp, -1, -1),  # 8: top-left, above tile 7
    ][i]
    x1 = anchor_x if grow_x > 0 else anchor_x - w
    y1 = anchor_y if grow_y > 0 else anchor_y - h
    return x1, y1, x1 + w, y1 + h


class ImageDataset:
    """Label-free image folder for detect: letterboxed RGB uint8
    ``(S, S, 3)`` (the JAX package's ``image_uint8=True``; the device
    divides by 255 in float32)."""

    def __init__(self, folder_path: str, img_size: int = 416, ext: str = "png"):
        self.files = sorted(glob.glob(os.path.join(folder_path, f"*.{ext}")))
        self.img_size = img_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        path = self.files[index % len(self.files)]
        img = cv2.imread(path)
        img, _ = pad_to_square(img, (self.img_size, self.img_size), PAD_VALUE)
        return path, np.ascontiguousarray(img[:, :, ::-1])


class BaseDataset:
    """Shared mosaic / letterbox / augment / label pipeline.

    :meth:`get_sample` renders a sample on the host (float32 RGB in [0, 1]);
    :meth:`get_render_spec` draws the same rng sequence but leaves every
    pixel to :mod:`ryolo_tpu_torch.data.device_augment`.
    """

    def __init__(self, hyp, img_size: int, augment: bool, csl: bool,
                 normalized_labels: bool, cache_images: bool = False):
        self.hyp = hyp
        self.img_size = img_size
        self.augment = augment
        self.csl = csl
        self.normalized_labels = normalized_labels
        self.mosaic_border = [-img_size // 2, -img_size // 2]
        self.img_files: List[str] = []
        self.label_files: List[str] = []
        # decoded+resized BGR images; with device augmentation the decode is
        # the only host pixel work left
        self.cache_images = cache_images
        self._img_cache: dict = {}
        # (h0, w0), (h, w) per index once build_tile_bank ran
        self._bank_sizes: dict = {}

    def load_files(self, label_path: str):
        """Return ``(polys (N, 8) float32 pixels-or-normalized, labels (N,))``."""
        raise NotImplementedError

    def __len__(self):
        return len(self.img_files)

    def _load_resized(self, index: int):
        """imread + resize to at most img_size, optionally cached.  Returns
        ``(img_bgr_u8, (h0, w0), (h, w))``."""
        cached = self._img_cache.get(index)
        if cached is not None:
            img, size0, size = cached
            return img.copy(), size0, size
        img = cv2.imread(self.img_files[index])
        h, w = img.shape[:2]
        if img.ndim != 3 or img.shape[2] != 3:
            img = np.stack([img, img, img], -1).reshape(h, w, 3)
        r = self.img_size / max(h, w)
        if r != 1:
            interp = (cv2.INTER_AREA if (r < 1 and not self.augment)
                      else cv2.INTER_LINEAR)
            img = cv2.resize(img, (int(w * r), int(h * r)),
                             interpolation=interp)
        if self.cache_images:
            self._img_cache[index] = (img, (h, w), img.shape[:2])
            return img.copy(), (h, w), img.shape[:2]
        return img, (h, w), img.shape[:2]

    def build_tile_bank(self) -> np.ndarray:
        """Decode and resize the whole dataset once -> ``(N, s, s)`` int32
        packed RGB x-major, content top-left: the tile layout of a pixel
        spec.  Uploaded once, it turns every batch's image traffic into
        ``(B, T)`` int32 bank rows (``device_cache``)."""
        s = self.img_size
        n = len(self.img_files)
        bank = np.zeros((n, s, s), np.int32)
        for i in range(n):
            img, size0, size = self._load_resized(i)
            h, w = size
            bank[i, :w, :h] = pack_tile_i32(img)
            self._bank_sizes[i] = (size0, size)
        return bank

    def _tile_meta(self, index: int, banked: bool):
        """``((h0, w0), (h, w))`` of the resized source (no pixel work once
        the bank is built)."""
        if banked:
            return self._bank_sizes[index]
        _, size0, size = self._load_resized(index)
        return size0, size

    def _draw_hsv_gains(self, rng: np.random.Generator) -> np.ndarray:
        """The rng draw of :func:`hsv_augment`, without applying it."""
        h, s, v = self.hyp["hsv_h"], self.hyp["hsv_s"], self.hyp["hsv_v"]
        if not (h or s or v):
            return np.ones(3)
        return 1.0 + rng.uniform(-1, 1, 3) * np.array([h, s, v])

    def load_image(self, index: int, rng: Optional[np.random.Generator]):
        """imread + resize + HSV jitter (when augmenting)."""
        img, size0, size = self._load_resized(index)
        if self.augment and rng is not None:
            hsv_augment(img, rng, self.hyp["hsv_h"], self.hyp["hsv_s"],
                        self.hyp["hsv_v"])
        return img, size0, size

    def load_target(self, index, pad, img_size0, img_size, border=None):
        """Polygon labels in padded-image pixels, ``(N, 9)`` ``[cls, x1..y4]``
        (the collate adds the batch-index column)."""
        label_path = self.label_files[index % len(self.img_files)].rstrip()
        if not os.path.exists(label_path):
            raise FileNotFoundError(f"Label file {label_path} not found")
        polys, labels = self.load_files(label_path)
        if not len(labels):
            return np.zeros((0, 9), np.float32)
        polys = polys.astype(np.float32).copy()
        if not self.normalized_labels:
            h0, w0 = img_size0
            polys[:, 0::2] /= w0
            polys[:, 1::2] /= h0
        h_, w_ = img_size
        polys[:, 0::2] *= w_
        polys[:, 1::2] *= h_
        targets = np.concatenate(
            [labels.astype(np.float32)[:, None], polys], -1)
        if border is not None:
            targets = filter_by_center(targets, border)
        targets[:, 1::2] += pad[1]
        targets[:, 2::2] += pad[0]
        return targets

    def load_mosaic(self, index, rng):
        """4-image mosaic on a 2s x 2s canvas (see :func:`mosaic4_spans`)."""
        s = self.img_size
        yc, xc = [int(rng.uniform(-x, 2 * s + x)) for x in self.mosaic_border]
        indices = [index] + list(rng.integers(0, len(self.img_files), 3))
        labels4 = []
        img4 = np.full((s * 2, s * 2, 3), 114, np.uint8)
        for i, idx in enumerate(indices):
            img, (h0, w0), (h, w) = self.load_image(idx, rng)
            (x1a, x2a, x1b, x2b), (y1a, y2a, y1b, y2b) = mosaic4_spans(
                i, xc, yc, w, h, s)
            img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            pad = (y1a - y1b, x1a - x1b)
            labels4.append(self.load_target(idx, pad, (h0, w0), (h, w),
                                            border=(x1b, x2b, y1b, y2b)))
        return img4, np.concatenate(labels4, 0)

    def load_mosaic9(self, index, rng):
        """9-image mosaic on a 3s x 3s canvas, cropped at random to 2s x 2s
        (see :func:`mosaic9_box`)."""
        s = self.img_size
        indices = [index] + list(rng.integers(0, len(self.img_files), 8))
        labels9 = []
        img9 = np.full((s * 3, s * 3, 3), 114, np.uint8)
        prev = base = (0, 0)
        for i, idx in enumerate(indices):
            img, (h0, w0), (h, w) = self.load_image(idx, rng)
            if i == 0:
                base = (w, h)
            x1, y1, x2, y2 = mosaic9_box(i, (w, h), base, prev, s)
            cx1, cy1 = max(x1, 0), max(y1, 0)
            img9[cy1:y2, cx1:x2] = img[cy1 - y1:, cx1 - x1:][: y2 - cy1,
                                                             : x2 - cx1]
            prev = (w, h)
            labels9.append(self.load_target(
                idx, (y1, x1), (h0, w0), (h, w),
                border=(cx1 - x1, w, cy1 - y1, h)))
        labels9 = np.concatenate(labels9, 0)
        yc, xc = [int(rng.uniform(0, s)) for _ in self.mosaic_border]
        img9 = img9[yc:yc + 2 * s, xc:xc + 2 * s]
        labels9 = filter_by_center(labels9, (xc, xc + 2 * s, yc, yc + 2 * s))
        if len(labels9):
            labels9[:, 1::2] -= xc
            labels9[:, 2::2] -= yc
        return img9, labels9

    def get_sample(self, index: int, rng: np.random.Generator):
        """One sample rendered on the host: ``(path, img_rgb_f32,
        labels (N, 187|7))``."""
        hyp = self.hyp
        if self.augment and rng.random() < hyp["mosaic"]:
            if rng.random() < 0.8:
                img, targets = self.load_mosaic(index, rng)
            else:
                img, targets = self.load_mosaic9(index, rng)
            img, targets = random_warping(img, targets, rng, hyp["rotate"],
                                          hyp["scale"], hyp["translate"],
                                          self.mosaic_border)
            if rng.random() < hyp["mixup"]:
                j = int(rng.integers(0, len(self.img_files)))
                if rng.random() < 0.8:
                    img2, targets2 = self.load_mosaic(j, rng)
                else:
                    img2, targets2 = self.load_mosaic9(j, rng)
                img2, targets2 = random_warping(img2, targets2, rng,
                                                hyp["rotate"], hyp["scale"],
                                                hyp["translate"],
                                                self.mosaic_border)
                img, targets = mixup(img, targets, img2, targets2, rng)
        else:
            img, (h0, w0), (h, w) = self.load_image(
                index, rng if self.augment else None)
            img, pad = pad_to_square(img, (self.img_size, self.img_size),
                                     PAD_VALUE)
            targets = self.load_target(index, pad, (h0, w0), (h, w))
            if self.augment:
                img, targets = random_warping(img, targets, rng,
                                              hyp["rotate"], hyp["scale"],
                                              hyp["translate"])

        targets = filter_by_center(targets, (0, img.shape[1], 0, img.shape[0]))
        targets = normalize_targets(targets, img.shape[:2])
        if self.augment and rng.random() < hyp["fliplr"]:
            img, targets = horizontal_flip(img, targets)
        if self.augment and rng.random() < hyp["flipud"]:
            img, targets = vertical_flip(img, targets)
        labels = self._finalize_labels(targets)
        img = np.ascontiguousarray(img[:, :, ::-1], dtype=np.float32) / 255.0
        return self.img_files[index], img, labels

    # -- device-side augmentation specs ------------------------------------

    def _warp_params(self, rng, canvas_hw, border):
        """The draws and matrices of :func:`random_warping`.  Returns
        ``(rot (2,2), shift (2,), center (2,), minv (2,3))``; ``minv`` maps
        output pixel coordinates back to canvas coordinates."""
        hyp = self.hyp
        height = canvas_hw[0] + border[0] * 2
        width = canvas_hw[1] + border[1] * 2
        theta = np.deg2rad(rng.uniform(-hyp["rotate"], hyp["rotate"]))
        sc = rng.uniform(1 - hyp["scale"], 1.1 + hyp["scale"])
        t = hyp["translate"]
        shift = np.array([rng.uniform(0.3 - t, 0.3 + t) * width,
                          rng.uniform(0.3 - t, 0.3 + t) * height])
        rot = sc * np.array([[np.cos(theta), np.sin(theta)],
                             [-np.sin(theta), np.cos(theta)]])
        center = np.array([canvas_hw[1], canvas_hw[0]]) / 2.0
        rinv = rot.T / (sc * sc)  # (s·R)^-1 = Rᵀ/s
        minv = np.concatenate(
            [rinv, (center - rinv @ shift)[:, None]], axis=1
        ).astype(np.float32)
        return rot, shift, center, minv

    def _warp_targets(self, targets, rot, shift, center):
        """Label side of :func:`random_warping` (same closed form)."""
        if len(targets):
            targets = targets.copy()
            pts = targets[:, 1:].reshape(-1, 4, 2)
            targets[:, 1:] = (pts @ rot.T + shift - rot @ center).reshape(-1, 8)
        return targets

    def _spec_mosaic(self, index, rng, use9: bool, banked: bool = False):
        """Tiles (or bank rows), regions, offsets, HSV gains and canvas-space
        labels of a mosaic draw."""
        s = self.img_size
        tiles = None if banked else np.zeros((MAX_TILES, s, s), np.int32)
        tile_idx = np.zeros((MAX_TILES,), np.int32)
        region = np.zeros((MAX_TILES, 4), np.float32)
        offset = np.zeros((MAX_TILES, 2), np.float32)
        hsv = np.ones((MAX_TILES, 3), np.float32)
        labels = []
        if not use9:
            yc, xc = [int(rng.uniform(-x, 2 * s + x))
                      for x in self.mosaic_border]
            indices = [index] + list(rng.integers(0, len(self.img_files), 3))
            for i, idx in enumerate(indices):
                if banked:
                    (h0, w0), (h, w) = self._tile_meta(idx, True)
                else:
                    img, (h0, w0), (h, w) = self._load_resized(idx)
                    tiles[i, :w, :h] = pack_tile_i32(img)
                hsv[i] = self._draw_hsv_gains(rng)
                tile_idx[i] = idx
                (x1a, x2a, x1b, x2b), (y1a, y2a, y1b, y2b) = mosaic4_spans(
                    i, xc, yc, w, h, s)
                region[i] = [x1a, y1a, x2a, y2a]
                offset[i] = [x1a - x1b, y1a - y1b]
                labels.append(self.load_target(
                    idx, (y1a - y1b, x1a - x1b), (h0, w0), (h, w),
                    border=(x1b, x2b, y1b, y2b)))
            targets = np.concatenate(labels, 0)
        else:
            indices = [index] + list(rng.integers(0, len(self.img_files), 8))
            prev = base = (0, 0)
            for i, idx in enumerate(indices):
                if banked:
                    (h0, w0), (h, w) = self._tile_meta(idx, True)
                else:
                    img, (h0, w0), (h, w) = self._load_resized(idx)
                    tiles[i, :w, :h] = pack_tile_i32(img)
                hsv[i] = self._draw_hsv_gains(rng)
                tile_idx[i] = idx
                if i == 0:
                    base = (w, h)
                x1, y1, x2, y2 = mosaic9_box(i, (w, h), base, prev, s)
                cx1, cy1 = max(x1, 0), max(y1, 0)
                region[i] = [cx1, cy1, x2, y2]
                offset[i] = [x1, y1]
                prev = (w, h)
                labels.append(self.load_target(
                    idx, (y1, x1), (h0, w0), (h, w),
                    border=(cx1 - x1, w, cy1 - y1, h)))
            targets = np.concatenate(labels, 0)
            yc, xc = [int(rng.uniform(0, s)) for _ in self.mosaic_border]
            # the crop folds into region/offset (not minv), so spec canvas
            # coordinates are [0, 2s)^2 in both mosaic modes
            region[:, 0] = np.clip(region[:, 0], xc, xc + 2 * s) - xc
            region[:, 1] = np.clip(region[:, 1], yc, yc + 2 * s) - yc
            region[:, 2] = np.clip(region[:, 2], xc, xc + 2 * s) - xc
            region[:, 3] = np.clip(region[:, 3], yc, yc + 2 * s) - yc
            offset[:, 0] -= xc
            offset[:, 1] -= yc
            targets = filter_by_center(targets,
                                       (xc, xc + 2 * s, yc, yc + 2 * s))
            if len(targets):
                targets = targets.copy()
                targets[:, 1::2] -= xc
                targets[:, 2::2] -= yc
        return tiles, tile_idx, region, offset, hsv, targets

    @staticmethod
    def _tile_key(tiles, tile_idx):
        return ({"tiles": tiles} if tiles is not None
                else {"tile_idx": tile_idx})

    def get_render_spec(self, index: int, rng: np.random.Generator,
                        banked: bool = False):
        """Device-augmentation twin of :meth:`get_sample`.

        Returns ``(path, specs, mix_r, flips, labels)``: ``specs`` is
        ``[base]`` or ``[base, mixup_partner]``, ``flips`` the (lr, ud) pair,
        ``labels`` the final rows, equal to :meth:`get_sample`'s for the same
        ``(index, rng)``.  ``banked``: specs carry ``tile_idx`` bank rows
        instead of ``tiles`` pixels (needs :meth:`build_tile_bank` first).
        """
        if not self.augment:
            raise ValueError("render specs exist for the augment pipeline; "
                             "eval/detect letterboxing stays host-side")
        if banked and not self._bank_sizes:
            raise ValueError("banked render specs need build_tile_bank() "
                             "called first")
        hyp = self.hyp
        s = self.img_size
        if rng.random() < hyp["mosaic"]:
            use9 = not (rng.random() < 0.8)
            tiles, tidx, region, offset, hsv, targets = self._spec_mosaic(
                index, rng, use9, banked)
            rot, shift, center, minv = self._warp_params(
                rng, (2 * s, 2 * s), self.mosaic_border)
            targets = self._warp_targets(targets, rot, shift, center)
            specs = [{**self._tile_key(tiles, tidx), "region": region,
                      "offset": offset, "hsv": hsv, "minv": minv}]
            mix_r = None
            if rng.random() < hyp["mixup"]:
                j = int(rng.integers(0, len(self.img_files)))
                use9b = not (rng.random() < 0.8)
                t2, ti2, r2, o2, g2, targets2 = self._spec_mosaic(
                    j, rng, use9b, banked)
                rot2, shift2, center2, minv2 = self._warp_params(
                    rng, (2 * s, 2 * s), self.mosaic_border)
                targets2 = self._warp_targets(targets2, rot2, shift2, center2)
                specs.append({**self._tile_key(t2, ti2), "region": r2,
                              "offset": o2, "hsv": g2, "minv": minv2})
                mix_r = float(rng.beta(8.0, 8.0))
                targets = np.concatenate([targets, targets2], 0)
        else:
            spec, targets = self._spec_letterbox_warp(index, rng, banked)
            specs = [spec]
            mix_r = None

        targets = filter_by_center(targets, (0, s, 0, s))
        targets = normalize_targets(targets, (s, s))
        flip_lr = self.augment and rng.random() < hyp["fliplr"]
        if flip_lr and len(targets):
            targets = targets.copy()
            targets[:, 1::2] = 1.0 - targets[:, 1::2]
        flip_ud = self.augment and rng.random() < hyp["flipud"]
        if flip_ud and len(targets):
            targets = targets.copy()
            targets[:, 2::2] = 1.0 - targets[:, 2::2]
        labels = self._finalize_labels(targets)
        return (self.img_files[index], specs, mix_r, (flip_lr, flip_ud),
                labels)

    def _spec_letterbox_warp(self, index, rng, banked: bool = False):
        """Non-mosaic spec: letterbox + random warp of one tile."""
        s = self.img_size
        tiles = None
        if banked:
            (h0, w0), (h, w) = self._tile_meta(index, True)
        else:
            img, (h0, w0), (h, w) = self._load_resized(index)
            tiles = np.zeros((MAX_TILES, s, s), np.int32)
            tiles[0, :w, :h] = pack_tile_i32(img)
        gains = self._draw_hsv_gains(rng)
        tile_idx = np.zeros((MAX_TILES,), np.int32)
        tile_idx[0] = index
        region = np.zeros((MAX_TILES, 4), np.float32)
        offset = np.zeros((MAX_TILES, 2), np.float32)
        hsv = np.ones((MAX_TILES, 3), np.float32)
        hsv[0] = gains
        dw, dh = (s - w) / 2, (s - h) / 2
        top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
        region[0] = [left, top, left + w, top + h]
        offset[0] = [left, top]
        targets = self.load_target(index, (dh, dw), (h0, w0), (h, w))
        rot, shift, center, minv = self._warp_params(rng, (s, s), (0, 0))
        targets = self._warp_targets(targets, rot, shift, center)
        return ({**self._tile_key(tiles, tile_idx), "region": region,
                 "offset": offset, "hsv": hsv, "minv": minv}, targets)

    def _finalize_labels(self, targets):
        """Polygon targets -> label rows ``[0, cls, x, y, w, h, theta,
        180 CSL bins]`` (or the first 7 columns without CSL)."""
        n = len(targets)
        labels = np.zeros((n, 187 if self.csl else 7), np.float32)
        if n:
            rboxes = polys_to_xywha_np(targets[:, 1:])
            labels[:, 1] = targets[:, 0]
            labels[:, 2:7] = rboxes
            if self.csl:
                labels[:, 7:] = csl_gaussian_labels_np(
                    rboxes[:, 4] * 180 / np.pi + 90, sig=6.0)
        return labels


def _category(class_names):
    return {name.replace(" ", "-"): i for i, name in enumerate(class_names)}


def _parsed(polys, labels):
    if not labels:
        return np.zeros((0, 8), np.float32), np.zeros((0,), np.float32)
    return np.asarray(polys, np.float32), np.asarray(labels, np.float32)


class DOTADataset(BaseDataset):
    """DOTA split: ``images/*.png`` + ``annfiles/*.txt`` polygon rows
    ``x1 y1 .. x4 y4 class-name [difficulty]``."""

    def __init__(self, data_dir, class_names, hyp, img_size, augment, csl,
                 normalized_labels=False, cache_images=False):
        super().__init__(hyp, img_size, augment, csl, normalized_labels,
                         cache_images=cache_images)
        self.img_files = sorted(
            glob.glob(os.path.join(data_dir, "images", "*.png")))
        self.label_files = [
            p.replace("images", "annfiles").replace(".png", ".txt")
            for p in self.img_files]
        self.category = _category(class_names)

    def load_files(self, label_path):
        polys, labels = [], []
        with open(label_path) as f:
            for line in f:
                parts = line.split(" ")
                if len(parts) < 9:
                    continue
                polys.append([float(v) for v in parts[:8]])
                labels.append(self.category[parts[8].strip()])
        return _parsed(polys, labels)


class UCASAODDataset(BaseDataset):
    """UCAS-AOD: per-image ``.txt`` with tab-separated ``class x1..y4``."""

    def __init__(self, data_dir, class_names, hyp, img_size, augment, csl,
                 normalized_labels=False, cache_images=False):
        super().__init__(hyp, img_size, augment, csl, normalized_labels,
                         cache_images=cache_images)
        self.img_files = sorted(glob.glob(os.path.join(data_dir, "*.png")))
        self.label_files = [p.replace(".png", ".txt") for p in self.img_files]
        self.category = _category(class_names)

    def load_files(self, label_path):
        polys, labels = [], []
        with open(label_path) as f:
            for line in f:
                parts = line.split("\t")
                if len(parts) < 9:
                    continue
                polys.append([float(v) for v in parts[1:9]])
                labels.append(self.category[parts[0].strip()])
        return _parsed(polys, labels)


class CustomDataset(BaseDataset):
    """``cx cy w h theta label`` rows (pixels, radians; the ``xml2txt.py``
    format), turned into corner polygons for the shared pipeline."""

    def __init__(self, data_dir, class_names, hyp, img_size, augment, csl,
                 normalized_labels=False, ext="jpg", cache_images=False):
        super().__init__(hyp, img_size, augment, csl, normalized_labels,
                         cache_images=cache_images)
        self.img_files = sorted(glob.glob(os.path.join(data_dir, f"*.{ext}")))
        if not self.img_files:
            self.img_files = sorted(glob.glob(os.path.join(data_dir, "*.png")))
            ext = "png"
        self.label_files = [p.replace(f".{ext}", ".txt")
                            for p in self.img_files]
        self.category = _category(class_names)

    def load_files(self, label_path):
        rows, labels = [], []
        with open(label_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 6:
                    continue
                x, y, w, h, a = (float(v) for v in parts[:5])
                # wrap theta into [-pi/2, pi/2) with the long side as h
                if w > h:
                    w, h = h, w
                    a += math.pi / 2
                a = (a + math.pi / 2) % math.pi - math.pi / 2
                rows.append([x, y, w, h, a])
                lab = parts[5].strip()
                try:
                    labels.append(float(lab))
                except ValueError:
                    labels.append(self.category[lab.replace(" ", "-")])
        if not labels:
            return _parsed([], [])
        polys = xywha_to_polys_np(np.asarray(rows, np.float32)).reshape(-1, 8)
        return polys.astype(np.float32), np.asarray(labels, np.float32)
