"""Inputs made from the seed: model weights on the card, the synthetic
DOTA split, and letterboxed detect scenes.

``write_dota_split`` (its sizes made the same for every seed) and the two
weight schemes follow ``chip_smoke.py`` (``write_dota_split``,
``init_weights``/``SCORE_PRIOR``)
and ``ryolo_tpu_torch/train/trainer.py`` (``weights_init_normal``) at
commit d329eff.  The weights are drawn on the device in two calls (one
normal and one uniform draw for every element of the model) and set by
module kind on the reference's model, whose names are the port's.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import torch
from torch import nn

from h100_bench.reference.blocks import ConvBlock, ImplicitA, ImplicitM

PAD_VALUE = 114  # the letterbox's grey


def _draws(model: nn.Module, seed: int, device):
    n = sum(t.numel() for t in model.state_dict().values()
            if t.is_floating_point())
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n, generator=gen, device=device)
    uniform = torch.rand(n, generator=gen, device=device)
    pos = 0

    def take(shape):
        nonlocal pos
        k = int(np.prod(shape))
        z, u = normal[pos:pos + k].view(shape), uniform[pos:pos + k].view(shape)
        pos += k
        return z, u
    return take


@torch.no_grad()
def seeded_weights(model: nn.Module, seed: int, scheme: str, device,
                   score_prior: float = 0.0):
    """Fill ``model`` (the reference's, on ``device``) from ``seed``.

    ``"normal"`` is ``weights_init_normal``: conv kernels N(0, 0.02),
    BatchNorm scales N(1, 0.02), its shifts 0, head biases 0, running
    statistics (0, 1), the implicit priors N(0 or 1, 0.02).  ``"lecun"`` is
    ``chip_smoke.py``'s ``init_weights`` for detect models: conv kernels
    N(0, 1/fan_in), BatchNorm scales U(0.5, 1.5), shifts and head biases
    N(0, 0.1), running means N(0, 0.1), running variances U(0.5, 1.5), the
    implicit priors N(0 or 1, 0.02); ``score_prior`` is added to every head
    conv's obj and class biases."""
    take = _draws(model, seed, device)
    lecun = scheme == "lecun"
    if scheme not in ("normal", "lecun"):
        raise ValueError(f"weight scheme {scheme!r}")
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            z, _ = take(mod.weight.shape)
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(z / fan_in ** 0.5 if lecun else 0.02 * z)
            if mod.bias is not None:
                z, _ = take(mod.bias.shape)
                mod.bias.copy_(0.1 * z if lecun else torch.zeros_like(z))
        elif isinstance(mod, nn.BatchNorm2d):
            z, u = take(mod.weight.shape)
            mod.weight.copy_(0.5 + u if lecun else 1.0 + 0.02 * z)
            z, _ = take(mod.bias.shape)
            mod.bias.copy_(0.1 * z if lecun else torch.zeros_like(z))
            z, u = take(mod.running_mean.shape)
            mod.running_mean.copy_(0.1 * z if lecun else torch.zeros_like(z))
            mod.running_var.copy_(0.5 + u if lecun else torch.ones_like(u))
            mod.num_batches_tracked.zero_()
        elif isinstance(mod, (ImplicitA, ImplicitM)):
            z, _ = take(mod.implicit.shape)
            mod.implicit.copy_(float(isinstance(mod, ImplicitM)) + 0.02 * z)
    if score_prior:
        add_score_prior(model, score_prior)


@torch.no_grad()
def add_score_prior(model: nn.Module, prior: float):
    """Add ``prior`` to the obj and class biases of every head conv (a
    ConvBlock of one biased conv, anchor-major channels)."""
    nc = model.n_classes
    for mod in model.modules():
        if isinstance(mod, ConvBlock) and len(mod.conv) == 1:
            bias = mod.conv[0].bias.view(model.na, model.nf)
            bias[:, 4:5 + nc] += prior


# the stream that draws the split's sizes: the same for every seed
SIZES_SEED = 20260101


def write_dota_split(root, names, rng, n, size=1024, nc=16, entries=None):
    """A DOTA-format split of ``entries`` images (``n`` by default):
    ``images/*.png`` (``size`` px) and ``annfiles/*.txt`` rows
    ``x1 y1 .. x4 y4 class-name difficulty``.

    ``n`` distinct pictures are drawn and written once, under
    ``pictures/``; the split's entries are hard links to them, each
    picture ``entries / n`` times in an order drawn by ``rng``, so a long
    split costs the disk no more than its distinct pictures.
    Every seed gets the same sizes in another order, so that the loader's
    work does not change with the seed: the objects a picture are 8 to 30,
    spread evenly over the pictures and permuted by ``rng``, and the
    rotated rectangles' sides come from one fixed stream, in order; ``rng``
    draws the rest (noise, centres, angles, colours, classes).  The
    pictures are written by a few threads, PNG without compression; lengths
    scale with ``size`` (``chip_smoke.py``'s, which this follows, are at
    1024 px)."""
    entries = n if entries is None else entries
    if entries % n:
        raise ValueError(f"{entries} entries do not repeat {n} pictures "
                         "evenly")
    k = size / 1024.0
    for d in ("pictures", "images", "annfiles"):
        os.makedirs(os.path.join(root, d))
    with ThreadPoolExecutor(4) as pool:
        writes = [pool.submit(cv2.imwrite, path, img,
                              [cv2.IMWRITE_PNG_COMPRESSION, 0])
                  for path, img in _dota_images(root, names, rng, n, size,
                                                nc, k)]
        if not all(w.result() for w in writes):
            raise OSError(f"a picture of {root} was not written")
    for i, j in enumerate(rng.permutation(np.arange(entries) % n)):
        src = os.path.join(root, "pictures", f"Q{j:04d}")
        os.link(src + ".png", os.path.join(root, "images", f"P{i:04d}.png"))
        shutil.copyfile(src + ".txt",
                        os.path.join(root, "annfiles", f"P{i:04d}.txt"))


def _dota_images(root, names, rng, n, size, nc, k):
    sides = np.random.default_rng(SIZES_SEED)
    counts = rng.permutation(8 + np.arange(n) * 22 // max(n - 1, 1))
    for i in range(n):
        img = rng.integers(0, 70, (size, size, 3), dtype=np.uint8)
        rows = []
        for _ in range(int(counts[i])):
            rect = ((float(rng.uniform(60 * k, size - 60 * k)),
                     float(rng.uniform(60 * k, size - 60 * k))),
                    (float(sides.uniform(12 * k, 120 * k)),
                     float(sides.uniform(12 * k, 60 * k))),
                    float(rng.uniform(-90, 90)))
            pts = cv2.boxPoints(rect)
            cv2.fillPoly(img, [pts.astype(np.int32)],
                         [int(c) for c in rng.integers(60, 255, 3)])
            name = names[int(rng.integers(0, nc))].replace(" ", "-")
            rows.append(" ".join(f"{v:.1f}" for v in pts.reshape(-1))
                        + f" {name} 0")
        path = os.path.join(root, "pictures", f"Q{i:04d}")
        with open(path + ".txt", "w") as f:
            f.write("\n".join(rows) + "\n")
        yield path + ".png", img


def scenes(n, size, rng, objects=(20, 60)):
    """``n`` letterboxed RGB uint8 scenes ``(n, size, size, 3)``: noise and
    filled rotated rectangles; every third one is a 4:3 frame with grey
    bands, as the letterbox leaves a 768 x 1024 image."""
    out = np.full((n, size, size, 3), PAD_VALUE, np.uint8)
    for i in range(n):
        h = size if i % 3 else size * 3 // 4
        top = (size - h) // 2
        img = rng.integers(0, 70, (h, size, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(*objects))):
            rect = ((float(rng.uniform(0, size)), float(rng.uniform(0, h))),
                    (float(rng.uniform(8, 120)), float(rng.uniform(8, 60))),
                    float(rng.uniform(-90, 90)))
            pts = cv2.boxPoints(rect).astype(np.int32)
            cv2.fillPoly(img, [pts], [int(c) for c in rng.integers(60, 255, 3)])
        out[i, top:top + h] = img
    return out
