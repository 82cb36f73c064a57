"""The tap renderer: the hand-written CUDA kernel and its wrapper.

Redesign of the TPU kernel ``ryolo_tpu/ops/pallas_warp.py:261``
(``warp_canvas_planar``; body ``_warp_kernel`` :107) together with the
canvas stages around it: one launch renders each output pixel straight from
the packed tile words (paste, HSV, warp, mixup, flips and /255), with no
canvas.  The kernel is ``ops/csrc/render.cu``, built for ``sm_90a`` by
:mod:`ryolo_tpu_torch.ops._build` at first use and called through
``ctypes``.  A tensor on the CPU takes the plain PyTorch version
(:func:`ryolo_tpu_torch.ops.render.render_taps_plain`); a CUDA tensor
launches the kernel or raises.

The host packs one slot table per batch, an ``(B, 10 + 10*T)`` int32 array
(float fields as their bits): per spec the affine ``m0..m5``; per slot
``r0, r1, r2, r3, offx, offy, gh, gs, gv, row``; then ``flip_lr, flip_ud,
mix_idx, mix_r`` (outputs only; partners hold 0, 0, -1, 0).  It goes up
through pinned memory without blocking the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ryolo_tpu_torch.ops import _build
from ryolo_tpu_torch.ops.render import render_taps_plain, to_device

# Kernel launches, by kernel name; only a launch adds to it.
LAUNCHES = {"render": 0}

MAX_SLOTS = 16  # tile slots per spec the kernel takes (a spec's keep mask)

# FP32 operations, counted from ops/csrc/render.cu; compares, selects and
# integer work are left out, and a division counts as one, so a bound from
# them is a floor.
# Per rendered spec and pixel: 4 products and 4 sums for the coordinates,
# 2 floors, 2 fractions, 2 tap coordinates, 2 complements, 4 weights, and
# per channel 4 products, 3 sums and a rint.
OPS_PER_SPEC_PIXEL = 8 + 2 + 2 + 2 + 2 + 4 + 3 * (4 + 3 + 1)
# Per owned tap: 2 subtractions and 4 min/max for the source coordinates.
OPS_PER_TAP = 2 + 4
# Per owned tap with gains other than 1, the HSV round trip: max/min 4,
# d 1, hue 3 (difference, division, offset), x30 1, wrap 1, rint 1,
# saturation 3; the jitter 3 (product, floor, remainder) + 4 + 4 (product,
# floor, 2 clamps); back: h6 1, floor 1, f 1, sf 1, p 2, q 3, t 4, 3 rints.
OPS_PER_HSV = 4 + 1 + 3 + 1 + 1 + 1 + 3 + 3 + 4 + 4 + 1 + 1 + 1 + 1 + 2 + 3 \
    + 4 + 3
# Per output pixel with a mixup partner: 1 - r, and per channel 2 products,
# a sum and a floor.
OPS_PER_MIX = 1 + 3 * 4
# Per output pixel: the three products by 1/255.
OPS_PER_OUT_PIXEL = 3


def _lib():
    lib = _build.load("render")
    fn = lib.render_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _live(region: np.ndarray) -> np.ndarray:
    """``(B, T)``: the slots whose region has area (only they own taps)."""
    return ((region[..., 2] > region[..., 0])
            & (region[..., 3] > region[..., 1]))


def pack_table(slot_rows, region, offset, hsv, minv, flip, mix_idx, mix_r,
               n_out: int) -> np.ndarray:
    """The kernel's slot table, ``(B, 10 + 10*T)`` int32 (module doc).  A
    slot with an empty region can own no tap; its row is written as 0."""
    B, T = region.shape[:2]
    slots = np.zeros((B, T, 10), np.float32)
    slots[..., 0:4] = region
    slots[..., 4:6] = offset
    slots[..., 6:9] = hsv
    slots.view(np.int32)[..., 9] = np.where(_live(region), slot_rows, 0)
    tail = np.zeros((B, 4), np.float32)
    tail.view(np.int32)[:, 2] = -1
    tail.view(np.int32)[:n_out, 0:2] = np.asarray(flip[:n_out], np.int32)
    tail.view(np.int32)[:n_out, 2] = mix_idx[:n_out]
    tail[:n_out, 3] = mix_r[:n_out]
    rec = np.concatenate([np.asarray(minv, np.float32).reshape(B, 6),
                          slots.reshape(B, 10 * T), tail], 1)
    return rec.view(np.int32)


def launch(rows: torch.Tensor, table: torch.Tensor, n_out: int
           ) -> torch.Tensor:
    """One launch of the kernel on the current stream, no synchronisation:
    ``rows`` ``(R, s, s)`` int32 and ``table`` (:func:`pack_table`) on one
    card -> ``(n_out, 3, s, s)`` float32.  The caller checks the spec
    (:func:`render_taps`)."""
    s = rows.shape[-1]
    T = (table.shape[1] - 10) // 10
    out = torch.empty((n_out, 3, s, s), dtype=torch.float32,
                      device=rows.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), table.data_ptr(), out.data_ptr(), n_out, T,
                 s, stream)
    if err != 0:
        raise RuntimeError(f"render kernel launch failed: CUDA error {err}")
    LAUNCHES["render"] += 1
    return out


def render_taps(rows: torch.Tensor, slot_rows, region, offset, hsv, minv,
                flip, mix_idx, mix_r, n_out: int) -> torch.Tensor:
    """Render specs from packed tile rows -> ``(n_out, 3, s, s)`` float32
    in [0, 1] on ``rows``' device (arguments as
    :func:`ryolo_tpu_torch.ops.render.render_taps_plain`).  On a card: one
    launch, no host sync."""
    if rows.dim() != 3 or rows.shape[1] != rows.shape[2] \
            or rows.shape[0] == 0:
        raise ValueError(f"expected (R, s, s) tile rows, got "
                         f"{tuple(rows.shape)}")
    if rows.dtype != torch.int32:
        raise TypeError(f"tile rows must be int32 packed words, got "
                        f"{rows.dtype}")
    R, s = rows.shape[0], rows.shape[2]
    region = np.asarray(region, np.float32)
    if region.ndim != 3 or region.shape[2] != 4:
        raise ValueError(f"expected (B, T, 4) regions, got {region.shape}")
    B, T = region.shape[:2]
    shapes = {"slot_rows": (np.shape(slot_rows), (B, T)),
              "offset": (np.shape(offset), (B, T, 2)),
              "hsv": (np.shape(hsv), (B, T, 3)),
              "minv": (np.shape(minv), (B, 2, 3))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"expected {name} {want}, got {tuple(got)}")
    if not 0 <= n_out <= B or len(flip) < n_out or len(mix_idx) < n_out \
            or len(mix_r) < n_out:
        raise ValueError(f"n_out {n_out} against {B} specs and "
                         f"{len(flip)}/{len(mix_idx)}/{len(mix_r)} "
                         "flips/partners/weights")
    mix = np.asarray(mix_idx[:n_out], np.int64)
    if ((mix < -1) | (mix >= B)).any():
        raise ValueError(f"mixup partners {mix.tolist()} outside [-1, {B})")
    srow = np.asarray(slot_rows, np.int64)
    if ((srow < 0) | (srow >= R))[_live(region)].any():
        raise ValueError(f"slot rows outside the {R} tile rows")
    if rows.device.type == "cpu":
        return render_taps_plain(rows, slot_rows, region, offset, hsv, minv,
                                 flip, mix_idx, mix_r, n_out)
    if rows.device.type != "cuda":
        raise ValueError(f"no tap renderer for device {rows.device}")
    if T > MAX_SLOTS:
        raise ValueError(f"{T} tile slots per spec; the kernel takes "
                         f"{MAX_SLOTS}")
    if s * s >= 2 ** 31:
        raise ValueError("image too large for the kernel's int arguments")
    table = pack_table(slot_rows, region, offset, hsv, minv, flip, mix_idx,
                       mix_r, n_out)
    return launch(rows.contiguous(), to_device(table, rows.device), n_out)
