"""Device-side augmentation: mosaic paste, HSV jitter, affine warp, mixup
and flips, rendered from the loader's specs on the device.

Counterpart of ``ryolo_tpu/data/device_augment.py``.  The host builds
render specs (:meth:`ryolo_tpu_torch.data.datasets.BaseDataset.get_render_spec`)
and keeps only decode and label math.  Two routes render a batch, as the
JAX package's ``method`` argument selects (``render_specs`` :528):

* ``method="taps"`` (the default, the training path): one launch of the
  CUDA tap renderer (:func:`ryolo_tpu_torch.ops.cuda_render.render_taps`,
  ``ops/csrc/render.cu``), the redesign of the TPU kernel B2 for the card.
  Each output pixel's 4 bilinear taps resolve their owning slot and read
  the packed tile word straight from the uploaded tiles or the tile bank,
  with the slot's HSV gains, mixup, flips and /255 in the same thread; no
  canvas is built.  It computes what the JAX package's "taps" renderer
  (``_render_one`` :175, then ``_mix_flip_tail`` :648) computes; on the CPU
  the plain version ``ryolo_tpu_torch/ops/render.py`` runs.
* ``method="canvas"``: the canvas route, the counterpart of JAX
  ``method="canvas"``/``"pallas"``.  Per batch the device

  1. pastes each live spec's tiles into its ``(C, C)`` canvas, C = 2s+2
     (:func:`_paste_canvas`, ``_paste_canvas`` :298), one slice copy per
     live slot, ascending slot order, so the last writer owns a cell;
  2. applies each tile's HSV gains through the owner id in the word's top
     byte (:func:`_hsv_canvas`, :365) -> ``(3, C, C)`` uint8 planar x-major;
  3. warps the canvases to ``(B, 3, s, s)`` with the CUDA kernel B2
     (:func:`ryolo_tpu_torch.ops.cuda_warp.warp_canvas`; plain version
     ``ryolo_tpu_torch/ops/warp.py``, the port of ``_warp_block`` :434);
  4. blends mixup partners and flips (:func:`_mix_flip_tail`, :648) and
     divides by 255.

  Mixup-partner slots that no base slot references are not built: the
  warp PAD-fills them (``_render_pallas`` :485).  The paste covers every
  live slot up to the highest one: the JAX canvas path counts live regions
  and pastes that many slots, which drops the last live slot when a
  mosaic-9 crop leaves a zero-area region in the middle (a reference
  finding, ROADMAP §C); the port's canvas route equals the taps renderer.

Spec layouts (B specs, T = ``datasets.MAX_TILES`` slots, s = img_size), numpy from the
loader: ``tiles`` (B, T, s, s) int32 packed RGB x-major (``tiles[b, t, x,
y]`` = R | G<<8 | B<<16 of pixel (row y, col x), content top-left), or
``tile_idx`` (B, T) int32 rows of a device-resident bank (N, s, s);
``region`` (B, T, 4) canvas box [x1, y1, x2, y2); ``offset`` (B, T, 2)
canvas -> source translation; ``hsv`` (B, T, 3) gains; ``minv`` (B, 2, 3)
output -> canvas affine; ``flip`` (n_out, 2); ``mix_idx`` (n_out,) partner
slot or -1; ``mix_r`` (n_out,) blend weight.  The geometry (regions,
offsets, bank rows, mixup and flips) stays on the host, so a render needs
no host sync.  Output: ``(n_out, 3, s, s)`` float32 NCHW RGB in [0, 1] on
the device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ryolo_tpu_torch.ops.cuda_render import render_taps
from ryolo_tpu_torch.ops.cuda_warp import warp_canvas
from ryolo_tpu_torch.ops.hsv import _hsv_jitter_planar, hsv_jitter  # noqa: F401
from ryolo_tpu_torch.ops.render import (PAD, to_device,  # noqa: F401
                                        mix_flip_tail as _mix_flip_tail)

_PAD_U8 = int(PAD)
METHODS = ("taps", "canvas")


def _paste_canvas(tile_of: Callable[[int], torch.Tensor], region: np.ndarray,
                  offset: np.ndarray, out_size: int,
                  device) -> torch.Tensor:
    """One spec -> ``(C, C)`` int32 canvas words ``R | G<<8 | B<<16 |
    owner<<24`` (``_paste_canvas`` :298).

    Buffer cell ``[X, Y]`` is canvas cell ``(X-1, Y-1)``; cells outside
    every region hold PAD with owner T.  Slot k's tile covers canvas cells
    ``offset_k + (wx, wy)`` for ``(wx, wy)`` in ``[0, s)^2``; its paste is
    the slice of that window inside its region and inside the canvas,
    computed on the host, so each live slot is one slice copy.  Every live
    slot is pasted in ascending order (zero-area regions are no-ops).
    """
    s = out_size
    T = region.shape[0]
    C = 2 * s + 2
    buf = torch.full((C, C), _PAD_U8 | (_PAD_U8 << 8) | (_PAD_U8 << 16)
                     | (T << 24), dtype=torch.int32, device=device)
    for k in range(T):
        r0, r1, r2, r3 = (float(v) for v in region[k])
        if not (r2 > r0 and r3 > r1):
            continue
        # offsets are whole numbers; int() truncates as astype(int32) does
        ox, oy = int(offset[k, 0]), int(offset[k, 1])
        # integer canvas cells q with r0 <= q < r2, inside the window
        # [o, o+s) and inside the buffer's canvas range [-1, C-1)
        x_lo, x_hi = max(math.ceil(r0), ox, -1), min(math.ceil(r2), ox + s, C - 1)
        y_lo, y_hi = max(math.ceil(r1), oy, -1), min(math.ceil(r3), oy + s, C - 1)
        if x_hi <= x_lo or y_hi <= y_lo:
            continue
        tile = tile_of(k)[x_lo - ox:x_hi - ox, y_lo - oy:y_hi - oy]
        buf[x_lo + 1:x_hi + 1, y_lo + 1:y_hi + 1] = tile | (k << 24)
    return buf


def _hsv_canvas(core: torch.Tensor, hsv: torch.Tensor) -> torch.Tensor:
    """Per-tile HSV through the owner byte (``_hsv_canvas`` :365): ``(N, C,
    C)`` int32 words and ``(N, T, 3)`` gains -> ``(N, 3, C, C)`` uint8
    planar canvases."""
    N, C, _ = core.shape
    own = (core >> 24).long().reshape(N, C * C)
    # slot T (no owner) takes gains 1
    table = torch.cat([hsv, hsv.new_ones(N, 1, 3)], 1)
    gh, gs, gv = (table[..., j].gather(1, own).reshape(N, C, C)
                  for j in range(3))
    r = (core & 0xFF).float()
    g = ((core >> 8) & 0xFF).float()
    b = ((core >> 16) & 0xFF).float()
    ident = (gh == 1.0) & (gs == 1.0) & (gv == 1.0)
    rj, gj, bj = _hsv_jitter_planar(r, g, b, gh, gs, gv)
    r = torch.where(ident, r, rj)
    g = torch.where(ident, g, gj)
    b = torch.where(ident, b, bj)
    return torch.stack([torch.round(r), torch.round(g), torch.round(b)],
                       1).to(torch.uint8)


def _active(mix_idx: np.ndarray, n_out: int, n_specs: int) -> np.ndarray:
    """Base slots, and the partner slots some base slot blends in."""
    active = np.arange(n_specs) < n_out
    active[mix_idx[:n_out][mix_idx[:n_out] >= 0]] = True
    return active


def _canvases(tile_of: Callable[[int, int], torch.Tensor], region, offset,
              hsv_t: torch.Tensor, active: np.ndarray, out_size: int,
              device) -> torch.Tensor:
    """``(B, 3, C, C)`` uint8 canvases of the active specs (the inactive
    ones stay PAD and are never read)."""
    B = region.shape[0]
    live = np.flatnonzero(active)  # never empty: base slots are active
    core = torch.stack([
        _paste_canvas(lambda k, b=int(b): tile_of(b, k), region[b], offset[b],
                      out_size, device) for b in live])
    if len(live) == B:
        return _hsv_canvas(core, hsv_t)
    C = 2 * out_size + 2
    canvas = torch.full((B, 3, C, C), _PAD_U8, dtype=torch.uint8,
                        device=device)
    idx = to_device(live, device)
    canvas[idx] = _hsv_canvas(core, hsv_t[idx])
    return canvas


def _check_method(method: str):
    if method not in METHODS:
        raise ValueError(f"unknown render method {method!r}; one of {METHODS}")


def _render(tile_of, region, offset, hsv, minv, flip, mix_idx, mix_r, n_out,
            out_size, device):
    """The canvas route: paste, HSV, the warp kernel, mixup and flips."""
    active = _active(mix_idx, n_out, region.shape[0])
    canvas = _canvases(tile_of, region, offset, to_device(hsv, device),
                       active, out_size, device)
    imgs = warp_canvas(canvas, to_device(minv, device), out_size,
                       to_device(active.astype(np.int32), device))
    return _mix_flip_tail(imgs, flip, mix_idx, mix_r, n_out)


def render_specs(tiles, region, offset, hsv, minv, flip, mix_idx, mix_r,
                 n_out: int, device="cuda", method: str = "taps"):
    """Render a batch of pixel specs -> ``(n_out, 3, s, s)`` float32 in
    [0, 1] on ``device`` (``render_specs`` :528).  Spec slots >= ``n_out``
    are mixup partners only."""
    _check_method(method)
    B, T, s = tiles.shape[:3]
    tiles = to_device(tiles, device)
    if method == "taps":
        slot_rows = np.arange(B * T, dtype=np.int64).reshape(B, T)
        return render_taps(tiles.view(B * T, s, s), slot_rows, region,
                           offset, hsv, minv, flip, mix_idx, mix_r, n_out)
    return _render(lambda b, k: tiles[b, k], region, offset, hsv, minv, flip,
                   mix_idx, mix_r, n_out, s, device)


def render_specs_banked(bank: torch.Tensor, tile_idx, region, offset, hsv,
                        minv, flip, mix_idx, mix_r, n_out: int,
                        method: str = "taps"):
    """:func:`render_specs` with tiles read from a device-resident bank
    ``(N, s, s)`` int32 (``render_specs_banked`` :561), on the bank's
    device; ``tile_idx`` ``(B, T)`` names each slot's bank row.  The same
    spec renders the same image through either function."""
    _check_method(method)
    if method == "taps":
        return render_taps(bank, tile_idx, region, offset, hsv, minv, flip,
                           mix_idx, mix_r, n_out)
    return _render(lambda b, k: bank[int(tile_idx[b, k])], region, offset,
                   hsv, minv, flip, mix_idx, mix_r, n_out, bank.shape[2],
                   bank.device)


def render_batch(arrays, n_out: int, bank: Optional[torch.Tensor] = None,
                 device="cuda", method: str = "taps"):
    """Render a loader spec batch (dict of numpy arrays) on ``device``
    (``render_batch`` :616) by ``method`` ("taps" or "canvas").  Banked
    batches carry ``spec_tile_idx`` and need ``bank`` (they render on its
    device); pixel batches (including a banked loader's overflow fallback)
    carry ``spec_tiles``."""
    common = (arrays["spec_region"], arrays["spec_offset"],
              arrays["spec_hsv"], arrays["spec_minv"], arrays["spec_flip"],
              arrays["spec_mix_idx"], arrays["spec_mix_r"])
    if "spec_tile_idx" in arrays:
        if bank is None:
            raise ValueError("banked spec batch needs the uploaded tile bank")
        return render_specs_banked(bank, arrays["spec_tile_idx"], *common,
                                   n_out=n_out, method=method)
    return render_specs(arrays["spec_tiles"], *common, n_out=n_out,
                        device=device, method=method)
