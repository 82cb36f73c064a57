"""Canvas warp: the hand-written CUDA kernel and its wrapper.

Replaces the TPU kernel ``ryolo_tpu/ops/pallas_warp.py:261``
(``warp_canvas_planar``; body ``_warp_kernel`` :107, ``_warp_tile_body``
:159).  The kernel is ``ops/csrc/warp.cu``, built for ``sm_90a`` by
:mod:`ryolo_tpu_torch.ops._build` at first use and called through
``ctypes``.  A tensor on the CPU takes the plain PyTorch version
(:func:`ryolo_tpu_torch.ops.warp.warp_canvas_plain`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ryolo_tpu_torch.ops import _build
from ryolo_tpu_torch.ops.warp import warp_canvas_plain

# Kernel launches, by kernel name; only a launch adds to it.
LAUNCHES = {"warp": 0}

# FP32 operations per output pixel of an active spec, counted from
# ops/csrc/warp.cu: 4 multiplies and 4 adds for the coordinates, 2 floors,
# 4 subtractions, 4 weight products, and per channel 4 products, 3 sums and
# a rint.  Compares and selects are left out, so a bound from it is a floor.
OPS_PER_PIXEL = 8 + 2 + 4 + 4 + 3 * (4 + 3 + 1)


def _lib():
    lib = _build.load("warp")
    fn = lib.warp_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(canvas: torch.Tensor, minv: torch.Tensor, active: torch.Tensor,
            s: int) -> torch.Tensor:
    B, _, C, _ = canvas.shape
    out = torch.empty((B, 3, s, s), dtype=torch.float32, device=canvas.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        err = fn(canvas.data_ptr(), minv.data_ptr(), active.data_ptr(),
                 out.data_ptr(), B, C, s, stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: CUDA error {err}")
    LAUNCHES["warp"] += 1
    return out


def warp_canvas(canvas: torch.Tensor, minv: torch.Tensor, out_size: int,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp ``(B, 3, C, C)`` uint8 planar x-major canvases by ``(B, 2, 3)``
    float32 inverse affines -> ``(B, 3, s, s)`` float32 NCHW, integers in
    [0, 255]; ``active`` ``(B,)`` (bool or int) PAD-fills the specs where it
    is zero.  The kernel launches on the current stream and does not
    synchronise."""
    if canvas.dim() != 4 or canvas.shape[1] != 3 \
            or canvas.shape[2] != canvas.shape[3]:
        raise ValueError(f"expected (B, 3, C, C) canvases, got "
                         f"{tuple(canvas.shape)}")
    B = canvas.shape[0]
    if canvas.dtype != torch.uint8:
        raise TypeError(f"canvases must be uint8, got {canvas.dtype}")
    if minv.shape != (B, 2, 3) or minv.dtype != torch.float32:
        raise ValueError(f"expected ({B}, 2, 3) float32 affines, got "
                         f"{tuple(minv.shape)} {minv.dtype}")
    if active is None:
        active = torch.ones(B, dtype=torch.int32, device=canvas.device)
    if active.shape != (B,):
        raise ValueError(f"expected ({B},) active flags, got "
                         f"{tuple(active.shape)}")
    if not (canvas.device == minv.device == active.device):
        raise ValueError(f"canvas on {canvas.device}, affines on "
                         f"{minv.device}, flags on {active.device}")
    if max(canvas.shape[2], int(out_size)) ** 2 >= 2 ** 31:
        raise ValueError("canvas too large for the kernel's int arguments")
    if canvas.device.type == "cpu":
        return warp_canvas_plain(canvas, minv, out_size, active)
    if canvas.device.type != "cuda":
        raise ValueError(f"no canvas warp for device {canvas.device}")
    return _launch(canvas.contiguous(), minv.contiguous(),
                   active.to(torch.int32).contiguous(), int(out_size))
