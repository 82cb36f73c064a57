"""Pairwise rotated IoU: the hand-written CUDA kernel and its wrapper.

The counterpart of ``pairwise_rotated_iou_pallas``
(``ryolo_tpu/ops/pallas_iou.py:141``) as a public entry point.  The detect
path does not launch it: its NMS computes the same IoU inside ``nms_mask``
(:mod:`ryolo_tpu_torch.ops.cuda_nms`), through the shared
``ops/csrc/rotated_iou_pair.cuh``.  The kernel is ``ops/csrc/rotated_iou.cu``,
built for ``sm_90a`` by
:mod:`ryolo_tpu_torch.ops._build` at first use and called through
``ctypes``.  A tensor on the CPU takes the plain PyTorch version
(:func:`ryolo_tpu_torch.ops.rotated_iou.pairwise_rotated_iou_plain`); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ryolo_tpu_torch.ops import _build
from ryolo_tpu_torch.ops.rotated_iou import pairwise_rotated_iou_plain
from ryolo_tpu_torch.utils import trace

# Kernel launches, by kernel name; only a launch adds to it.  The
# ``launch`` counters of :mod:`ryolo_tpu_torch.utils.trace`.
LAUNCHES = trace.group("launch", {"rotated_iou": 0})

# FP32 operations that every pair needs, counted from ops/csrc/rotated_iou.cu:
# 2 for the re-centring, 16 for box1's corners, 4 clips x 8 signed distances
# x 5, and 36 for the shoelace, union and division.  An edge crossing adds 8
# more (0 or 2 per clip, by the data; boxes that lie apart have none) and is
# left out, as are selects and compares, so a bound from these is a floor.
# Per box: 10 for a row box, 74 for a column box (sin/cos, extents, edges
# and inward normals).
OPS_PER_PAIR = 2 + 16 + 4 * 8 * 5 + 36
OPS_PER_ROW_BOX = 10
OPS_PER_COL_BOX = 74


def _lib():
    lib = _build.load("rotated_iou")
    fn = lib.rotated_iou_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    b, n, m = boxes1.shape[0], boxes1.shape[1], boxes2.shape[1]
    out = torch.empty((b, n, m), dtype=torch.float32, device=boxes1.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(boxes1.device):
        stream = torch.cuda.current_stream(boxes1.device).cuda_stream
        err = fn(boxes1.data_ptr(), boxes2.data_ptr(), out.data_ptr(),
                 b, n, m, stream)
    if err != 0:
        raise RuntimeError(f"rotated_iou kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["rotated_iou"] += 1
    return out


def pairwise_rotated_iou(boxes1: torch.Tensor,
                         boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of every row box (box1) with every column box (box2).

    ``(B, N, 5) x (B, M, 5) -> (B, N, M)`` float32, or unbatched
    ``(N, 5) x (M, 5) -> (N, M)``; boxes ``(cx, cy, w, h, angle_deg)``,
    float32 and contiguous.  The kernel launches on the current stream
    and does not synchronise.
    """
    unbatched = boxes1.dim() == 2
    if unbatched:
        boxes1, boxes2 = boxes1[None], boxes2[None]
    if (boxes1.dim() != 3 or boxes2.dim() != 3 or boxes1.shape[-1] != 5
            or boxes2.shape[-1] != 5 or boxes1.shape[0] != boxes2.shape[0]):
        raise ValueError(f"expected (B, N, 5) and (B, M, 5) boxes, got "
                         f"{tuple(boxes1.shape)} and {tuple(boxes2.shape)}")
    if boxes1.dtype != torch.float32 or boxes2.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes1.dtype} and "
                        f"{boxes2.dtype}")
    if not (boxes1.is_contiguous() and boxes2.is_contiguous()):
        raise ValueError("boxes must be contiguous")
    if boxes1.device != boxes2.device:
        raise ValueError(f"boxes on {boxes1.device} and {boxes2.device}")
    if max(boxes1.shape[1], boxes2.shape[1]) >= 2 ** 31:
        raise ValueError("too many boxes for the kernel's int arguments")
    if boxes1.device.type == "cpu":
        out = pairwise_rotated_iou_plain(boxes1, boxes2)
    elif boxes1.device.type == "cuda":
        out = _launch(boxes1, boxes2)
    else:
        raise ValueError(f"no rotated IoU for device {boxes1.device}")
    return out[0] if unbatched else out
