"""Rotated NMS on the card: the two hand-written CUDA kernels and their
launchers.

``ops/csrc/rotated_nms.cu`` holds ``nms_mask`` (the suppression bitmask,
with kernel B1's rotated IoU inline; replaces ``ryolo_tpu/ops/pallas_iou.py:76``
as ``ryolo_tpu/ops/rotated_nms.py:127-182`` calls it) and ``nms_scan`` (the
greedy scan over it; replaces the chunk loop and fixpoint of
``ryolo_tpu/ops/rotated_nms.py:152-212``).  Built for ``sm_90a`` by
:mod:`ryolo_tpu_torch.ops._build` at first use, called through ``ctypes``.

These launchers take CUDA tensors only and raise on anything else or on a
failed build or launch; there is no fallback.  The plain versions are
``nms_mask_plain`` and ``nms_scan_plain`` in
:mod:`ryolo_tpu_torch.ops.rotated_nms`, whose ``nms_rotated_masked`` takes
them for CPU tensors and these kernels for CUDA tensors.

The mask is ``(B, K, ceil(K / 64))`` 64-bit words (int64 storage), rows as
the suppressed: bit j of word c of row r is set when candidate 64c + j
suppresses r.  Only the words c <= r // 64 of rows r < n_rows[b] are
written; the rest is left as ``torch.empty`` left it, and nothing reads it.
"""

from __future__ import annotations

import ctypes

import torch

from ryolo_tpu_torch.ops import _build

CHUNK = 64
# The scan keeps one 64-bit word per chunk in dynamic shared memory, which
# with its static shared memory (under 1 KiB) must fit the default 48 KiB
# per block: 47 KiB of words, 6016 chunks.
MAX_K = (47 * 1024 // 8) * CHUNK

# Kernel launches, by kernel name; only a launch adds to it.
LAUNCHES = {"nms_mask": 0, "nms_scan": 0}


def _fn(name: str, argtypes):
    fn = getattr(_build.load("rotated_nms"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(what: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device):
    if t.device.type != "cuda":
        raise ValueError(f"{what} on {t.device}: the NMS kernels take CUDA "
                         "tensors only (the CPU runs rotated_nms's plain "
                         "versions)")
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_size(b: int, k: int):
    if k > MAX_K or b > 65535:
        raise ValueError(f"{b} x {k} candidates: the kernels take B <= 65535 "
                         f"and K <= {MAX_K}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def nms_mask(sboxes: torch.Tensor, n_rows: torch.Tensor,
             thr: float) -> torch.Tensor:
    """Suppression bitmask of score-sorted ``(B, K, 5)`` float32 boxes, rows
    below ``n_rows`` ``(B,)`` int32 decided, IoU strictly above ``thr``.
    Launches on the current stream; no host read."""
    if sboxes.dim() != 3 or sboxes.shape[-1] != 5:
        raise ValueError(f"expected (B, K, 5) boxes, got "
                         f"{tuple(sboxes.shape)}")
    b, k, _ = sboxes.shape
    _check_size(b, k)
    dev = sboxes.device
    _check("boxes", sboxes, torch.float32, (b, k, 5), dev)
    _check("n_rows", n_rows, torch.int32, (b,), dev)
    nw = -(-k // CHUNK)
    mask = torch.empty((b, k, nw), dtype=torch.int64, device=dev)
    if mask.numel() == 0:
        return mask
    fn = _fn("nms_mask_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(sboxes.data_ptr(), n_rows.data_ptr(), mask.data_ptr(), b, k,
                 float(thr), _stream(dev))
    if err != 0:
        raise RuntimeError(f"nms_mask kernel launch failed: CUDA error {err}")
    LAUNCHES["nms_mask"] += 1
    return mask


def nms_scan(mask: torch.Tensor, svalid: torch.Tensor, n_rows: torch.Tensor,
             max_keep: int) -> torch.Tensor:
    """Greedy scan of ``mask`` in row order: ``keep`` ``(B, K)`` bool, at
    most ``max_keep`` per image.  Launches on the current stream; no host
    read."""
    if svalid.dim() != 2:
        raise ValueError(f"expected (B, K) valid flags, got "
                         f"{tuple(svalid.shape)}")
    b, k = svalid.shape
    _check_size(b, k)
    dev = svalid.device
    _check("valid", svalid, torch.bool, (b, k), dev)
    _check("mask", mask, torch.int64, (b, k, -(-k // CHUNK)), dev)
    _check("n_rows", n_rows, torch.int32, (b,), dev)
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    if keep.numel() == 0:
        return keep
    fn = _fn("nms_scan_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(mask.data_ptr(), svalid.data_ptr(), n_rows.data_ptr(),
                 keep.data_ptr(), b, k, int(max_keep), _stream(dev))
    if err != 0:
        raise RuntimeError(f"nms_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["nms_scan"] += 1
    return keep
