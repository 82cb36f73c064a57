"""ctypes bindings for the host C++ rotated geometry of the eval matcher
(counterpart of ``ryolo_tpu/ops/native/__init__.py:24-117``).

``rotated_geometry.cpp`` is built with ``g++`` at first use, on each host,
into ``build/native/`` at the repo root.  The library's name carries a
content hash of the source, the flags and what ``-march=native`` means on
this host (``g++ -Q --help=target``), so a checkout moved to another CPU
builds its own.  The flags are the JAX package's: ``-march=native`` lets
g++ contract ``a*b+c`` into FMA, and other flags could move an IoU by an
ulp and flip a TP flag on a knife edge against the JAX build on the same
host.  A failed build raises with g++'s output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "rotated_geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the eval matcher's C++ "
                           "library builds at first use")
    return gxx


def _target(gxx: str) -> Path:
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode() + b"\0" + target.encode())
    return BUILD_DIR / f"librotated_geometry-{h.hexdigest()[:12]}.so"


def _build() -> Path:
    gxx = _gxx()
    lib = _target(gxx)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if this host has none."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            f32 = ctypes.POINTER(ctypes.c_float)
            lib.pairwise_rotated_iou.argtypes = [
                f32, ctypes.c_int64, f32, ctypes.c_int64, f32]
            lib.pairwise_rotated_iou.restype = None
            lib.match_rotated.argtypes = [
                f32, f32, ctypes.c_int64, f32, f32, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.match_rotated.restype = None
            _lib = lib
        return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pairwise_rotated_iou_native(boxes1, boxes2) -> np.ndarray:
    """N×M skew-IoU matrix of degree boxes, double precision inside,
    float32 out."""
    b1 = np.ascontiguousarray(boxes1, np.float32)
    b2 = np.ascontiguousarray(boxes2, np.float32)
    n, m = len(b1), len(b2)
    out = np.zeros((n, m), np.float32)
    if n and m:
        get_lib().pairwise_rotated_iou(_fptr(b1), n, _fptr(b2), m, _fptr(out))
    return out


def match_rotated_native(pred_geom, pred_cls, tar_geom, tar_cls,
                         iouv) -> np.ndarray:
    """One image's ``(n, len(iouv))`` bool TP matrix: predictions in
    confidence order each claim their first-max same-class target if its
    IoU clears ``iouv[0]`` and nobody claimed it yet.  ``pred_geom`` and
    ``tar_geom`` are degree boxes.  ctypes drops the GIL for the call."""
    pg = np.ascontiguousarray(pred_geom, np.float32)
    pc = np.ascontiguousarray(pred_cls, np.float32)
    tg = np.ascontiguousarray(tar_geom, np.float32)
    tc = np.ascontiguousarray(tar_cls, np.float32)
    iv = np.ascontiguousarray(iouv, np.float64)
    n, m, k = len(pg), len(tg), len(iv)
    tp = np.zeros((n, k), np.uint8)
    if n:
        get_lib().match_rotated(
            _fptr(pg), _fptr(pc), n, _fptr(tg), _fptr(tc), m,
            iv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), k,
            tp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return tp.astype(bool)
