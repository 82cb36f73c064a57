"""Build the port's CUDA sources into shared libraries, at first use.

Each ``ops/csrc/<name>.cu`` exports plain C functions and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so`` at the repo
root (listed in ``.gitignore``) and loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds.  A library is
rebuilt when its source or the flags change (the content hash is part of
the file name).  ``-Xptxas -v`` output (registers, spills) is kept beside
each library as ``lib<name>-<hash>.ptxas.txt``.

``--fmad=false`` keeps multiply and add separately rounded, as the plain
PyTorch version computes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, lib in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return _LIBS[name]


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the current build of ``name``."""
    log = _target(name).with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""
