"""Busy device ms a batch (union of kernel intervals) of the kernels
launched inside the port's ``detect.psa`` spans (C2PSA's two attention
blocks), over the traced batches (``kinds/detect_obb.py``).  Busy time, so
the profiler's slower host does not inflate it; a port without the span,
or a run without a card, is left out."""


def read(record):
    if record.get("kind") != "detect":
        return None
    return record.get("psa_kernel_ms")
