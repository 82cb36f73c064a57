"""Busy device ms a batch (union of kernel intervals) of the kernels
launched inside the port's ``detect.obb_head`` spans (the three levels'
box, class and angle branches, the depthwise convolutions among them),
over the traced batches (``kinds/detect_obb.py``); a port without the
span, or a run without a card, is left out."""


def read(record):
    if record.get("kind") != "detect":
        return None
    return record.get("obb_head_kernel_ms")
