"""``nms_mask_kernel``'s (``ops/csrc/rotated_nms.cu``) share of its
roofline over the traced batches: the least time of its inputs
(``roofline.mask_bound``: the far reject on every valid pair, the clip on
the pairs whose circles meet) over its kernel time in the profiler (%)."""


def read(record):
    bound, got = record.get("nms_mask_bound_s"), record.get("nms_mask_s")
    if not bound or not got:
        return None
    return 100.0 * bound / got
