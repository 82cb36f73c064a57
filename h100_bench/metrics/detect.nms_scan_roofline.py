"""``nms_scan_kernel``'s share of its roofline over the traced batches: the
bytes it must read and write (``roofline.scan_bound``: the mask words of
the chunks it visits) over its kernel time in the profiler (%)."""


def read(record):
    bound, got = record.get("nms_scan_bound_s"), record.get("nms_scan_s")
    if not bound or not got:
        return None
    return 100.0 * bound / got
