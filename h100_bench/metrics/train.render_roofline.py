"""The tap renderer's (``render_kernel``, ``ops/csrc/render.cu``) share of
its roofline over the traced steps: the least time its inputs need
(``roofline.render_bound``) over its kernel time in the profiler (%)."""


def read(record):
    bound, got = record.get("render_bound_s"), record.get("render_s")
    if not bound or not got:
        return None
    return 100.0 * bound / got
