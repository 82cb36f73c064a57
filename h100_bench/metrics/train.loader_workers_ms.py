"""Host ms of the port's ``loader.wait`` span a step: the main thread
blocked on the loader's worker threads' samples (traced steps)."""

from h100_bench import spans


def read(record):
    return spans.ms_per(record, "train", "loader.wait", "host_s")
