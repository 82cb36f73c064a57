"""The port's ``upload.h2d`` counts made inside ``Detect.infer`` (host
arrays sent up through pinned memory: the decode's anchor tables), a batch
(traced batches)."""

from h100_bench import spans


def read(record):
    return spans.counted_per(record, "detect", "upload.h2d")
