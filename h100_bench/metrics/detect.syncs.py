"""The port's ``sync.*`` counts made inside ``Detect.infer`` (host reads and
blocking copies), a batch (traced batches)."""

from h100_bench import spans


def read(record):
    return spans.counted_per(record, "detect", "sync.")
