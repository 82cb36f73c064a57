"""Share of the traced training window in which no operation ran on the
device: 1 - (union of kernel, copy and set intervals) / window (%)."""


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
