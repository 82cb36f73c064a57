"""Host seconds waiting in each ``next()`` of the spec loader, mean per
step over the window, in ms (host clock)."""


def read(record):
    waits = record.get("loader_wait_s")
    if record.get("kind") != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
