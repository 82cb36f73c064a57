"""``Detect.infer``'s "decode" and "post_process" stages (CUDA events:
deferred CSL decode, selection, deferred theta, NMS, compaction), mean ms
a batch over the window."""


def read(record):
    ms = record.get("post_ms")
    if record.get("kind") != "detect" or not ms:
        return None
    return sum(ms) / len(ms)
