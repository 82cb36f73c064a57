"""``Detect.infer``'s "forward" stage (CUDA events: the uint8 batch to the
compute dtype and the fused model), mean ms a batch over the window."""


def read(record):
    ms = record.get("forward_ms")
    if record.get("kind") != "detect" or not ms:
        return None
    return sum(ms) / len(ms)
