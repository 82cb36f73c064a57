"""Device ms of ``train_step_rendered`` a step: the CUDA events around
each call (render, forward, loss, backward, SGD), summed over the window
and divided by its steps."""


def read(record):
    ms = record.get("step_ms")
    if record.get("kind") != "train" or not ms:
        return None
    return sum(ms) / len(ms)
