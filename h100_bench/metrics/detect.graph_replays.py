"""The port's ``graph.replay`` counts made inside ``Detect.infer`` (CUDA
graphs of the decode and post-process replayed), a batch (traced batches).
A port that replays none (one without the graphs, or on the CPU) is left
out."""

from h100_bench import spans


def read(record):
    return spans.counted_per(record, "detect", "graph.replay") or None
