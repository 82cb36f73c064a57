"""The port's own spans and counters (``ryolo_tpu_torch.utils.trace``), as
the per-layer metrics that read them see them.

A record may carry the port's summary under ``spans``.  Without it, a
traced run's readers take the summary from the port itself: the port
records spans while a ``torch.profiler`` records, so those are the spans of
the run's traced batches or steps.  A run without a trace (``--trace 0``),
or a port without that module, has none, and its readers return ``None``.
"""

import sys

MODULE = "ryolo_tpu_torch.utils.trace"
# the span that one batch or step opens, by the record's kind
TOP = {"detect": "detect.infer", "train": "train.step"}


def of(record, kind):
    """The record's spans by name, or ``None``."""
    if record.get("kind") != kind:
        return None
    spans = record.get("spans")
    if spans is None:
        port = sys.modules.get(MODULE)
        if port is None or not record.get("trace"):
            return None
        spans = port.summary()["spans"]
    return spans or None


def _top(record, kind):
    spans = of(record, kind)
    return spans, spans and spans.get(TOP[kind])


def ms_per(record, kind, name, clock):
    """``clock`` (``host_s`` or ``device_s``) of the span ``name`` in ms, a
    batch or step (a count of the kind's top span); 0 where no such span
    opened in those batches or steps."""
    spans, top = _top(record, kind)
    if not top:
        return None
    got = spans.get(name)
    if got is None:
        return 0.0
    if got[clock] is None:
        return None
    return 1e3 * got[clock] / top["count"]


def counted_per(record, kind, prefix):
    """Counts whose name begins with ``prefix``, made inside the kind's top
    span, a batch or step."""
    _, top = _top(record, kind)
    if not top:
        return None
    return sum(v for k, v in top["counts"].items()
               if k.startswith(prefix)) / top["count"]
