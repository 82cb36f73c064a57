"""Spans and counters of the port, on the profiler's clock.

``span(name, device)`` marks one stage of the program; ``count(name)``
counts an event (a host sync, an upload, a kernel launch).  Counters are
always on.  Spans record only while on: after ``enable(True)``, or while a
``torch.profiler`` is recording (the train CLI's ``--profile`` step, a
traced window).  Off, ``span`` returns one shared no-op object.

On, a span records its name, host start and end (``perf_counter_ns``), its
parent (the span open on the same thread when it opened) and the sequence
id of its top-level span, which its descendants share.  Inside a recording
profiler it enters ``torch.profiler.record_function(name)``: a
``user_annotation`` on the kernels' timeline, which then holds the device
times, so the span records none.  Otherwise, with a CUDA ``device`` it
records two pooled CUDA events on the current stream: resolved only by
:func:`summary`, so opening and closing a span never waits for the card.
With a CPU ``device`` its device time is its host time; with no ``device``
(a host-only stage, such as the loader's wait on its worker threads) it
has none.

Closed spans fold into per-name totals (count, host, self and device
seconds, and the counts made while they were open), so memory stays
bounded however long spans stay on.  A span never stays open across a
generator's ``yield``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_ON = False
# the profiler's own process-wide flag, ``_is_profiler_enabled`` (set by
# ``torch.profiler.profile`` on every thread's behalf)
_PROFILER = _autograd_profiler

COUNTS: collections.Counter = collections.Counter()
_GROUPS: Dict[str, List[dict]] = {}
_TOTALS: Dict[str, dict] = {}
# closed spans' (name, start event, end event), oldest first, unresolved
_PENDING: collections.deque = collections.deque()
_POOL: List[torch.cuda.Event] = []
_LOCK = threading.Lock()
_LOCAL = threading.local()
_SEQ = itertools.count()
# closed spans' events waiting past this are resolved as they complete
_PENDING_MAX = 4096


def enable(on: bool = True):
    """Spans on or off for the whole process (counters are always on)."""
    global _ON
    _ON = bool(on)


def event(stream=None) -> torch.cuda.Event:
    """A timing CUDA event from the pool, recorded on ``stream`` (the
    current stream)."""
    ev = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def release(*events: torch.cuda.Event):
    """Events whose times have been read go back to the pool."""
    _POOL.extend(events)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Span:
    """One open or closed span (see the module's docstring)."""

    __slots__ = ("name", "parent", "seq", "start_ns", "end_ns", "child_ns",
                 "counts", "_device", "_cuda", "_events", "_annotation")

    def __init__(self, name: str, device=None):
        self.name = name
        self._device = None if device is None else torch.device(device)
        self._cuda = self._device is not None and self._device.type == "cuda"
        self.child_ns = 0
        self.counts: Optional[collections.Counter] = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.seq = self.parent.seq if self.parent else next(_SEQ)
        stack.append(self)
        # an annotation serves a recording profiler alone, and costs
        # microseconds a span without one; the profiler's trace times the
        # device, and event records under it cost it more
        self._annotation = self._events = None
        if _PROFILER._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        elif self._cuda:
            self._events = (event(torch.cuda.current_stream(self._device)),)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events += (event(torch.cuda.current_stream(self._device)),)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _stack().pop()
        host_ns = self.end_ns - self.start_ns
        if self.parent is not None:
            self.parent.child_ns += host_ns
        with _LOCK:
            t = _TOTALS.get(self.name)
            if t is None:
                t = _TOTALS[self.name] = {
                    "count": 0, "host_ns": 0, "self_ns": 0, "device_ms": 0.0,
                    "timed": 0, "counts": collections.Counter()}
            t["count"] += 1
            t["host_ns"] += host_ns
            t["self_ns"] += host_ns - self.child_ns
            if self.counts:
                t["counts"].update(self.counts)
            if self._events is not None:
                t["timed"] += 1
                _PENDING.append((self.name,) + self._events)
                if len(_PENDING) > _PENDING_MAX:
                    _resolve(wait=False)
            elif self._device is not None and not self._cuda:
                t["timed"] += 1
                t["device_ms"] += host_ns * 1e-6
        return False


def span(name: str, device=None, once: bool = False):
    """A context manager timing the stage ``name`` while spans are on, and
    the shared no-op otherwise.  ``device``: where the stage's work runs
    (``None``: the host alone).  ``once``: no second span of this name
    inside an open one on this thread (the step opened by whichever of
    two nested entry points is called first)."""
    if not (_ON or _PROFILER._is_profiler_enabled):
        return _NOOP
    if once and any(s.name == name for s in _stack()):
        return _NOOP
    return Span(name, device)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``; while spans are on, also to the
    counts of every span open on this thread."""
    with _LOCK:
        COUNTS[name] += n
    if _ON or _PROFILER._is_profiler_enabled:
        for s in _stack():
            if s.counts is None:
                s.counts = collections.Counter()
            s.counts[name] += n


def group(name: str, counts: dict) -> dict:
    """Register a module's own dict of counts (its kernels' ``LAUNCHES``,
    the mesh's ``COLLECTIVES``) as ``name.<key>`` counters; returns the
    same dict, which its module keeps incrementing."""
    _GROUPS.setdefault(name, []).append(counts)
    return counts


def _resolve(wait: bool):
    """Closed spans' device times, read from their events (``wait``: every
    one, waiting for the last; otherwise those already complete, oldest
    first)."""
    while _PENDING:
        name, start, end = _PENDING[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        _TOTALS[name]["device_ms"] += start.elapsed_time(end)
        _PENDING.popleft()
        release(start, end)


def summary() -> dict:
    """``{"spans": {name: {count, host_s, self_s, device_s, counts}},
    "counters": {name: n}}``.  ``device_s`` is ``None`` unless every span
    of the name was timed on its device (host-only spans, and a card's
    spans inside a profiler, are not); ``self_s`` is host time not covered
    by child spans; ``counts``
    are the counters counted while the span was open.  Reads the pending
    device times, waiting for their events: call it once the work is
    done."""
    with _LOCK:
        _resolve(wait=True)
        spans = {name: {"count": t["count"], "host_s": t["host_ns"] * 1e-9,
                        "self_s": t["self_ns"] * 1e-9,
                        "device_s": t["device_ms"] * 1e-3
                        if t["timed"] == t["count"] else None,
                        "counts": dict(t["counts"])}
                 for name, t in _TOTALS.items()}
        counters = dict(COUNTS)
    for name, dicts in _GROUPS.items():
        for d in dicts:
            counters.update({f"{name}.{k}": v for k, v in d.items()})
    return {"spans": spans, "counters": counters}


def reset():
    """Forget every span and zero every counter, the registered groups'
    included (in place)."""
    with _LOCK:
        for _, start, end in _PENDING:
            release(start, end)
        _PENDING.clear()
        _TOTALS.clear()
        COUNTS.clear()
    for dicts in _GROUPS.values():
        for d in dicts:
            for k in d:
                d[k] = 0
