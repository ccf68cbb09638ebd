"""Spans at the port's layer boundaries: the engine's phases (a step, an
admission, each prefill group, each decode wave, each device read), the
model's (each block's mixer and FFN halves, the Engram retrieval and
fusion, the head) and the host tables' mapping.

    from repro_torch import trace
    trace.enable(True)
    ...                                   # serve
    for name, t0_ns, t1_ns, parent, attrs in trace.drain():
        ...

``span(name, **attrs)`` is a context manager. Off (the default) it
returns one shared no-op context: no clock read, no record, no profiler
range. On, it appends ``Span(name, t0_ns, t1_ns, parent, attrs)`` to an
in-memory list, stamped with ``time.perf_counter_ns()``; ``parent`` is
the index in that list of the span enclosing it on the same thread
(None at the top). The counts at a boundary travel as ``attrs``; a span's
body may add some once it knows them (``with span(...) as a: a["n"] =
...``; off, the assignment goes nowhere). ``drain()`` returns the
recorded spans and clears them.

While spans are on and a ``torch.profiler`` session records, each span
also opens ``torch.profiler.record_function`` under its name, so it shows
among the trace's host events (and, on the card, as a
``gpu_user_annotation`` over the kernels it launched), on the trace's
own clock. To see the spans beside the kernels:

    trace.enable(True)
    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        ...                               # serve
    prof.export_chrome_trace("trace.json")

Every name starts with ``repro_torch.``, so no span is mistaken for one
of the port's custom operators (``repro_torch::...``).
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import torch

_on = False
_spans: list = []              # [name, t0_ns, t1_ns, parent, attrs]
_lock = threading.Lock()       # a span's index and its append, together
_local = threading.local()     # .open: indices of this thread's open spans


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[int]
    attrs: dict


class _Off:
    """The shared context every span returns while spans are off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setitem__(self, key, value):
        pass


_OFF = _Off()


class _On:
    __slots__ = ("rec", "prof")

    def __init__(self, name: str, attrs: dict):
        self.rec = [name, 0, 0, None, attrs]
        self.prof = None

    def __enter__(self) -> dict:
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        rec = self.rec
        if stack:
            rec[3] = stack[-1]
        with _lock:
            stack.append(len(_spans))
            _spans.append(rec)
        if torch.autograd._profiler_enabled():
            self.prof = torch.profiler.record_function(rec[0])
            self.prof.__enter__()
        rec[1] = time.perf_counter_ns()
        return rec[4]

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        _local.open.pop()
        return False


def span(name: str, **attrs):
    """A span named ``repro_torch.<name>`` over the ``with`` body."""
    if not _on:
        return _OFF
    return _On("repro_torch." + name, attrs)


def enable(on: bool) -> None:
    """Switch spans on or off (off by default)."""
    global _on
    _on = bool(on)


def drain() -> list:
    """The spans recorded since the last drain, as ``Span``s, in the order
    they opened; clears them. Call it with no span open."""
    with _lock:
        out = [Span(*rec) for rec in _spans]
        _spans.clear()
    return out
