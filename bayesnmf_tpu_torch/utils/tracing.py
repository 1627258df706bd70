"""Named spans of the port's phases: where a fit's time goes, by phase.

Off by default. While off, ``span(name)`` costs one flag check and
returns one shared object that does nothing. Between ``enable()`` and
``disable()`` each span records (name, parent index, t0_ns, t1_ns) on the
host clock (``time.perf_counter_ns``) into an in-memory list, and while a
``torch.profiler`` is recording it also opens
``torch.profiler.record_function(name)``, so that the span lands in the
profiler's trace on the clock of the device's kernels and copies.
``traced(name)`` puts a whole function in a span. ``take()`` returns the
recorded spans and clears them; ``summary(spans)`` gives each name's
count, total seconds and self seconds::

    from bayesnmf_tpu_torch.utils import tracing
    tracing.enable()
    ens.run()
    tracing.disable()
    tracing.summary(tracing.take())["step.prior_update"]

Names are ``<layer>.<part>``: ``fit``, ``ensemble.*`` (construction, run,
chunk, the chunk's metrics read to the host, MAP check, finalisation,
compaction, checkpoint), ``checkpoint.write``, ``chains.step`` /
``chains.record`` (each step of a chunk and the write of its record) and
``step.*`` (the parts of a stream or fused step). Spans nest by the order
they open and close on the one host thread that runs the sampler; the
state is process-wide, as the profiler's is.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

_on = False
_spans: list = []   # Span records by opening order; None while open
_stack: list = []   # the open spans, innermost last


class Span(NamedTuple):
    name: str
    parent: int      # index in the same list; -1 for a root
    t0_ns: int
    t1_ns: int


class _Off:
    """The span while tracing is off: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return None


_OFF = _Off()


class _Open:
    __slots__ = ("name", "store", "i", "parent", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.store = _spans
        self.i = len(_spans)
        _spans.append(None)
        outer = _stack[-1] if _stack else None
        self.parent = outer.i if outer is not None \
            and outer.store is _spans else -1
        _stack.append(self)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, typ, val, tb):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(typ, val, tb)
        _stack.pop()
        # tuple.__new__ skips the named tuple's Python-level __new__
        self.store[self.i] = tuple.__new__(
            Span, (self.name, self.parent, self.t0, t1))
        return None


def span(name: str):
    """A context manager that records ``name`` while tracing is on."""
    return _Open(name) if _on else _OFF


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def enable():
    """Record spans from now on (those already recorded are kept)."""
    global _on
    _on = True


def disable():
    """Stop recording; spans still open record when they close."""
    global _on
    _on = False


def take() -> list:
    """The recorded spans (``Span`` records, in opening order), cleared
    from the recorder. A span still open is None in the list until it
    closes; spans opened afterwards start a new list."""
    global _spans
    out, _spans = _spans, []
    return out


def summary(spans: list) -> dict:
    """{name: {"count", "total_s", "self_s"}} of closed spans: self is a
    span's length less the lengths of its child spans."""
    child = [0] * len(spans)
    for s in spans:
        if s is not None and s.parent >= 0:
            child[s.parent] += s.t1_ns - s.t0_ns
    out: dict = {}
    for i, s in enumerate(spans):
        if s is None:
            continue
        d = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        dt = s.t1_ns - s.t0_ns
        d["count"] += 1
        d["total_s"] += dt / 1e9
        d["self_s"] += (dt - child[i]) / 1e9
    return out
