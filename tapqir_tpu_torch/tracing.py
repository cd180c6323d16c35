"""Spans at the layer boundaries of the fit, and a count of host-device syncs.

Off by default. ``span(name)`` is a context manager; while tracing is off it
is one shared no-op object, returned after a single flag check, so the fit
pays nothing for its spans. :func:`enable` turns tracing on:

* each span times itself on ``time.perf_counter_ns`` and is kept in memory
  as an aggregate per name: calls, total ns, self ns (total less the time
  its child spans cover), the syncs counted while it was the innermost open
  span, and its parents (the innermost span still open on the same thread
  when it opened) with their counts;
* on a CUDA machine the synchronizing operations are counted:
  ``torch.cuda.set_sync_debug_mode("warn")`` makes each one raise a
  warning, which is counted against the innermost open span and not
  printed (syncs of the backward pass's threads arrive when
  ``torch.autograd.grad`` returns). On the CPU the count is 0.

While a ``torch.profiler`` records (``torch.autograd.profiler
._is_profiler_enabled``), each span also opens a
``record_function("span::<name>")`` range, so it sits in the Chrome trace on
the device trace's clock. Such spans, and every span open around them, are
kept apart: :func:`summary` gives the spans that ran outside the profiler,
whose host times carry none of its overhead (``summary(profiled=True)``
the others).

Span names are ``<layer>.<what>``: ``fit.*`` and ``checkpoint.*`` (the fit
loop), ``step.*`` (the sparse step's own work), ``elbo.*``.
"""

import threading
import time
import warnings
from collections import defaultdict

import torch
from torch.autograd import profiler as _profiler

_SYNC_MESSAGE = "called a synchronizing CUDA operation"


class _Off:
    """The span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Tracer:
    """Tracing's state: the flag, the aggregates, the open spans of each
    thread and what :meth:`enable` changed (the sync debug mode, the
    warning filters and ``warnings.showwarning``)."""

    def __init__(self):
        self.on = False
        self.kept = {}
        self.profiled = {}
        self.local = threading.local()
        self.saved = None  # (sync debug mode, warning filters) to put back
        self.show = warnings.showwarning

    def stack(self):
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def enable(self):
        if self.on:
            return
        if torch.cuda.is_available():
            filters = warnings.filters[:]
            warnings.filterwarnings("always", message=_SYNC_MESSAGE, category=UserWarning)
            self.saved = (torch.cuda.get_sync_debug_mode(), filters)
            self.show = warnings.showwarning
            warnings.showwarning = self.count_sync
            torch.cuda.set_sync_debug_mode("warn")
        self.on = True

    def disable(self):
        if not self.on:
            return
        self.on = False
        if self.saved is not None:
            mode, filters = self.saved
            self.saved = None
            torch.cuda.set_sync_debug_mode(mode)
            if warnings.showwarning == self.count_sync:
                warnings.showwarning = self.show
            warnings.filters[:] = filters

    def count_sync(self, message, category, filename, lineno, file=None, line=None):
        if _SYNC_MESSAGE in str(message):
            stack = self.stack()
            if stack:
                stack[-1].syncs += 1
            return
        self.show(message, category, filename, lineno, file, line)

    def record(self, sp, total_ns, parent):
        table = self.profiled if sp.profiled else self.kept
        agg = table.get(sp.name)
        if agg is None:
            agg = table[sp.name] = {"calls": 0, "total_ns": 0, "self_ns": 0, "syncs": 0,
                                    "parents": defaultdict(int)}
        agg["calls"] += 1
        agg["total_ns"] += total_ns
        agg["self_ns"] += total_ns - sp.child_ns
        agg["syncs"] += sp.syncs
        if parent is not None:
            agg["parents"][parent.name] += 1


_tracer = _Tracer()


def _mark_profiled(stack):
    for sp in stack:
        sp.profiled = True


class _Span:
    __slots__ = ("name", "start", "child_ns", "syncs", "profiled", "range")

    def __init__(self, name):
        self.name = name
        self.child_ns = 0
        self.syncs = 0
        self.profiled = False
        self.range = None

    def __enter__(self):
        stack = _tracer.stack()
        stack.append(self)
        if _profiler._is_profiler_enabled:
            _mark_profiled(stack)
            self.range = torch.profiler.record_function("span::" + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter_ns() - self.start
        stack = _tracer.stack()
        stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        if _profiler._is_profiler_enabled:
            self.profiled = True
            _mark_profiled(stack)
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += total
        _tracer.record(self, total, parent)
        return False


def span(name):
    """A span named ``name`` (``<layer>.<what>``) around a ``with`` block."""
    if not _tracer.on:
        return _OFF
    return _Span(name)


def enable():
    """Turn tracing on (and, on a CUDA machine, the count of syncs)."""
    _tracer.enable()


def disable():
    """Turn tracing off and put back the sync debug mode and the warnings'
    handling as :func:`enable` found them; the aggregates are kept."""
    _tracer.disable()


def enabled():
    """Whether tracing is on."""
    return _tracer.on


def reset():
    """Forget every aggregate."""
    _tracer.kept.clear()
    _tracer.profiled.clear()


def summary(profiled=False):
    """The aggregates of the spans that ran outside the profiler (with
    ``profiled=True``: inside it), by name: ``calls``, ``total_ns``,
    ``self_ns``, ``syncs`` and ``parents`` (parent name -> calls)."""
    table = _tracer.profiled if profiled else _tracer.kept
    return {name: dict(agg, parents=dict(agg["parents"])) for name, agg in table.items()}
