"""Cumulative phase timers, enabled by SF_PROF=1 (the same names and report
as the JAX package's `slowflow_tpu.utils.phases`), and the port's spans
on the profiler's clock.

Usage:
    with phase("epic.dt_device"):
        ...
    with span("dt.alternate"):            # a span alone: no timer
        ...
    call("graph.flag_read", bool, flag)   # fn(*args) inside a span
    report()            # prints the cumulative table when enabled
    totals()            # {name: (seconds, count)} without printing
    with recording() as rec:   # rec: {name: (seconds, count)} of the block,
        ...                    # with or without SF_PROF, report() or not
    spans()             # (the spans kept while a profiler recorded, dropped)

Phases may be entered from several threads at once (the stage-2 CLI's EPIC
prefetch thread beside the solve); the accumulators are updated under a
lock. Each phase measures the host wall time of its own thread. Only
`phase` times: `span` and `call` sites never reach the SF_PROF report or
a `recording()`.

Spans. While a torch profiler records on the entering thread
(`torch.autograd._profiler_enabled()`, polled where the site opens), a
`phase`, `span` or `call` site opens a profiler range of its name (a host
record: a trace with host operators names its time by it) and keeps a
`Span`: its name, start and end on the profiler's clock (`time.time_ns()`,
the epoch of the profiler's host records), the enclosing span of its
thread (`parent`), the thread, and the outermost span open on that thread
when it began (`root`, itself where none was). `parent` and `root` are
indices into the list that `spans()` returns; at most MAX_SPANS are kept,
the rest counted as dropped. The profiler records each host thread alone,
so spans never nest across threads. With no profiler, no `recording()`
and no SF_PROF, a site costs a flag test and that poll.
"""
from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import NamedTuple

import torch

ENABLED = bool(int(os.environ.get("SF_PROF", "0") or "0"))
_acc: dict = defaultdict(float)
_cnt: dict = defaultdict(int)
_lock = threading.Lock()
_recorders: list[dict] = []

# spans kept at most (a traced b1 benchmark call keeps ~380)
MAX_SPANS = 1 << 20
# (name, start ns, end ns (None while open), parent, thread, root): plain
# tuples of numbers and names, which the garbage collector stops tracking
_spans: list[tuple] = []
_dropped = 0
_span_lock = threading.Lock()
_open = threading.local()   # .stack: indices of this thread's open spans
# whether a profiler records on this thread
_profiling = torch.autograd._profiler_enabled
# a profiler range in C++: its host record lies within ~15 us of the span
_RANGE = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None      # None: still open
    parent: int | None      # index of the enclosing span of its thread
    thread: int
    root: int               # index of its thread's outermost open span


class _Off:
    """The context of a site that neither times nor traces."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Phase:
    """A site that times its block (`timed`), keeps it as a span and a
    profiler range (`traced`), or both."""

    __slots__ = ("name", "traced", "timed", "t0", "span", "range")

    def __init__(self, name: str, traced: bool, timed: bool):
        self.name, self.traced, self.timed = name, traced, timed

    def __enter__(self):
        if self.traced:
            self.range = _RANGE(self.name)
            self.range.__enter__()
            self.span = _open_span(self.name)
        if self.timed:
            self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        if self.timed:
            add(self.name, time.perf_counter() - self.t0)
        if self.traced:
            _close_span(self.span)
            self.range.__exit__(*exc)
        return False


def phase(name: str):
    """A context that times `name` (SF_PROF, `recording()`) and, while a
    profiler records, keeps it as a span and a profiler range."""
    traced = _profiling()
    if traced or ENABLED or _recorders:
        return _Phase(name, traced, ENABLED or bool(_recorders))
    return _OFF


def span(name: str):
    """A context that keeps `name` as a span and a profiler range while a
    profiler records, and does nothing otherwise: no timer."""
    return _Phase(name, True, False) if _profiling() else _OFF


def call(name: str, fn, *args):
    """fn(*args) inside `span(name)`: the form of a hot site (the exit-flag
    reads), which with no profiler costs the poll and the call alone."""
    if _profiling():
        with _Phase(name, True, False):
            return fn(*args)
    return fn(*args)


def _open_span(name: str):
    """(index, record) of a new open span of this thread; None (and one
    more dropped) beyond MAX_SPANS."""
    global _dropped
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    parent = stack[-1] if stack else None
    span = None
    with _span_lock:
        if len(_spans) >= MAX_SPANS:
            _dropped += 1
        else:
            index = len(_spans)
            root = stack[0] if stack and stack[0] is not None else index
            span = (index, (name, time.time_ns(), None, parent,
                            threading.get_ident(), root))
            _spans.append(span[1])
    stack.append(None if span is None else span[0])
    return span


def _close_span(span) -> None:
    end = time.time_ns()
    _open.stack.pop()
    if span is None:
        return
    index, rec = span
    with _span_lock:
        # a span opened before `clear_spans()` is not kept
        if index < len(_spans) and _spans[index] is rec:
            _spans[index] = rec[:2] + (end,) + rec[3:]


def spans() -> tuple[list[Span], int]:
    """(the spans kept so far, in the order they opened; how many were
    dropped beyond MAX_SPANS)."""
    with _span_lock:
        return [Span(*s) for s in _spans], _dropped


def clear_spans() -> None:
    """Forget the spans kept so far (call it with no span open)."""
    global _dropped
    with _span_lock:
        _spans.clear()
        _dropped = 0


def add(name: str, seconds: float):
    if not (ENABLED or _recorders):
        return
    with _lock:
        if ENABLED:
            _acc[name] += seconds
            _cnt[name] += 1
        for rec in _recorders:
            s, n = rec.get(name, (0.0, 0))
            rec[name] = (s + seconds, n + 1)


@contextmanager
def recording():
    """Time every phase of the block, whether SF_PROF is on or not, into
    the dict it yields ({name: (seconds, count)}); `report()` and `reset()`
    leave that dict alone."""
    rec: dict = {}
    with _lock:
        _recorders.append(rec)
    try:
        yield rec
    finally:
        with _lock:
            _recorders.remove(rec)


def totals() -> dict:
    with _lock:
        return {name: (_acc[name], _cnt[name]) for name in _acc}


def reset():
    with _lock:
        _acc.clear()
        _cnt.clear()


def report(reset: bool = True):
    if not ENABLED or not _acc:
        return
    table = totals()
    total = sum(s for s, _ in table.values())
    print("== SF_PROF phase report (cumulative seconds) ==", flush=True)
    for name in sorted(table, key=lambda n: table[n][0], reverse=True):
        s, n = table[name]
        print(f"  {name:<40} {s:9.3f}s  x{n:<5} "
              f"{100.0 * s / max(total, 1e-9):5.1f}%", flush=True)
    print(f"  {'TOTAL(instrumented)':<40} {total:9.3f}s", flush=True)
    if reset:
        with _lock:
            _acc.clear()
            _cnt.clear()
