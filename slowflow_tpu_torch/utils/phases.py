"""Cumulative phase timers, enabled by SF_PROF=1 (the same names and report
as the JAX package's `slowflow_tpu.utils.phases`).

Usage:
    with phase("epic.dt_device"):
        ...
    report()            # prints the cumulative table when enabled
    totals()            # {name: (seconds, count)} without printing

Phases may be entered from several threads at once (the stage-2 CLI's EPIC
prefetch thread beside the solve); the accumulators are updated under a
lock. Each phase measures the host wall time of its own thread.
"""
from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = bool(int(os.environ.get("SF_PROF", "0") or "0"))
_acc: dict = defaultdict(float)
_cnt: dict = defaultdict(int)
_lock = threading.Lock()


@contextmanager
def phase(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


def add(name: str, seconds: float):
    if ENABLED:
        with _lock:
            _acc[name] += seconds
            _cnt[name] += 1


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
