"""Stage timing.

The reference times preprocessing / epic / minimization and writes per-phase
totals to `results.info` / `result.info` (slow_flow.cpp:729-937,
dense_tracking.cpp:1951-1964). `StageTimer` keeps the same discipline (the
same text as the JAX package's `slowflow_tpu.utils.tracing.StageTimer`).
The port's spans on the profiler's clock live in `utils.phases`.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> t = StageTimer()
    >>> with t.stage("epic"): ...
    >>> t.write_info(path, header="SlowFlow variational estimation")
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.rows = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add_row(self, key, value):
        self.rows.append((key, value))

    def summary(self) -> str:
        return "\n".join(f"{name} took {total:.2f}s"
                         f" ({self.counts[name]} calls)."
                         for name, total in self.totals.items())

    def write_info(self, path: str, header: str = "") -> None:
        with open(path, "w") as fh:
            if header:
                fh.write(f"# {header}\n\n")
            fh.write(self.summary() + "\n\n")
            for key, value in self.rows:
                fh.write(f"{key}\t{value}\n")

