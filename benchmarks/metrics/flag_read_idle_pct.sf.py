"""The share of the device's idle time that the jet solve's exit-flag
reads hold, in percent: the seconds inside the `graph.flag_read` spans
(`flag_reads_per_jet.sf`) in which no kernel ran, over the device's idle
seconds at the window's untraced pace (as `harness.idle_pct` reads them:
what the untraced calls took for as many jets, less the kernels' busy
seconds). The profiler stretches the graph launches that follow a read,
not the wait inside it, so neither side counts that stretch. None where
no flag read was traced or no untraced call followed."""
from pathlib import Path

from benchmarks.harness import busy_intervals, import_file

_here = Path(__file__).parent
_reads = import_file(_here / "flag_reads_per_jet.sf.py")
_spans = import_file(_here / "init_idle_s_per_final.dt.py")


def read(rec):
    reads = _reads.flag_reads(rec)
    if not reads:
        return None
    win, k = rec["window"], rec["calls"]
    rest = sum(win.units[k:])
    busy = busy_intervals(rec["events"])
    idle = (sum(win.walls[k:]) / rest * rec["units"]
            - sum(b - a for a, b in busy) / 1e9) if rest else 0
    if idle <= 0:
        return None
    return 100.0 * _spans.idle_seconds(reads, busy) / idle
