"""The share of the device's idle time in the traced calls that the jet
solve's exit-flag reads hold, in percent: the seconds inside the
`graph.flag_read` spans (`flag_reads_per_jet.sf`) in which no kernel ran,
over the seconds of the traced calls' time range (from the first to the
last of the profiler's records) in which no kernel ran. Both sides come
from the one traced range on the profiler's clock, and the spans are cut
to it, so the share cannot pass 100. None where no flag read was traced
or the device was never idle in the range."""
from pathlib import Path

from benchmarks.harness import busy_intervals, import_file

_here = Path(__file__).parent
_reads = import_file(_here / "flag_reads_per_jet.sf.py")
_spans = import_file(_here / "init_idle_s_per_final.dt.py")


def read(rec):
    reads = _reads.flag_reads(rec)
    if not reads:
        return None
    events = rec["events"]
    busy = busy_intervals(events)
    whole = (min(e[2] for e in events), max(e[3] for e in events))
    idle = _spans.idle_seconds([whole], busy)
    if idle <= 0:
        return None
    return 100.0 * _spans.idle_seconds(reads, busy) / idle
