"""Host reads of the jet solve's loop-exit flags (the port's
`graph.flag_read` spans inside a `sf.call` span: each a device-to-host
round trip between segment replays) in the traced calls, per jet.

The spans are the port's own (`slowflow_tpu_torch.utils.phases.spans()`),
kept on the profiler's clock while it recorded; those that meet the
traced calls' time range (`init_idle_s_per_final.dt.traced_spans`)
count. None where the port keeps no spans, nothing was traced, or no flag
read meets the range."""
from pathlib import Path

from benchmarks.harness import import_file

_spans = import_file(Path(__file__).with_name("init_idle_s_per_final.dt.py"))


def flag_reads(rec) -> list[tuple]:
    """(start ns, end ns) of the jet solve's flag reads in the traced
    calls' time range; empty where there are none."""
    if rec["unit"] != "jets":
        return []
    return _spans.traced_spans(rec, "graph.flag_read", under="sf.call")


def read(rec):
    reads = flag_reads(rec)
    return len(reads) / rec["units"] if reads else None
