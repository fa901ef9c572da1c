"""Seconds inside the port's `dt.init_final` spans (stage 3's per-final
initialization: accumulation, EPIC hypotheses, their energies) in which no
kernel ran on the device, per final pair of the traced calls.

The spans are the port's own (`slowflow_tpu_torch.utils.phases.spans()`),
kept on the profiler's clock while it recorded; each is cut to the traced
calls' time range (from the first to the last of the profiler's records)
and joined with the union of the device's kernel intervals
(`harness.busy_intervals`). None where the port keeps no spans, nothing
was traced, or no such span meets the range."""
from benchmarks.harness import busy_intervals


def traced_spans(rec, name: str, under: str | None = None) -> list[tuple]:
    """(start ns, end ns) of the port's closed `name` spans (with an
    enclosing `under` span, if given) that meet the traced calls' time
    range, cut to it; empty where there are none."""
    from slowflow_tpu_torch.utils import phases

    events = rec.get("events")
    if not events or not hasattr(phases, "spans"):
        return []
    lo = min(e[2] for e in events)
    hi = max(e[3] for e in events)
    kept = phases.spans()[0]

    def inside(s) -> bool:
        while s.parent is not None:
            s = kept[s.parent]
            if s.name == under:
                return True
        return False

    return [(max(s.start_ns, lo), min(s.end_ns, hi)) for s in kept
            if s.name == name and s.end_ns is not None
            and s.start_ns < hi and lo < s.end_ns
            and (under is None or inside(s))]


def union(intervals) -> list[tuple]:
    merged: list[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def idle_seconds(intervals, busy) -> float:
    """Seconds of the union of `intervals` (ns) that no interval of `busy`
    (sorted, disjoint) covers."""
    idle, i = 0, 0
    for a, b in union(intervals):
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        covered, j = 0, i
        while j < len(busy) and busy[j][0] < b:
            covered += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
        idle += (b - a) - covered
    return idle / 1e9


def idle_per_final(rec, name: str):
    if rec.get("events") is None or rec["unit"] != "finals":
        return None
    spans = traced_spans(rec, name)
    if not spans:
        return None
    return idle_seconds(spans, busy_intervals(rec["events"])) / rec["units"]


def read(rec):
    return idle_per_final(rec, "dt.init_final")
