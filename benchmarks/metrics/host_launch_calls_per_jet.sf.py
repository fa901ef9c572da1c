"""Host calls that put work on the device (kernel launches and graph
replays) in the traced calls, per jet: the dispatch cost of the jet
solve."""
from benchmarks.harness import HOST_LAUNCH_CALLS


def read(rec):
    if rec.get("events") is None or rec["unit"] != "jets":
        return None
    n = sum(1 for name, on_dev, _, _ in rec["events"]
            if not on_dev and name in HOST_LAUNCH_CALLS)
    return n / rec["units"] if n else None
