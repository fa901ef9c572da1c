"""The 90th percentile of the wall time of every call (one batch of jets)
in the window, in ms."""
from benchmarks.harness import quantile


def read(rec):
    if rec["unit"] != "jets":
        return None
    return 1e3 * quantile(rec["window"].walls, 9, 10)
