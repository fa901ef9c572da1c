"""The share of the traced calls' work in which no kernel ran on the
device, in percent, at the window's untraced pace (harness.idle_pct): the
kernels' busy seconds against what the untraced calls took for as many
finals."""
from benchmarks.harness import idle_pct


def read(rec):
    return idle_pct(rec) if rec["unit"] == "finals" else None
