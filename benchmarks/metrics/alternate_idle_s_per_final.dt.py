"""Seconds inside the port's `dt.alternate` spans (propagation, NMS,
unary and pairwise terms, the TRW-S solve) in which no kernel ran on the
device, per final pair of the traced calls; read as
`init_idle_s_per_final.dt` reads the init's spans."""
from pathlib import Path

from benchmarks.harness import import_file

_init = import_file(Path(__file__).with_name("init_idle_s_per_final.dt.py"))


def read(rec):
    return _init.idle_per_final(rec, "dt.alternate")
