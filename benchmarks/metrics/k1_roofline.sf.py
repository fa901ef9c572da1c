"""K1's share of its roofline, in percent: the least time the card could
take for the K1 (`solve_step`) calls of the traced window (work.py, each
call's shape) over the profiler's device time of those calls. The K1
calls' shapes are the K2 calls' shapes, one for one, as the level order
runs them (kernel_share.py)."""
from benchmarks import kernel_share


def read(rec):
    return kernel_share.share(rec, "K1")
