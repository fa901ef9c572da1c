"""K2's share of its roofline, in percent: the least time the card could
take for the K2 (`warp_assemble`) calls of the traced window (work.py,
each call's shape and mode) over the profiler's device time of those
calls. Each call's level comes from its launch configuration, its mode
from the kernel's name (kernel_share.py)."""
from benchmarks import kernel_share


def read(rec):
    return kernel_share.share(rec, "K2")
