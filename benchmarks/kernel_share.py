"""A hand-written kernel's share of its roofline over the traced calls of a
jet-solve cell: the least time its calls could take (work.py, from each
call's shape) over the profiler's device time of them.

Each call's shape comes from the trace alone (its kernel records,
`harness.kernel_launches`). A K2 (`warp_assemble`) record's launch
configuration gives its level: its grid covers one level
of the configuration's pyramid in tiles of its block, [B] jets deep; its
mode is the first argument of the kernel's template. The level order then
gives K1's shapes: each alternation top and outer iteration runs one K2
call and then one K1 (`solve_step`) call at the same level, so the K1
calls' shapes are the K2 calls' shapes, one for one. No record is paired
with another by its place in the trace: the profiler's timestamps of
graph-replayed kernels at times put a K1 record after the next K2 record.
Where the number of K1 or K2 records differs from the calls that the
port's launch counters saw, or from each other, the reading fails: a share
of the wrong calls is no reading.
"""
from __future__ import annotations

import math
import re

from benchmarks import work

K1, K2 = "solve_kernel", "warp_assemble_kernel"
# K2's template argument: the port's MODE_ASSEMBLY, MODE_OCC,
# MODE_OCC_ASSEMBLY
K2_MODES = {0: "assembly", 1: "occ", 2: "occ_assembly"}
_MODE = re.compile(re.escape(K2) + r"<(\d+)")


class TraceMismatch(RuntimeError):
    """The traced records do not account for the traced calls."""


def level_of(levels, config) -> tuple[int, int, int]:
    """(B, H, W) of the pyramid level that a K2 launch (grid, block)
    covers."""
    (gx, gy, gz), (bx, by, _) = config
    hits = [(h, w) for h, w in levels
            if math.ceil(w / bx) == gx and math.ceil(h / by) == gy]
    if len(hits) != 1:
        raise TraceMismatch(f"{K2} grid {config[0]} block {config[1]} "
                            f"covers {len(hits)} of the levels {levels}")
    return (gz,) + hits[0]


def calls(rec) -> tuple[list[tuple], list[float]]:
    """(mode, (B, H, W), device seconds) of each K2 record of the traced
    calls, and the device seconds of each K1 record."""
    cfg = rec["config"]["cfg"]
    levels = work.pyramid(int(rec["config"]["height"]),
                          int(rec["config"]["width"]),
                          int(cfg["slow_flow_layers"]),
                          float(cfg["slow_flow_p_scale"]))
    k2, k1 = [], []
    for name, a, b, grid, block in rec["kernels"]:
        if K2 in name:
            mode = _MODE.search(name)
            if mode is None or len(grid) != 3 or len(block) != 3:
                raise TraceMismatch(f"no mode or launch config in {name!r}")
            k2.append((K2_MODES[int(mode.group(1))],
                       level_of(levels, (grid, block)), (b - a) / 1e9))
        elif K1 in name:
            k1.append((b - a) / 1e9)
    launched = rec["counts"]["launches"]
    for kernel, wrapper, n in (("K1", "solve_step", len(k1)),
                               ("K2", "warp_assemble", len(k2))):
        if n != launched.get(wrapper):
            raise TraceMismatch(f"{n} {kernel} records in the trace, "
                                f"{launched.get(wrapper)} {wrapper} calls "
                                "launched")
    if len(k1) != len(k2):
        raise TraceMismatch(f"{len(k1)} K1 records, {len(k2)} K2 records: "
                            "not one K1 call for each K2 call")
    return k2, k1


def share(rec, kernel: str):
    """`kernel` ("K1" or "K2")'s share of its roofline, in percent; None
    where nothing was traced."""
    if rec.get("kernels") is None or rec["unit"] != "jets":
        return None
    cfg = rec["config"]["cfg"]
    ref = int(cfg["slow_flow_S"]) - 1
    rho = [float(cfg[f"slow_flow_rho_{a}"]) for a in range(ref)]
    omega = [float(cfg[f"slow_flow_omega_{a}"]) for a in range(ref)]
    k2, k1 = calls(rec)
    if kernel == "K1":
        bound_s = sum(work.k1_solve(
            *shape, smoothing=int(cfg["slow_flow_smoothing"]),
            iterations=int(cfg["slow_flow_niter_solver"]),
            zero_init=True)["bound_s"] for _, shape, _ in k2)
        device_s = sum(k1)
    else:
        bound_s = sum(work.k2_warp_assemble(
            *shape, rho=rho, omega=omega, zero_duv=True,
            mode=mode)["bound_s"] for mode, shape, _ in k2)
        device_s = sum(seconds for _, _, seconds in k2)
    return 100.0 * bound_s / device_s if device_s else None
