"""Operations and bytes that the port's kernels need for one call, from the
call's shape and the configuration alone, and the peaks of the card.

The counts follow the algorithm, not a kernel's code: float32 operations
per cell (an FMA is 2) and every input plane read once and every output
plane written once. They are the benchmark's own copy, so that a change to
a kernel cannot change the yardstick it is measured by.

K1 (`solve_step`): smoothness weights, two Laplacian right-hand sides and
the 2x2 inverse (the prologue, by smoothing method), `iterations`
red-black sweeps (each cell updated once a sweep), the change sums.
K2 (`warp_assemble`): the bilinear warp of each non-reference frame, the
derivatives of each frame pair an offset uses (successive and to the
reference), their IRLS assembly and, outside `assembly` mode, their
occlusion cost.
"""
from __future__ import annotations

import math

# published figures of one NVIDIA H100 SXM at its 700 W limit: float32
# outside the tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

K1_PROLOGUE_OPS = {0: 70, 1: 105, 2: 65}
K1_SWEEP_OPS, K1_SUMS_OPS = 32, 6
WARP_OPS, DERIV_OPS, OCC_OPS = 40, 222, 30
ASM_OPS = {"succ": 270, "ref": 350}
ZERO_DUV_SAVES = 36
# K2's modes: output planes
K2_OUTPUTS = {"assembly": 5, "occ": 2, "occ_assembly": 12}


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for this work, in seconds, and
    which of the two terms sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return dict(bytes=nbytes, flops=flops, bound_s=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def k1_solve(b: int, h: int, w: int, *, smoothing: int, iterations: int,
             zero_init: bool, sums: bool = True) -> dict:
    """One K1 call on [b, h, w] planes: reads uu, vv, dpsis and the five
    system planes (and du, dv unless the sweeps start from zero), writes
    ndu, ndv and the per-jet sums."""
    n = b * h * w
    nbytes = 4 * n * (8 + (0 if zero_init else 2) + 2) + (8 * b if sums else 0)
    flops = n * (K1_PROLOGUE_OPS[smoothing] + K1_SWEEP_OPS * iterations
                 + (K1_SUMS_OPS if sums else 0))
    return bound(nbytes, flops)


def offsets_used(rho, omega) -> tuple[int, int]:
    """How many of the 2 * ref offsets carry a successive (rho) and a
    to-reference (omega) term; offset s of the past half uses weight
    ref - 1 - s, of the future half s - ref."""
    ref = len(rho)
    idx = [ref - 1 - s if s < ref else s - ref for s in range(2 * ref)]
    return (sum(rho[i] != 0 for i in idx), sum(omega[i] != 0 for i in idx))


def k2_warp_assemble(b: int, h: int, w: int, *, rho, omega, mode: str,
                     zero_duv: bool) -> dict:
    """One K2 call on a window of 2 * len(rho) + 1 frames: reads the
    window, the channel weights, the flow (and the labels in `assembly`
    mode, du / dv unless zero_duv), writes the mode's output planes."""
    f = 2 * len(rho) + 1
    hw = h * w
    planes = (3 * f + 3 + (0 if zero_duv else 2) + K2_OUTPUTS[mode]
              + 2 + (mode == "assembly"))
    n_succ, n_ref = offsets_used(rho, omega)
    per_pair = {}
    for kind in ("succ", "ref"):
        ops = DERIV_OPS
        if mode != "occ":
            ops += ASM_OPS[kind] - (ZERO_DUV_SAVES if zero_duv else 0)
        if mode != "assembly":
            ops += OCC_OPS
        per_pair[kind] = ops
    ops = n_succ * per_pair["succ"] + n_ref * per_pair["ref"] \
        + (f - 1) * WARP_OPS
    return bound(4 * b * hw * planes, b * hw * ops)


def pyramid(h: int, w: int, layers: int, p_scale: float) -> list[tuple]:
    """The (H, W) of each level of the solve's image pyramid, finest first:
    each level floor(p_scale x) the one above, down to `layers` levels or
    until a side would reach the presmoothing filter's order + 1."""
    sigma = 1.0 / math.sqrt(2.0 * p_scale)
    min_size = max(int(math.floor(3 * sigma)) + 1, 1) + 1
    sizes = [(h, w)]
    for _ in range(1, layers):
        nh, nw = (int(math.floor(x * p_scale)) for x in sizes[-1])
        if nh <= min_size or nw <= min_size:
            break
        sizes.append((nh, nw))
    return sizes
