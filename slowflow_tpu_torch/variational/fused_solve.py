"""K1: one post-assembly solve step (counterpart of the TPU kernel
`slowflow_tpu.variational.fused_solve._solve_kernel`).

Smoothness weights + two sub_laplacian RHS adjustments + `iterations`
red-black coupled SOR sweeps, optionally with the change sums
(sum |ndu - du|, sum |ndv - dv|) per jet. `solve_step` dispatches on the
tensors' device: CPU tensors go to the plain twin `solve_step_ref`, CUDA
tensors to csrc/solve_step.cu (or an error): one cooperative launch per call,
whose plan (resident, grouped or row-streamed) `solve_plan` reports and
`plan_model` mirrors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import kernels
from ..core.solver import sor_coupled_rb
from ..core.rows import own_rows
from .terms import compute_smoothness_mt, sub_laplacian


def solve_step(uu, vv, dpsis, a11, a12, a22, b1, b2, du=None, dv=None, *,
               alpha: float, reg_pen, method: int, iterations: int,
               omega: float, with_change: bool = False, rows=None):
    """All planes [B, H, W] float32. du / dv None means the sweeps start
    from zero. Returns (ndu, ndv) or, with `with_change`, (ndu, ndv, sums)
    with sums [B, 2]. `rows` (core/rows.py `StripRows`): the planes
    are strip windows; the colours follow the image's rows and the sums
    cover each window's own rows."""
    kw = dict(alpha=alpha, reg_pen=reg_pen, method=method,
              iterations=iterations, omega=omega, with_change=with_change,
              rows=rows)
    if uu.device.type == "cpu":
        return solve_step_ref(uu, vv, dpsis, a11, a12, a22, b1, b2, du, dv,
                              **kw)
    if uu.device.type != "cuda":
        raise ValueError(f"solve_step: unsupported device {uu.device}")
    return _solve_step_cuda(uu, vv, dpsis, a11, a12, a22, b1, b2, du, dv,
                            **kw)


def solve_step_ref(uu, vv, dpsis, a11, a12, a22, b1, b2, du=None, dv=None,
                   *, alpha: float, reg_pen, method: int, iterations: int,
                   omega: float, with_change: bool = False, rows=None):
    """Plain PyTorch twin of the K1 kernel (any device)."""
    du0 = torch.zeros_like(uu) if du is None else du
    dv0 = torch.zeros_like(vv) if dv is None else dv
    wh, wv = compute_smoothness_mt(uu, vv, dpsis, alpha, reg_pen, method)
    b1 = sub_laplacian(b1, uu, wh, wv)
    b2 = sub_laplacian(b2, vv, wh, wv)
    ndu, ndv = sor_coupled_rb(du0, dv0, a11, a12, a22, b1, b2, wh, wv,
                              iterations=iterations, omega=omega, rows=rows)
    if not with_change:
        return ndu, ndv
    cu, cv = (ndu - du0).abs(), (ndv - dv0).abs()
    if rows is not None:
        own = own_rows(rows, uu.shape[-2])
        zero = torch.zeros((), device=uu.device)
        cu, cv = torch.where(own, cu, zero), torch.where(own, cv, zero)
    sums = torch.stack([cu.sum((-2, -1)), cv.sum((-2, -1))], -1)
    return ndu, ndv, sums


# csrc/solve_step.cu's constants: threads a block, the row-streamed rings'
# rows of the updated and of the other colour, packed cells of a ring row
# at most, block_sum's static shared bytes
NT, RING_OWN, RING_NBR, CHUNK = 512, 4, 5, 960
STATIC_SMEM = 2 * NT * 4
REGIMES = ("resident", "grouped", "row-streamed")


class SolvePlan(NamedTuple):
    """How csrc/solve_step.cu cuts a [B, H, W] call: the batch into groups
    of jets, each jet into bands of rows. resident: one group, every band
    a block with its arrays in shared memory; grouped: the same, group by
    group; row-streamed: the arrays in scratch, each band's rows streamed
    through a ring of shared memory in chunks of packed cells."""
    regime: str         # one of REGIMES
    grid: int           # blocks of the cooperative launch
    nbands: int         # B x bands_per_jet
    bands_per_jet: int
    rows: int           # rows of the tallest band
    smem_bytes: int     # dynamic shared memory per block
    scratch_floats: int
    threads: int        # per block
    group: int          # jets a group
    groups: int
    chunk: int          # row-streamed: packed cells of a ring chunk (else 0)
    chunks: int         # row-streamed: chunks of a row (else 0)

    @property
    def resident(self) -> bool:
        return self.regime == "resident"


def region_floats(rows: int, hwp: int) -> int:
    """Floats of one band's packed arrays (solve_step.cu region_floats)."""
    return 2 * hwp * (9 * rows + 5)


def plan_model(b: int, h: int, w: int, *, nsm: int, optin: int) -> SolvePlan:
    """The plan csrc/solve_step.cu's make_plan makes at [b, h, w] on a card
    of `nsm` SMs and `optin` shared bytes a block: the most jets G_max whose
    bands fit one block per SM, G = ceil(b / ceil(b / G_max)) jets a group;
    row-streamed where not even one jet's bands fit."""
    hwp = (w + 1) // 2
    limit = optin - STATIC_SMEM

    def cdiv(x, y):
        return -(-x // y)

    def bands(g):
        bpj = min(h, max(1, nsm // g))
        return bpj, cdiv(h, bpj)

    gmax = next((g for g in range(min(b, nsm), 0, -1)
                 if region_floats(bands(g)[1], hwp) * 4 <= limit), 0)
    if gmax:
        groups = cdiv(b, gmax)
        group = cdiv(b, groups)
        bpj, rows = bands(group)
        regime = REGIMES[0] if groups == 1 else REGIMES[1]
        grid, smem, region, chunk, chunks = (
            group * bpj, region_floats(rows, hwp) * 4, 0, 0, 0)
    else:
        regime, group, groups = REGIMES[2], b, 1
        bpj, rows = bands(b)
        grid = min(b * bpj, nsm)
        hwp = cdiv(hwp, 4) * 4          # 16-byte rows for the ring's copies
        chunks = cdiv(hwp, CHUNK)
        chunk = cdiv(cdiv(hwp, chunks), 4) * 4
        smem = (RING_OWN * 9 * chunk + RING_NBR * (4 * chunk + 24)) * 4 \
            + RING_NBR * 8                  # the rings and their mbarriers
        region = region_floats(rows, hwp)
    nbands = b * bpj
    return SolvePlan(regime, grid, nbands, bpj, rows, smem,
                     nbands * (16 * hwp + 2) + nbands * region, NT, group,
                     groups, chunk, chunks)


def plan_groups(plan: SolvePlan, b: int) -> list[range]:
    """The jets of each group of `plan` for a batch of b, in the order the
    kernel walks them: group g holds jets [g b // groups, (g + 1) b //
    groups)."""
    return [range(g * b // plan.groups, (g + 1) * b // plan.groups)
            for g in range(plan.groups)]


# The floors K1 / K5's times are held against: one half-sweep's exchange and
# grid barriers on chip (an H100 at 700 W, kernel_variants.py's no_compute
# variant), and a sweep's HBM traffic per cell (the 9 system planes read,
# du / dv written) at an H100 SXM's 3.35 TB/s.
HALF_SWEEP_FLOOR_US = 1.16
SOLVE_BYTES_PER_CELL = 44
HBM_BYTES_PER_S = 3.35e12


def solve_floors(plan: SolvePlan, b: int, h: int, w: int,
                 iterations: int) -> dict:
    """The group floor of `plan` at [b, h, w] (groups x 2 * iterations
    half-sweeps at the exchange floor) and, for a row-streamed plan, its
    HBM floor (the system read and du / dv written once a sweep), in ms."""
    return dict(
        group_floor_ms=plan.groups * 2 * iterations * HALF_SWEEP_FLOOR_US
        / 1e3,
        hbm_floor_ms=SOLVE_BYTES_PER_CELL * b * h * w * iterations
        / HBM_BYTES_PER_S * 1e3 if plan.regime == REGIMES[2] else None)


def solve_plan(b: int, h: int, w: int) -> SolvePlan:
    """The plan of K1 and K5 at [b, h, w] on the current CUDA device, as
    the kernel library makes it (cached by shape and device)."""
    return _solve_plan(b, h, w, torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _solve_plan(b: int, h: int, w: int, device_index: int):
    out = (ctypes.c_longlong * 12)()
    kernels.check(kernels.load().sf_solve_plan(b, h, w, out), "solve_plan")
    return SolvePlan(REGIMES[out[0]], *out[1:])


def _solve_step_cuda(uu, vv, dpsis, a11, a12, a22, b1, b2, du, dv, *,
                     alpha, reg_pen, method, iterations, omega, with_change,
                     rows):
    dev = uu.device
    if uu.dim() != 3:
        raise ValueError(f"uu: expected [B, H, W], got {tuple(uu.shape)}")
    if (du is None) != (dv is None):
        raise ValueError("du and dv must both be given or both be None")
    if method not in (0, 1, 2):
        raise ValueError(f"smoothing method {method} not in (0, 1, 2)")
    b, h, w = uu.shape
    named = dict(uu=uu, vv=vv, dpsis=dpsis, a11=a11, a12=a12, a22=a22,
                 b1=b1, b2=b2)
    if du is not None:
        named.update(du=du, dv=dv)
    for name, t in named.items():
        kernels.require_cuda(name, t, (b, h, w), dev)
    kernels.require_rows(rows, b, h, dev)
    ndu = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    ndv = torch.empty_like(ndu)
    n_scratch = solve_plan(b, h, w).scratch_floats
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    sums = torch.empty((b, 2), dtype=torch.float32, device=dev) \
        if with_change else None
    fct, eps_sq, trunc, trunc_val = reg_pen.kernel_args()
    lib = kernels.load()
    err = lib.sf_solve_step(
        *(kernels.ptr(t) for t in (uu, vv, dpsis, a11, a12, a22, b1, b2, du,
                                   dv, ndu, ndv, scratch)), n_scratch,
        kernels.ptr(sums), kernels.rows_ptr(rows), b, h, w, int(method),
        int(fct), eps_sq, trunc,
        trunc_val,
        float(alpha), int(iterations), float(omega), kernels.stream_ptr(dev))
    kernels.check(err, "solve_step")
    kernels.count_launch("solve_step")
    return (ndu, ndv, sums) if with_change else (ndu, ndv)
