"""K1: one post-assembly solve step (counterpart of the TPU kernel
`slowflow_tpu.variational.fused_solve._solve_kernel`).

Smoothness weights + two sub_laplacian RHS adjustments + `iterations`
red-black coupled SOR sweeps, optionally with the change sums
(sum |ndu - du|, sum |ndv - dv|) per jet. `solve_step` dispatches on the
tensors' device: CPU tensors go to the plain twin `solve_step_ref`, CUDA
tensors to csrc/solve_step.cu (or an error): one cooperative launch per call,
whose band plan `solve_plan` reports.
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


class SolvePlan(NamedTuple):
    """How csrc/solve_step.cu cuts a [B, H, W] call into bands of rows."""
    resident: bool      # packed arrays in shared memory (else in scratch)
    grid: int           # blocks of the cooperative launch
    nbands: int
    bands_per_jet: int
    rows: int           # rows of the tallest band
    smem_bytes: int     # dynamic shared memory per block
    scratch_floats: int
    threads: int        # per block


def solve_plan(b: int, h: int, w: int, *, k5: bool = False) -> SolvePlan:
    """The band plan of K1 (or K5) at [b, h, w] on the current CUDA device
    (cached by shape and device)."""
    return _solve_plan(b, h, w, k5, torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _solve_plan(b: int, h: int, w: int, k5: bool, device_index: int):
    out = (ctypes.c_longlong * 8)()
    kernels.check(kernels.load().sf_solve_plan(int(k5), b, h, w, out),
                  "solve_plan")
    return SolvePlan(bool(out[0]), *out[1:])


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
        kernels.require_f32_cuda(name, t, (b, h, w), dev)
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
