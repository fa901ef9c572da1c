"""K5: red-black coupled SOR sweeps on a given system (counterpart of the TPU
kernel `slowflow_tpu.core.solver_pallas._sor_kernel`, wrapper
`sor_coupled_rb_pallas`).

`sor_coupled_rb_pallas` dispatches on the tensors' device: CPU tensors go to
the plain twin core/solver.py `sor_coupled_rb`, CUDA tensors to
`sf_sor_coupled_rb` in csrc/solve_step.cu (or an error). The kernel zeroes
the boundary weights and forms the 2x2 inverse in its prologue, as the TPU
wrapper does before its kernel, then runs K1's sweep core, all in one
cooperative launch.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..variational.fused_solve import solve_plan
from .solver import sor_coupled_rb


def sor_coupled_rb_pallas(du, dv, a11, a12, a22, b1, b2, wh, wv, *,
                          iterations: int = 30, omega: float = 1.9,
                          rows=None):
    """All planes [..., H, W] float32; du, dv are the starting increment.
    `rows` (core/rows.py `StripRows`, planes [E, H, W]): strip
    windows, coloured by the image's rows. Returns new (du, dv); the inputs
    are left as they were."""
    if du.device.type == "cpu":
        return sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv,
                              iterations=iterations, omega=omega, rows=rows)
    if du.device.type != "cuda":
        raise ValueError(f"sor_coupled_rb_pallas: unsupported device "
                         f"{du.device}")
    dev = du.device
    shape = tuple(du.shape)
    if len(shape) < 2:
        raise ValueError(f"du: expected [..., H, W], got {shape}")
    h, w = shape[-2:]
    named = dict(du=du, dv=dv, a11=a11, a12=a12, a22=a22, b1=b1, b2=b2,
                 wh=wh, wv=wv)
    for name, t in named.items():
        kernels.require_cuda(name, t, shape, dev)
    b = du.numel() // (h * w)
    kernels.require_rows(rows, b, h, dev)
    ndu = torch.empty_like(du)
    ndv = torch.empty_like(dv)
    n_scratch = solve_plan(b, h, w).scratch_floats
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    lib = kernels.load()
    err = lib.sf_sor_coupled_rb(
        *(kernels.ptr(t) for t in (du, dv, a11, a12, a22, b1, b2, wh, wv,
                                   ndu, ndv, scratch)), n_scratch,
        kernels.rows_ptr(rows), b, h, w, int(iterations), float(omega),
        kernels.stream_ptr(dev))
    kernels.check(err, "sor")
    kernels.count_launch("sor")
    return ndu, ndv
