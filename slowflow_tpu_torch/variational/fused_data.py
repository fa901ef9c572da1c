"""K3: IRLS data-term assembly from an already-warped window (counterpart of
the TPU kernel `slowflow_tpu.variational.fused_data._kernel`).

`fused_data_system` dispatches on the tensors' device: CPU tensors go to the
plain twin `fused_data_system_ref`, CUDA tensors to the kernel in
csrc/fused_data.cu (or an error). There is no fallback between the two.
The assembly itself is shared with K2 (fused_warp.py): csrc/assemble.cuh on
the card, `fused_data_system_ref` in the twins.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from .terms import (add_data_terms, data_norm, derivative_stacks,
                    occlusion_data_costs, ref_factors, succ_weights)

MODES = {"assembly": (0, 5), "occ": (1, 2), "occ_assembly": (2, 12)}
MAXN = 8           # offsets the kernels support (S <= 5)


def check_mode(p, mode: str, zero_duv: bool) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    if mode == "occ_assembly" and not (zero_duv and not p.one_direction):
        raise ValueError("occ_assembly needs zero_duv and a symmetric window")


def fused_data_system(warped, mask, du, dv, cw, p, *, mode: str = "assembly",
                      zero_duv: bool = False):
    """Assemble the data terms of a warped window.

    warped [B, 2ref+1, 3, H, W]; mask [B, 2ref, H, W], gated in `assembly`
    mode and the raw warp mask (terms.succ_mask) in `occ` / `occ_assembly`
    mode; du, dv [B, H, W] (may be None when zero_duv or outside `assembly`
    mode); cw [B, 3, H, W]. Returns a tuple of [B, H, W] planes:
      assembly     -> a11, a12, a22, b1, b2
      occ          -> e0, e1
      occ_assembly -> e0, e1, 5 past-offset planes, 5 future-offset planes
    """
    if warped.device.type == "cpu":
        return fused_data_system_ref(warped, mask, du, dv, cw, p, mode=mode,
                                     zero_duv=zero_duv)
    if warped.device.type != "cuda":
        raise ValueError(f"fused_data_system: unsupported device "
                         f"{warped.device}")
    return _fused_data_cuda(warped, mask, du, dv, cw, p, mode, zero_duv)


def fused_data_system_ref(warped, mask, du, dv, cw, p, *,
                          mode: str = "assembly", zero_duv: bool = False):
    """Plain PyTorch twin of the K3 kernel (any device): the derivative
    stacks, then the reference assembly / occlusion costs. `occ_assembly`
    splits the offsets into past and future systems."""
    check_mode(p, mode, zero_duv)
    ref = p.ref
    succ, to_ref = derivative_stacks(warped, ref)
    if zero_duv or du is None:
        du = dv = torch.zeros_like(warped[..., 0, 0, :, :])
    if mode == "occ":
        return occlusion_data_costs(mask, succ, to_ref, p)
    if mode == "assembly":
        return add_data_terms(du, dv, mask, succ, to_ref, cw, p)
    e0, e1 = occlusion_data_costs(mask, succ, to_ref, p)
    past = (torch.arange(2 * ref, device=warped.device) < ref).view(-1, 1, 1)
    sys_b = add_data_terms(du, dv, mask * past, succ, to_ref, cw, p)
    sys_f = add_data_terms(du, dv, mask * ~past, succ, to_ref, cw, p)
    return (e0, e1, *sys_b, *sys_f)


@functools.lru_cache(maxsize=64)
def kernel_params(p) -> np.ndarray:
    """Host parameter block of the assembly kernels (csrc/assemble.cuh
    `parse_params`): 15 scalars, then 14 per-offset arrays of MAXN floats.
    Products of weights are rounded to float32 as the twin's tensor ops
    round them. Cached per parameter set (the solve calls the kernels with
    one set hundreds of times); the array is read only."""
    f32 = np.float32
    n = 2 * p.ref
    if n > MAXN:
        raise ValueError(f"the assembly kernels support S <= {MAXN // 2 + 1}, "
                         f"got S = {p.S}")
    color, grad, _ = p.penalties()
    hd, hg = f32(p.delta / 3.0), f32(p.gamma / 3.0)
    rho_w, om_w = succ_weights(p)
    idx = [max(p.ref - s - 1, s - p.ref) for s in range(n)]
    rho_raw = [p.rho[i] for i in idx]
    om_raw = [p.omega[i] for i in idx]
    head = [p.ref, p.delta != 0.0, p.gamma != 0.0, p.dataterm_norm,
            p.one_direction, *color.kernel_args(), *grad.kernel_args(),
            data_norm(p), p.occlusion_penalty]

    def arr(vals):
        out = np.zeros(MAXN, f32)
        out[:n] = vals
        return out

    arrays = [
        arr([f32(r) * hd for r in rho_w]), arr([f32(r) * hg for r in rho_w]),
        arr([f32(o) * hd for o in om_w]), arr([f32(o) * hg for o in om_w]),
        arr([r != 0.0 for r in rho_w]), arr([o != 0.0 for o in om_w]),
        arr([r != 0.0 for r in rho_raw]), arr([o != 0.0 for o in om_raw]),
        arr(ref_factors(p)),
        arr([f32(r) * hd for r in rho_raw]), arr([f32(r) * hg for r in rho_raw]),
        arr([f32(o) * hd for o in om_raw]), arr([f32(o) * hg for o in om_raw]),
        arr([f32(2.0) * f32(r) + f32(2.0) * f32(o)
             for r, o in zip(rho_raw, om_raw)]),
    ]
    out = np.ascontiguousarray(
        np.concatenate([np.asarray(head, f32), *arrays]), f32)
    out.setflags(write=False)   # one array serves every caller
    return out


def _fused_data_cuda(warped, mask, du, dv, cw, p, mode, zero_duv):
    check_mode(p, mode, zero_duv)
    dev = warped.device
    if warped.dim() != 5:
        raise ValueError(f"warped: expected [B, F, 3, H, W], got "
                         f"{tuple(warped.shape)}")
    b, f, _, h, w = warped.shape
    n = 2 * p.ref
    if f != n + 1:
        raise ValueError(f"warped: {f} frames do not match S = {p.S}")
    plane = (b, h, w)
    kernels.require_cuda("warped", warped, (b, f, 3, h, w), dev)
    kernels.require_cuda("mask", mask, (b, n, h, w), dev)
    kernels.require_cuda("cw", cw, (b, 3, h, w), dev)
    uses_duv = mode == "assembly" and not zero_duv
    if uses_duv:
        kernels.require_cuda("du", du, plane, dev)
        kernels.require_cuda("dv", dv, plane, dev)
    mode_id, n_out = MODES[mode]
    params = kernel_params(p)
    out = torch.empty((n_out, b, h, w), dtype=torch.float32, device=dev)
    lib = kernels.load()
    err = lib.sf_fused_data(
        kernels.ptr(warped), kernels.ptr(mask),
        kernels.ptr(du if uses_duv else None),
        kernels.ptr(dv if uses_duv else None), kernels.ptr(cw),
        kernels.ptr(out), b, h, w, mode_id, int(zero_duv or not uses_duv),
        ctypes.c_void_p(params.ctypes.data), params.size,
        kernels.stream_ptr(dev))
    kernels.check(err, "fused_data")
    kernels.count_launch("fused_data")
    return tuple(out.unbind(0))
