"""K2: merged warp + IRLS data-term assembly (counterpart of the TPU kernel
`slowflow_tpu.variational.fused_warp._merged_kernel`, self-masking route).

`warp_assemble` dispatches on the tensors' device: CPU tensors go to the
plain twin `warp_assemble_ref`, CUDA tensors to the kernel in
csrc/warp_assemble.cu (or an error). There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .fused_data import MODES, check_mode, fused_data_system_ref, kernel_params
from .terms import gate_masks, succ_mask, warp_window_frames


def warp_assemble(seq, wx, wy, occ, du, dv, cw, p, *, mode: str = "assembly",
                  zero_duv: bool = False, rows=None):
    """Warp the window by the flow and assemble the data terms.

    seq [B, 2ref+1, 3, H, W]; wx, wy, occ, du, dv [B, H, W]; cw [B, 3, H, W].
    Masks come from the warp coordinates (offset s uses the mask of the s-th
    non-reference frame); in `assembly` mode the occlusion gate of `occ` is
    applied. `occ` may be None outside `assembly` mode, du / dv when
    zero_duv. Returns a tuple of [B, H, W] planes:
      assembly     -> a11, a12, a22, b1, b2
      occ          -> e0, e1
      occ_assembly -> e0, e1, 5 past-offset planes, 5 future-offset planes
    `rows` (core/rows.py `StripRows`): the planes are strip windows;
    the warp clamps and masks against the image's rows.
    """
    if seq.device.type == "cpu":
        return warp_assemble_ref(seq, wx, wy, occ, du, dv, cw, p, mode=mode,
                                 zero_duv=zero_duv, rows=rows)
    if seq.device.type != "cuda":
        raise ValueError(f"warp_assemble: unsupported device {seq.device}")
    return _warp_assemble_cuda(seq, wx, wy, occ, du, dv, cw, p, mode,
                               zero_duv, rows)


def warp_assemble_ref(seq, wx, wy, occ, du, dv, cw, p, *,
                      mode: str = "assembly", zero_duv: bool = False,
                      rows=None):
    """Plain PyTorch twin of the K2 kernel (any device): exact warp, then
    K3's twin on the warped window (gated mask in `assembly` mode)."""
    check_mode(p, mode, zero_duv)
    warped, masks = warp_window_frames(seq, wx, wy, p.ref, rows)
    mask = succ_mask(masks, p.ref)
    if mode == "assembly":
        mask = gate_masks(mask, occ, p)
    return fused_data_system_ref(warped, mask, du, dv, cw, p, mode=mode,
                                 zero_duv=zero_duv)


def _warp_assemble_cuda(seq, wx, wy, occ, du, dv, cw, p, mode, zero_duv,
                        rows):
    check_mode(p, mode, zero_duv)
    dev = seq.device
    b, f, c, h, w = seq.shape
    if f != 2 * p.ref + 1 or c != 3:
        raise ValueError(f"seq: shape {tuple(seq.shape)} does not match "
                         f"S = {p.S}")
    plane = (b, h, w)
    kernels.require_cuda("seq", seq, (b, f, 3, h, w), dev)
    for name, t in (("wx", wx), ("wy", wy)):
        kernels.require_cuda(name, t, plane, dev)
    kernels.require_cuda("cw", cw, (b, 3, h, w), dev)
    kernels.require_rows(rows, b, h, dev)
    if mode == "assembly":
        kernels.require_cuda("occ", occ, plane, dev)
    if not zero_duv:
        kernels.require_cuda("du", du, plane, dev)
        kernels.require_cuda("dv", dv, plane, dev)
    mode_id, n_out = MODES[mode]
    params = kernel_params(p)
    out = torch.empty((n_out, b, h, w), dtype=torch.float32, device=dev)
    lib = kernels.load()
    err = lib.sf_warp_assemble(
        kernels.ptr(seq), kernels.ptr(wx), kernels.ptr(wy),
        kernels.ptr(occ if mode == "assembly" else None),
        kernels.ptr(None if zero_duv else du),
        kernels.ptr(None if zero_duv else dv), kernels.ptr(cw),
        kernels.ptr(out), kernels.rows_ptr(rows),
        h if rows is None else rows.img_h, b, h, w, mode_id, int(zero_duv),
        ctypes.c_void_p(params.ctypes.data), params.size,
        kernels.stream_ptr(dev))
    kernels.check(err, "warp_assemble")
    kernels.count_launch("warp_assemble")
    return tuple(out.unbind(0))
