"""K4: bilinear warp of a jet's window frames (counterpart of the TPU kernel
`slowflow_tpu.core.warp_shift._shift_kernel` and its dispatch
`warp_stack_auto_batched`).

`warp_stack` dispatches on the tensors' device: CPU tensors go to the plain
twin `warp_stack_ref` (variational/terms.py `warp_window_frames`), CUDA
tensors to the kernel in csrc/warp_stack.cu (or an error). The kernel is one
gather for any flow; the TPU kernel's shift-grid ladder, anchors and banded
fallback have no counterpart here. `_warp_stack_cuda` also serves K6's entry
(core/warp_pallas.py).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..variational.terms import warp_window_frames

MAXF = 16          # frames the kernel takes per call


def warp_stack(seq, wx, wy, ref: int, rows=None):
    """Warp window frame k by factor (k - ref); frame ref passes through
    with an all-ones mask. seq [B, F, 3, H, W], wx, wy [B, H, W]. `rows`
    (core/rows.py `StripRows`): strip windows, clamped and masked
    against the image's rows.
    Returns (warped [B, F, 3, H, W], masks [B, F, H, W])."""
    if seq.device.type == "cpu":
        return warp_stack_ref(seq, wx, wy, ref, rows)
    if seq.device.type != "cuda":
        raise ValueError(f"warp_stack: unsupported device {seq.device}")
    factors = [float(k - ref) for k in range(seq.shape[1])]
    return _warp_stack_cuda(seq, wx, wy, factors, ref, "warp_stack",
                            rows=rows)


def warp_stack_ref(seq, wx, wy, ref: int, rows=None):
    """Plain PyTorch twin of the K4 kernel (any device)."""
    return warp_window_frames(seq, wx, wy, ref, rows)


def _warp_stack_cuda(seq, wx, wy, factors, identity: int, counter: str,
                     with_mask: bool = True, rows=None):
    """Launch csrc/warp_stack.cu on seq [B, F, C, H, W] with per-frame
    `factors` (F floats); frame `identity` (or none, -1) is copied. Counts
    one launch under LAUNCHES[counter]."""
    dev = seq.device
    if seq.dim() != 5:
        raise ValueError(f"seq: expected [B, F, C, H, W], got "
                         f"{tuple(seq.shape)}")
    b, f, c, h, w = seq.shape
    if len(factors) != f or not 1 <= f <= MAXF:
        raise ValueError(f"{len(factors)} factors for {f} frames "
                         f"(at most {MAXF})")
    kernels.require_cuda("seq", seq, (b, f, c, h, w), dev)
    kernels.require_cuda("wx", wx, (b, h, w), dev)
    kernels.require_cuda("wy", wy, (b, h, w), dev)
    kernels.require_rows(rows, b, h, dev)
    out = torch.empty_like(seq)
    masks = torch.empty((b, f, h, w), dtype=torch.float32, device=dev) \
        if with_mask else None
    fac = np.ascontiguousarray(factors, np.float32)
    lib = kernels.load()
    err = lib.sf_warp_stack(
        kernels.ptr(seq), kernels.ptr(wx), kernels.ptr(wy), kernels.ptr(out),
        kernels.ptr(masks), b, f, c, h, w, ctypes.c_void_p(fac.ctypes.data),
        int(identity), kernels.rows_ptr(rows),
        h if rows is None else rows.img_h, kernels.stream_ptr(dev))
    kernels.check(err, counter)
    kernels.count_launch(counter)
    return out, masks
