"""K6's entry: warp of a frame stack by any per-frame factors (counterpart of
the TPU kernel `slowflow_tpu.core.warp_pallas._kernel`, wrappers
`warp_stack_pallas` and `warp_bilinear_pallas`).

The TPU kernel is a banded one-hot matrix contraction, exact only inside
its band; on the card it is K4's gather kernel (csrc/warp_stack.cu), exact
for any flow, counted under LAUNCHES["warp_stack_pallas"]. Every frame is
warped, factor 0 included, and the masks come from the coordinates. CPU
tensors go to the plain twins (core/warp.py `warp_bilinear` per frame).
"""
from __future__ import annotations

import torch

from .warp import warp_bilinear
from .warp_shift import _warp_stack_cuda


def warp_stack_pallas(seq, wx, wy, factors, rows=None):
    """seq [B, F, C, H, W], wx, wy [B, H, W], factors: F floats; `rows` as
    for K4 (core/warp_shift.py `warp_stack`).
    Returns (warped [B, F, C, H, W], masks [B, F, H, W])."""
    factors = [float(f) for f in factors]
    if seq.device.type == "cpu":
        return warp_stack_pallas_ref(seq, wx, wy, factors, rows)
    if seq.device.type != "cuda":
        raise ValueError(f"warp_stack_pallas: unsupported device "
                         f"{seq.device}")
    return _warp_stack_cuda(seq, wx, wy, factors, -1, "warp_stack_pallas",
                            rows=rows)


def warp_stack_pallas_ref(seq, wx, wy, factors, rows=None):
    """Plain PyTorch twin of K6's entry (any device)."""
    pairs = [warp_bilinear(seq[:, k], wx, wy, float(f), rows)
             for k, f in enumerate(factors)]
    return (torch.stack([o for o, _ in pairs], 1),
            torch.stack([m for _, m in pairs], 1))


def warp_bilinear_pallas(src, wx, wy, factor: float = 1.0,
                         with_mask: bool = True):
    """core/warp.py `warp_bilinear`'s contract: src [..., C, H, W], flow
    [..., H, W] with src's leading dims. Returns (warped, mask or None)."""
    if src.device.type == "cpu":
        out, mask = warp_bilinear(src, wx, wy, factor)
        return out, (mask if with_mask else None)
    if src.device.type != "cuda":
        raise ValueError(f"warp_bilinear_pallas: unsupported device "
                         f"{src.device}")
    c, h, w = src.shape[-3:]
    lead = src.shape[:-3]
    if tuple(wx.shape) != (*lead, h, w):
        raise ValueError(f"flow {tuple(wx.shape)} does not match src "
                         f"{tuple(src.shape)}")
    out, mask = _warp_stack_cuda(src.reshape(-1, 1, c, h, w).contiguous(),
                                 wx.reshape(-1, h, w).contiguous(),
                                 wy.reshape(-1, h, w).contiguous(),
                                 [float(factor)], -1, "warp_stack_pallas",
                                 with_mask)
    out = out.view(src.shape)
    return out, (mask.view(wx.shape) if with_mask else None)
