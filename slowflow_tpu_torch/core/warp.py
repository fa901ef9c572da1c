"""Bilinear warp with in-bounds mask (torch port of
`slowflow_tpu.core.warp.warp_bilinear`), written as the exact 4-corner gather.

Sample src at (x + factor*wx, y + factor*wy); each corner index is clamped to
the image on its own; the mask is 1 iff the continuous coordinate lies in
[0, W-1] x [0, H-1]. The JAX package's banded one-hot form is a TPU
workaround for slow gathers and has no counterpart here.

With `rows` (core/rows.py `StripRows`) src and the flow are windows of
taller images: row i of window e is image row row0_e + i, the corners are
clamped and the mask taken against the image's rows, and a corner outside
the window reads the window's nearest row (the strip plan sizes windows so
that no sample with a nonzero weight that matters does).
"""
from __future__ import annotations

import torch

from .rows import row_offsets


def warp_bilinear(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                  factor: float = 1.0, rows=None):
    """Warp `src` [..., C, H, W] by the flow (wx, wy) [..., H, W] scaled by
    `factor`; the flow's leading dims must match src's before C. `rows`:
    the windows' places in their image (flow [E, H, W], module docstring).

    Returns (warped [..., C, H, W], mask [..., H, W] float32)."""
    h, w = src.shape[-2:]
    img_h = h if rows is None else rows.img_h
    yy = torch.arange(h, device=src.device)[:, None]
    if rows is not None:
        if wx.dim() != 3 or wx.shape[0] != rows.table.shape[0]:
            raise ValueError(f"rows for {rows.table.shape[0]} windows, flow "
                             f"{tuple(wx.shape)}")
        row0 = row_offsets(rows)
        yy = row0 + yy
    yy = yy.to(wx.dtype)
    xx = torch.arange(w, device=src.device, dtype=wx.dtype)[None, :]
    x = xx + factor * wx
    y = yy + factor * wy
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0).unsqueeze(-3)
    dy = (y - y0).unsqueeze(-3)
    x0i = x0.long()
    y0i = y0.long()
    x0c = x0i.clamp(0, w - 1)
    x1c = (x0i + 1).clamp(0, w - 1)
    y0c = y0i.clamp(0, img_h - 1)
    y1c = (y0i + 1).clamp(0, img_h - 1)
    if rows is not None:
        y0c = (y0c - row0).clamp(0, h - 1)
        y1c = (y1c - row0).clamp(0, h - 1)

    flat = src.flatten(-2)                                  # [..., C, H*W]

    def corner(yc, xc):
        idx = (yc * w + xc).flatten(-2).unsqueeze(-2)       # [..., 1, H*W]
        idx = idx.expand(*flat.shape[:-1], h * w)
        return flat.gather(-1, idx).view(src.shape)

    top = (1.0 - dx) * corner(y0c, x0c) + dx * corner(y0c, x1c)
    bot = (1.0 - dx) * corner(y1c, x0c) + dx * corner(y1c, x1c)
    out = (1.0 - dy) * top + dy * bot
    mask = ((x >= 0) & (x <= w - 1) & (y >= 0)
            & (y <= img_h - 1)).to(src.dtype)
    return out, mask


def _warp_planes(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                 factor: float = 1.0):
    """`warp_bilinear` of every [H, W] plane of src [..., H, W] by one flow
    (wx, wy) [H, W]. Returns (warped [..., H, W], mask [H, W])."""
    h, w = src.shape[-2:]
    out, mask = warp_bilinear(src.reshape(-1, h, w), wx, wy, factor)
    return out.reshape(src.shape), mask


def warp_image(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """Two-frame warp (variational_aux.c:18-52): src [..., H, W] sampled at
    (x + wx, y + wy). Returns (warped, in-bounds mask [H, W])."""
    return _warp_planes(src, wx, wy)


def warp_backward(img: torch.Tensor, flow: torch.Tensor, scale: float = 1.0):
    """Backward warp (utils/utils.cpp:286-306): img [..., H, W] sampled at
    (x - scale*u, y - scale*v) for flow [H, W, 2]; pixels whose flow is
    unknown, or whose sample falls outside the image, are zero."""
    from ..io.flo import UNKNOWN_FLOW_THRESH

    u, v = flow[..., 0], flow[..., 1]
    known = (u.abs() <= UNKNOWN_FLOW_THRESH) & (v.abs() <= UNKNOWN_FLOW_THRESH)
    zero = torch.zeros_like(u)
    out, mask = _warp_planes(img, torch.where(known, -scale * u, zero),
                             torch.where(known, -scale * v, zero))
    return out * torch.where(known, mask, zero)
