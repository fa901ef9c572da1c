"""Sparse grid matching, the built-in replacement for the DeepMatching
binary (torch port of `slowflow_tpu.epic.matching`).

For a grid of points in im1 (every `step` px), find the integer displacement
in [-radius, radius]^2 that minimizes the sum of absolute luminance
differences over a (2*patch_r+1)^2 patch; pixels displaced out of the image
cost 1e3 each and the patch sum is zero-padded at the image border. Ties go
to the first displacement in k = (dy+r)*(2r+1) + (dx+r) order. Each match is
then matched back from its target, and kept when the forward-backward error
is at most `fb_threshold` px.

The search loops over dy on the host and vectorizes over dx and the batch:
per dy one [B, H, 2r+1, W] cost stack, its horizontal patch sum, then the
vertical patch sum gathered at the points only, and a running minimum that
keeps the first index on ties.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.image import luminance
from ..runtime import as_f32, device_of

# elements of one [B, H, 2r+1, W] cost stack per chunk of the batch
_CHUNK_ELEMENTS = 1 << 26


def _best_displacement(g1, g2, ys, xs, radius: int, patch_r: int):
    """First-index argmin over k of the patch SAD cost at points (ys, xs).

    g1, g2: [B, H, W] luminance; ys, xs: [B, P] int64 inside the image.
    Returns k [B, P] int64 (dy = k // d - r, dx = k % d - r)."""
    b, h, w = g1.shape
    r, d = radius, 2 * radius + 1
    g2p = F.pad(g2, (r, r, r, r))
    penp = F.pad(torch.zeros_like(g2), (r, r, r, r), value=1e3)
    rows = ys[..., None] + torch.arange(-patch_r, patch_r + 1,
                                        device=g1.device)
    row_in = (rows >= 0) & (rows < h)
    rows = rows.clamp(0, h - 1)
    bidx = torch.arange(b, device=g1.device)[:, None, None]
    cols = xs[..., None]
    zero = torch.zeros((), device=g1.device)
    best_c = torch.full(ys.shape, float("inf"), device=g1.device)
    best_k = torch.zeros(ys.shape, dtype=torch.int64, device=g1.device)
    for dy in range(-r, r + 1):
        # win[b, y, j, x] = g2[y + dy, x + j - r], zero outside the image
        win = g2p[:, dy + r:dy + r + h].unfold(-1, w, 1)
        pen = penp[:, dy + r:dy + r + h].unfold(-1, w, 1)
        diff = (g1[:, :, None, :] - win).abs_().add_(pen)
        hsum = F.pad(diff, (patch_r, patch_r)).unfold(
            -1, 2 * patch_r + 1, 1).sum(-1)                   # [B, H, d, W]
        patch = torch.where(row_in[..., None], hsum[bidx, rows, :, cols],
                            zero).sum(-2)                      # [B, P, d]
        c, j = patch.min(-1)
        upd = c < best_c
        best_c = torch.where(upd, c, best_c)
        best_k = torch.where(upd, (dy + r) * d + j, best_k)
    return best_k


def _match_points(g1, g2, ys, xs, radius: int, patch_r: int):
    """`_best_displacement` in chunks of the batch that bound the cost
    stack's size; returns (dx, dy) [B, P] int64."""
    b, h, w = g1.shape
    d = 2 * radius + 1
    chunk = max(1, _CHUNK_ELEMENTS // (h * d * w))
    ks = [_best_displacement(g1[i:i + chunk], g2[i:i + chunk],
                             ys[i:i + chunk], xs[i:i + chunk], radius,
                             patch_r) for i in range(0, b, chunk)]
    k = torch.cat(ks)
    return k % d - radius, k // d - radius


def grid_match_core(im1s, im2s, ys, xs, radius: int, patch_r: int):
    """Forward match at the grid points (ys, xs) [P] and the backward check
    from each target. im1s, im2s: [B, 3, H, W] float32 tensors.
    Returns (dxf, dyf, fb_err) [B, P]."""
    g1 = luminance(im1s)
    g2 = luminance(im2s)
    b, h, w = g1.shape
    ys = ys.expand(b, -1)
    xs = xs.expand(b, -1)
    dxf, dyf = _match_points(g1, g2, ys, xs, radius, patch_r)
    x2 = (xs + dxf).clamp(0, w - 1)
    y2 = (ys + dyf).clamp(0, h - 1)
    dxb, dyb = _match_points(g2, g1, y2, x2, radius, patch_r)
    fb_err = torch.hypot((dxf + dxb).float(), (dyf + dyb).float())
    return dxf, dyf, fb_err


def grid_matches(im1, im2, step: int = 8, radius: int = 32, patch_r: int = 4,
                 fb_threshold: float = 2.0, device=None) -> np.ndarray:
    """Dense-grid matches between [3, H, W] images.

    Returns [N, 4] float32 (x1, y1, x2, y2), forward-backward checked."""
    return grid_matches_batched(im1[None], im2[None], step, radius, patch_r,
                                fb_threshold, device=device)[0]


def grid_matches_batched(im1s, im2s, step: int = 8, radius: int = 32,
                         patch_r: int = 4, fb_threshold: float = 2.0,
                         device=None) -> list[np.ndarray]:
    """Matches for a batch of [B, 3, H, W] pairs (tensors or arrays, any
    real dtype, 0..255). `device`: None = the tensors' device, else CUDA.
    Returns one [N_b, 4] float32 array per pair."""
    device = device_of(im1s, device)
    im1s = as_f32(im1s, device)
    im2s = as_f32(im2s, device)
    h, w = im1s.shape[2:]
    ys_np, xs_np = np.mgrid[step // 2:h:step, step // 2:w:step]
    ys = torch.as_tensor(ys_np.ravel(), device=device)
    xs = torch.as_tensor(xs_np.ravel(), device=device)
    dxf, dyf, fb_err = grid_match_core(im1s, im2s, ys, xs, radius, patch_r)
    dxf = dxf.cpu().numpy()
    dyf = dyf.cpu().numpy()
    keep = fb_err.cpu().numpy() <= fb_threshold
    out = []
    for b in range(im1s.shape[0]):
        m = np.stack([xs_np.ravel(), ys_np.ravel(),
                      xs_np.ravel() + dxf[b], ys_np.ravel() + dyf[b]], 1)
        out.append(m[keep[b]].astype(np.float32))
    return out
