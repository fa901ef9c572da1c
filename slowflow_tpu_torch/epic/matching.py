"""Sparse grid matching, the built-in replacement for the DeepMatching
binary (torch port of `slowflow_tpu.epic.matching`).

For a grid of points in im1 (every `step` px), find the integer displacement
in [-radius, radius]^2 that minimizes the sum of absolute luminance
differences over a (2*patch_r+1)^2 patch; pixels displaced out of the image
cost 1e3 each and the patch sum is zero-padded at the image border. Ties go
to the first displacement in k = (dy+r)*(2r+1) + (dx+r) order. Each match is
then matched back from its target, and kept when the forward-backward error
is at most `fb_threshold` px.

On CUDA tensors the search is one launch of the hand-written kernel
csrc/grid_match.cu per direction (`grid_match`): a block per point holds
the point's search window in shared memory, padded with -1e3 outside the
image, and each thread sums the costs of several displacements at once,
bitwise as the definition orders them (`grid_match_paths` counts the blocks
that took the padded path and the general one). It is the counterpart of
the JAX package's compiled `_grid_match_core`. On
CPU tensors it is the plain twin `_best_displacement`, which loops over dy
on the host and vectorizes over dx and the batch: per dy one
[B, H, 2r+1, W] cost stack, its horizontal patch sum, then the vertical
patch sum gathered at the points only, and a running minimum that keeps
the first index on ties; `_CHUNK_ELEMENTS` bounds its stack's size.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..core.image import luminance
from ..runtime import as_f32, device_of, on_device

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


def _best_displacement_chunked(g1, g2, ys, xs, radius: int, patch_r: int):
    """`_best_displacement` in chunks of the batch that bound the cost
    stack's size."""
    b, h, w = g1.shape
    chunk = max(1, _CHUNK_ELEMENTS // (h * (2 * radius + 1) * w))
    return torch.cat([_best_displacement(
        g1[i:i + chunk], g2[i:i + chunk], ys[i:i + chunk], xs[i:i + chunk],
        radius, patch_r) for i in range(0, b, chunk)])


def grid_match(g1, g2, ys, xs, radius: int, patch_r: int):
    """`_best_displacement` through the CUDA kernel (csrc/grid_match.cu):
    g1, g2 contiguous float32 [B, H, W], ys, xs contiguous int64 [B, P]
    inside the image, all on the calling thread's current CUDA device.
    Launches on the current stream; returns k [B, P] int64. A failed
    build or launch raises."""
    dev = g1.device
    if dev.type != "cuda":
        raise ValueError(f"grid_match: tensors on {dev}, expected CUDA")
    if g1.dim() != 3:
        raise ValueError(f"g1: expected [B, H, W], got {tuple(g1.shape)}")
    b, h, w = g1.shape
    kernels.require_cuda("g1", g1, (b, h, w), dev)
    kernels.require_cuda("g2", g2, (b, h, w), dev)
    p = ys.shape[-1] if ys.dim() == 2 else -1
    for name, t in (("ys", ys), ("xs", xs)):
        if t.device != dev or t.dtype != torch.int64 \
                or tuple(t.shape) != (b, p) or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int64 [{b}, P] "
                             f"tensor on {dev} (P as ys), got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if radius < 0 or patch_r < 0:
        raise ValueError(f"radius {radius} and patch_r {patch_r} must be "
                         ">= 0")
    out = torch.empty((b, p), dtype=torch.int64, device=dev)
    err = kernels.load().sf_grid_match(
        *(kernels.ptr(t) for t in (g1, g2, ys, xs, out)), b, h, w, p,
        int(radius), int(patch_r), kernels.stream_ptr(dev))
    kernels.check(err, "grid_match")
    kernels.count_launch("grid_match")
    return out


def grid_match_paths() -> dict:
    """Blocks of the kernel on the current CUDA device that took the
    sentinel path (every patch value >= 0) and the general tap loop since
    the last call, which zeroes both counts. Waits for the device."""
    out = (ctypes.c_longlong * 2)()
    kernels.check(kernels.load().sf_grid_match_paths(out), "grid_match_paths")
    return {"sentinel": out[0], "general": out[1]}


def _match_points(g1, g2, ys, xs, radius: int, patch_r: int):
    """The first-index least-cost displacement at points (ys, xs) [B, P]:
    the kernel on CUDA tensors, the chunked twin on CPU tensors. Returns
    (dx, dy) [B, P] int64."""
    if g1.device.type == "cpu":
        k = _best_displacement_chunked(g1, g2, ys, xs, radius, patch_r)
    else:
        k = grid_match(g1.contiguous(), g2.contiguous(), ys.contiguous(),
                       xs.contiguous(), radius, patch_r)
    d = 2 * radius + 1
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
    with on_device(device):
        dxf, dyf, fb_err = grid_match_core(im1s, im2s, ys, xs, radius,
                                           patch_r)
    dxf = dxf.cpu().numpy()
    dyf = dyf.cpu().numpy()
    keep = fb_err.cpu().numpy() <= fb_threshold
    out = []
    for b in range(im1s.shape[0]):
        m = np.stack([xs_np.ravel(), ys_np.ravel(),
                      xs_np.ravel() + dxf[b], ys_np.ravel() + dyf[b]], 1)
        out.append(m[keep[b]].astype(np.float32))
    return out
