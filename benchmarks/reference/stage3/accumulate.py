"""Trajectory accumulation and forward-backward consistency (frozen copy of the
port's `tracking.accumulate`; the reference is utils/utils.cpp:449-996).

The per-pixel sequential chains are a Python loop over the jet axis with all
pixels updated at once; bilinear flow sampling is a gather.

Conventions: flows are [J, H, W, 2] with channel order (u, v) = (x, y)
displacement; positions are (x, y). UNKNOWN_FLOW marks lost pixels. The
public functions take arrays or tensors; `device=None` means the device of a
tensor input, else CUDA (raising without a GPU).
"""
from __future__ import annotations

import numpy as np
import torch

from .support import as_float as as_f32

# Coordinates are clamped to this magnitude before their integer parts are
# taken, so that a sentinel such as UNKNOWN (1e10) cannot overflow int32.
# Every position inside or near an image is far below it.
_COORD_LIMIT = 1e7


def bilinear_sample(field, x, y):
    """Sample `field` [H, W, C] at float (x, y) of any shape S, giving
    [*S, C]; or, with a leading final-pair axis, field [F, H, W, C] at x, y
    [F, *S] (or broadcastable to it), giving [F, *S, C]. Clamp-at-border
    semantics of the reference's bilinearInterp (utils.h:183-218): the +1
    neighbour is only used when inside."""
    if field.dim() == 3:
        return bilinear_sample(field[None], x[None], y[None])[0]
    f, h, w = field.shape[:3]
    x = x.clamp(-_COORD_LIMIT, _COORD_LIMIT)
    y = y.clamp(-_COORD_LIMIT, _COORD_LIMIT)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x0c = x0.clamp(0, w - 1)
    y0c = y0.clamp(0, h - 1)
    x1c = (x0 + 1).clamp(0, w - 1)
    y1c = (y0 + 1).clamp(0, h - 1)
    fx = ((x - x0).clamp(0.0, 1.0) * (x0 + 1 <= w - 1))[..., None]
    fy = ((y - y0).clamp(0.0, 1.0) * (y0 + 1 <= h - 1))[..., None]
    fi = torch.arange(f, device=field.device).view((f,) + (1,) * (x.dim() - 1))
    return (field[fi, y0c, x0c] * (1 - fx) * (1 - fy)
            + field[fi, y0c, x1c] * fx * (1 - fy)
            + field[fi, y1c, x0c] * (1 - fx) * fy
            + field[fi, y1c, x1c] * fx * fy)


def _grid(h, w, xy_incr, xy_start, device):
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return xx * xy_incr + xy_start, yy * xy_incr + xy_start


def _norm(v):
    """Euclidean norm over the last axis of size 2, as sqrt(x*x + y*y)."""
    return torch.sqrt((v * v).sum(-1))


def _inside(x, y, w, h):
    return (x >= 0) & (x < w) & (y >= 0) & (y < h)


def _round_index(c, n):
    """Nearest pixel index (half to even, as jnp.round), clamped to [0, n)."""
    return torch.round(c.clamp(-_COORD_LIMIT, _COORD_LIMIT)).to(
        torch.int64).clamp(0, n - 1)


def _subgrid(oh, ow, skip_pixel):
    xy_incr = skip_pixel + 1
    return (xy_incr, int(0.5 * skip_pixel), int(np.floor(oh / xy_incr)),
            int(np.floor(ow / xy_incr)))


def accumulate_consistent_batches(forward, backward, occlusions=None,
                                  epsilon=1.0, skip_pixel=0, discard=False,
                                  device=None):
    """Consistent trajectory accumulation with constant-velocity fallback
    (accumulateConsistentBatches, utils.cpp:517-617).

    forward/backward: [J, H, W, 2]; occlusions: optional [J, H, W] uint8 where
    0 marks an occluded correspondence. Returns
    (acc_forward [J, h, w, 2], tracked [h, w] int32) on the subsampled grid.
    """
    forward = as_f32(forward, device)
    backward = as_f32(backward, device)
    has_occ = occlusions is not None
    if has_occ:
        occlusions = torch.as_tensor(np.asarray(occlusions)) \
            if not isinstance(occlusions, torch.Tensor) else occlusions
        occlusions = occlusions.to(device)
    J, oh, ow = forward.shape[:3]
    xy_incr, xy_start, h, w = _subgrid(oh, ow, skip_pixel)
    gx, gy = _grid(h, w, xy_incr, xy_start, device)

    last = forward[0, gy.long(), gx.long()]
    acc = torch.zeros((h, w, 2), device=device)
    occluded = torch.zeros((h, w), dtype=torch.bool, device=device)
    tracked = torch.full((h, w), J, dtype=torch.int32, device=device)
    out = []
    for f in range(J):
        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = _inside(cx, cy, ow, oh)

        # occlusion trigger at the current correspondence (rounded position)
        if has_occ:
            occ_hit = inside & (occlusions[f][_round_index(cy, oh),
                                              _round_index(cx, ow)] == 0)
        else:
            occ_hit = torch.zeros_like(inside)

        vec = bilinear_sample(forward[f], cx, cy)
        nx = cx + vec[..., 0]
        ny = cy + vec[..., 1]
        inside_n = _inside(nx, ny, ow, oh)
        bvec = bilinear_sample(backward[f], nx, ny)
        diff = torch.where(inside_n[..., None], vec + bvec, vec - last)
        inconsistent = _norm(diff) > epsilon

        # new accumulated flow for active pixels
        acc_cv = acc + last                      # constant-velocity fallback
        acc_ok = acc + vec
        new_acc = torch.where(inside[..., None],
                              torch.where(inconsistent[..., None], acc_cv,
                                          acc_ok), acc_cv)
        new_last = torch.where((inside & ~inconsistent)[..., None], vec, last)

        lost = (~inside) | inconsistent | occ_hit
        first_loss = lost & (tracked == J)
        new_tracked = torch.where(
            first_loss, torch.full_like(tracked, 0 if discard else f + 1),
            tracked)

        active = ~occluded
        acc = torch.where(active[..., None], new_acc, 0.0)
        last = torch.where(active[..., None], new_last, last)
        tracked = torch.where(active, new_tracked, tracked)
        occluded = occluded | (active & occ_hit)
        out.append(acc)
    return torch.stack(out), tracked
