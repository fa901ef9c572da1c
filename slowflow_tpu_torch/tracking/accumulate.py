"""Trajectory accumulation and forward-backward consistency (torch port of
`slowflow_tpu.tracking.accumulate`; the reference is utils/utils.cpp:449-996).

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

from ..io.flo import UNKNOWN_FLOW
from ..runtime import as_f32, device_of

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
    device = device_of(forward, device)
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


def accumulate_flow(forward, occlusions, device=None):
    """Accumulate flow chains, marking pixels lost to occlusion with
    UNKNOWN_FLOW (accumulateFlow, utils.cpp:860-916).

    forward: [J, H, W, 2]; occlusions: [J, H, W] (nonzero = occluded).
    Returns acc [J, H, W, 2].
    """
    device = device_of(forward, device)
    forward = as_f32(forward, device)
    occlusions = torch.as_tensor(np.asarray(occlusions)).to(device) \
        if not isinstance(occlusions, torch.Tensor) else occlusions.to(device)
    J, h, w = forward.shape[:3]
    gx, gy = _grid(h, w, 1, 0, device)
    acc = torch.zeros((h, w, 2), device=device)
    occluded = torch.zeros((h, w), dtype=torch.bool, device=device)
    out = []
    for f in range(J):
        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = _inside(cx, cy, w, h)
        # occlusions[f - 1] gates step f
        if f > 0:
            prev = occlusions[f - 1]
            becomes_occ = inside & (prev[_round_index(cy, h),
                                         _round_index(cx, w)] != 0)
        else:
            becomes_occ = torch.zeros_like(inside)
        new_acc = acc + bilinear_sample(forward[f], cx, cy)
        occluded = occluded | becomes_occ | ~inside
        out.append(torch.where(occluded[..., None], UNKNOWN_FLOW, new_acc))
        acc = torch.where(occluded[..., None], acc, new_acc)
    return torch.stack(out)


def fuse_occlusions(forward, occlusions, start: int, length: int,
                    device=None):
    """Accumulate occlusion state along flow chains (fuseOcclusions,
    utils.cpp:724-766). Returns [H, W] uint8 (1 = occluded) on the host."""
    device = device_of(forward, device)
    forward = as_f32(forward, device)
    occlusions = torch.as_tensor(np.asarray(occlusions)).to(device) \
        if not isinstance(occlusions, torch.Tensor) else occlusions.to(device)
    J, h, w = forward.shape[:3]
    gx, gy = _grid(h, w, 1, 0, device)
    acc = torch.zeros((h, w, 2), device=device)
    occluded = torch.zeros((h, w), dtype=torch.bool, device=device)
    for f in range(start, min(start + length, J)):
        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = _inside(cx, cy, w, h)
        occ_hit = inside & (occlusions[f][_round_index(cy, h),
                                          _round_index(cx, w)] != 0)
        vec = bilinear_sample(forward[f], cx, cy)
        stop = occluded | occ_hit | ~inside
        acc = torch.where(stop[..., None], acc * 0.0, acc + vec)
        occluded = stop
    return occluded.cpu().numpy().astype(np.uint8)


def accumulate_batches(forward, backward, mask, S: int, skip_pixel: int = 0,
                       device=None):
    """Accumulate forward and backward flow over jet batches
    (accumulateBatches, utils.cpp:918-996). mask [h, w] (0 = invalid).
    Returns (acc_forward [J, h, w, 2], acc_backward [J, h, w, 2])."""
    device = device_of(forward, device)
    forward = as_f32(forward, device)
    backward = as_f32(backward, device)
    J, oh, ow = forward.shape[:3]
    steps = S - 1
    xy_incr, xy_start, h, w = _subgrid(oh, ow, skip_pixel)
    gx, gy = _grid(h, w, xy_incr, xy_start, device)
    invalid = (torch.as_tensor(np.asarray(mask)).to(device) == 0)[..., None]

    acc = torch.zeros((h, w, 2), device=device)
    accb = torch.zeros((h, w, 2), device=device)
    last = torch.zeros((h, w, 2), device=device)
    lastb = torch.zeros((h, w, 2), device=device)
    out_f, out_b = [], []
    for i in range(J):
        jet_frame = i % steps
        inside = _inside(gx + acc[..., 0], gy + acc[..., 1], ow, oh)[..., None]
        vec = bilinear_sample(forward[i], gx + acc[..., 0], gy + acc[..., 1])
        incr = torch.where(inside, acc + vec,
                           acc + float(jet_frame + 1) * last)
        if jet_frame == 0:
            last = torch.where(inside, vec, last)

        bx = gx + accb[..., 0]
        by = gy + accb[..., 1]
        inside_b = _inside(bx, by, ow, oh)[..., None]
        vecb = bilinear_sample(backward[J - 1 - i], bx, by)
        incr_b = torch.where(inside_b, accb + vecb,
                             acc + float(jet_frame + 1) * lastb)
        if jet_frame == 0:
            lastb = torch.where(inside_b, vecb, lastb)

        out_f.append(torch.where(invalid, UNKNOWN_FLOW, incr))
        out_b.append(torch.where(invalid, UNKNOWN_FLOW, incr_b))
        if jet_frame == steps - 1:
            acc, accb = incr, incr_b
    return torch.stack(out_f), torch.stack(out_b[::-1])


def forward_backward_consistency(forward, backward, S: int, epsilon: float,
                                 jetwise: bool = False, skip_pixel: int = 0,
                                 device=None):
    """Keyframe-stride FB-consistency (forwardBackwardConsistency,
    utils.cpp:619-722): accumulate forward/backward flow over batches of
    `steps = S-1` jets on the subsampled grid, then compare round trips.

    Returns (mask [h, w] float, flow_diff [h, w]) with the reference's
    convention: mask 1 = consistent, 0 = inconsistent.
    """
    device = device_of(forward, device)
    forward = as_f32(forward, device)
    backward = as_f32(backward, device)
    J, oh, ow = forward.shape[:3]
    steps = S - 1
    J = J - (J % steps)
    xy_incr, xy_start, h, w = _subgrid(oh, ow, skip_pixel)
    gx, gy = _grid(h, w, xy_incr, xy_start, device)
    gxi, gyi = gx.long(), gy.long()

    if jetwise:
        mask = torch.ones((h, w), device=device)
        diff = torch.zeros((h, w), device=device)
        for j in range(0, J, steps):
            fg = forward[j][gyi, gxi]
            cx = (gx + steps * fg[..., 0]) / xy_incr
            cy = (gy + steps * fg[..., 1]) / xy_incr
            inside = _inside(cx, cy, w, h)
            d = fg + torch.where(
                inside[..., None],
                bilinear_sample(backward[j], cx * xy_incr + xy_start,
                                cy * xy_incr + xy_start), 0.0)
            diff = _norm(d)
            mask = torch.where(diff > epsilon, 0.0, mask)
        return mask, diff

    def accumulate(flows):
        acc = torch.zeros((h, w, 2), device=device)
        for fwd in flows:
            cx = gx + acc[..., 0]
            cy = gy + acc[..., 1]
            inside = _inside(cx, cy, ow, oh)[..., None]
            acc = acc + torch.where(inside, bilinear_sample(fwd, cx, cy), 0.0)
        return acc

    acc_f = accumulate(forward[steps - 1:J:steps])
    acc_b = accumulate([backward[k] for k in range(J - steps, -1, -steps)]
                       if steps > 0 else backward.flip(0))
    cx = (gx + acc_f[..., 0]) / xy_incr
    cy = (gy + acc_f[..., 1]) / xy_incr
    inside = _inside(cx, cy, w, h)
    bvec = bilinear_sample(acc_b, cx.clamp(0, w - 1), cy.clamp(0, h - 1))
    diff = _norm(acc_f + bvec)
    diff = torch.where(inside, diff, float(np.float32(2 ** 31 - 1)))
    mask = torch.where(inside & (diff > epsilon), 0.0, 1.0)
    return mask, diff


def forward_backward_check(forward, backward, epsilon: float,
                           jetwise: bool = True, device=None):
    """FB-consistency mask (forwardBackwardCheck, utils.cpp:449-515).

    Returns [H, W] uint8 mask on the host where 1 marks *inconsistent*
    pixels (the reference's convention).
    """
    device = device_of(forward, device)
    forward = as_f32(forward, device)
    backward = as_f32(backward, device)
    J, h, w = forward.shape[:3]
    gx, gy = _grid(h, w, 1, 0, device)

    if jetwise:
        mask = torch.zeros((h, w), dtype=torch.bool, device=device)
        for fwd, bwd in zip(forward, backward):
            cx = gx + fwd[..., 0]
            cy = gy + fwd[..., 1]
            inside = _inside(cx, cy, w, h)
            diff = fwd + torch.where(inside[..., None],
                                     bilinear_sample(bwd, cx, cy), 0.0)
            mask = mask | (_norm(diff) > epsilon)
        return mask.cpu().numpy().astype(np.uint8)

    def accumulate(flows):
        acc = torch.zeros((h, w, 2), device=device)
        for fwd in flows:
            cx = gx + acc[..., 0]
            cy = gy + acc[..., 1]
            inside = _inside(cx, cy, w, h)[..., None]
            acc = acc + torch.where(inside, bilinear_sample(fwd, cx, cy), 0.0)
        return acc

    acc_f = accumulate(forward)
    acc_b = accumulate(backward.flip(0))
    cx = gx + acc_f[..., 0]
    cy = gy + acc_f[..., 1]
    inside = _inside(cx, cy, w, h)
    err = _norm(acc_f + bilinear_sample(acc_b, cx, cy))
    mask = torch.where(inside, err > epsilon, True)
    return mask.cpu().numpy().astype(np.uint8)
