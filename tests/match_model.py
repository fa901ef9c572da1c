"""A numpy model of the grid matcher's CUDA kernel
(slowflow_tpu_torch/csrc/grid_match.cu), point by point in its arithmetic.

For each point, the costs of all (2r+1)^2 displacements are summed in
float32 in the kernel's fixed tap order (patch rows top to bottom, each
row's taps left to right into a row sum, the row sums in turn), one
float32 operation at a time over the displacements, and the first index of
least cost is kept, which is the kernel's lexicographic (cost, k) minimum.
The kernel has no multiply to contract, so its labels equal these.

`point_costs` follows the definition (a tap displaced out of the image
reads 0 and adds 1e3); `point_costs_padded` follows the kernel's sentinel
path: the search window padded with -1e3 and the patch bounds fixed per
point, so a tap is |a - v| and nothing else. For planes >= 0 the two agree
bit for bit (float32 |a + 1e3| is a + 1e3 rounded once, as |a - 0| + 1e3
is); the kernel takes its general loop for a point whose patch holds a
negative value.
"""
from __future__ import annotations

import numpy as np

OUTSIDE = np.float32(1e3)
SENTINEL = -OUTSIDE


def point_costs(g1, g2, y: int, x: int, radius: int, patch_r: int):
    """float32 costs [(2r+1)^2] of one point of [H, W] float32 planes, in
    k = (dy+r)(2r+1) + (dx+r) order."""
    h, w = g1.shape
    d = 2 * radius + 1
    dy, dx = np.divmod(np.arange(d * d), d)
    dy, dx = dy - radius, dx - radius
    cost = np.zeros(d * d, np.float32)
    for py in range(-patch_r, patch_r + 1):
        yy = y + py
        if not 0 <= yy < h:
            continue
        ty = yy + dy
        row_in = (ty >= 0) & (ty < h)
        rs = np.zeros(d * d, np.float32)
        for px in range(-patch_r, patch_r + 1):
            xx = x + px
            if not 0 <= xx < w:
                continue
            tx = xx + dx
            inside = row_in & (tx >= 0) & (tx < w)
            g2v = np.where(inside, g2[np.clip(ty, 0, h - 1),
                                      np.clip(tx, 0, w - 1)], np.float32(0))
            t = np.abs(np.float32(g1[yy, xx]) - g2v.astype(np.float32))
            t = np.where(inside, t, t + OUTSIDE).astype(np.float32)
            rs = (rs + t).astype(np.float32)
        cost = (cost + rs).astype(np.float32)
    return cost


def point_costs_padded(g1, g2, y: int, x: int, radius: int, patch_r: int):
    """`point_costs` as the kernel's sentinel path sums them: the patch rows
    and columns inside the image fixed once, the search window of g2
    staged with -1e3 outside the image, each tap |a - v|."""
    h, w = g1.shape
    r, d = radius, 2 * radius + 1
    py_lo, py_hi = max(-patch_r, -y), min(patch_r, h - 1 - y)
    px_lo, px_hi = max(-patch_r, -x), min(patch_r, w - 1 - x)
    rows = np.arange(y + py_lo - r, y + py_hi + r + 1)
    cols = np.arange(x + px_lo - r, x + px_hi + r + 1)
    win = np.full((len(rows), len(cols)), SENTINEL, np.float32)
    rin = (rows >= 0) & (rows < h)
    cin = (cols >= 0) & (cols < w)
    win[np.ix_(rin, cin)] = g2[np.ix_(rows[rin], cols[cin])]
    dyi, dxi = np.divmod(np.arange(d * d), d)
    cost = np.zeros(d * d, np.float32)
    for py in range(py_lo, py_hi + 1):
        rs = np.zeros(d * d, np.float32)
        for px in range(px_lo, px_hi + 1):
            v = win[py - py_lo + dyi, px - px_lo + dxi]
            rs = (rs + np.abs(np.float32(g1[y + py, x + px]) - v)).astype(
                np.float32)
        cost = (cost + rs).astype(np.float32)
    return cost


def best_displacement(g1, g2, ys, xs, radius: int, patch_r: int):
    """k [B, P] int64 of [B, H, W] planes at points ys, xs [B, P]."""
    g1 = np.asarray(g1, np.float32)
    g2 = np.asarray(g2, np.float32)
    ys, xs = np.asarray(ys), np.asarray(xs)
    out = np.zeros(ys.shape, np.int64)
    for b in range(ys.shape[0]):
        for i in range(ys.shape[1]):
            c = point_costs(g1[b], g2[b], int(ys[b, i]), int(xs[b, i]),
                            radius, patch_r)
            out[b, i] = int(np.argmin(c))
    return out


def patch_cost64(g1, g2, y: int, x: int, dy: int, dx: int, patch_r: int):
    """The cost of one displacement at one point, in float64."""
    h, w = g1.shape
    c = 0.0
    for yy in range(y - patch_r, y + patch_r + 1):
        for xx in range(x - patch_r, x + patch_r + 1):
            if not (0 <= yy < h and 0 <= xx < w):
                continue
            y2, x2 = yy + dy, xx + dx
            inside = 0 <= y2 < h and 0 <= x2 < w
            c += abs(float(g1[yy, xx]) - (float(g2[y2, x2]) if inside
                                          else 0.0)) \
                + (0.0 if inside else 1e3)
    return c


def differ_only_on_ties(g1, g2, ys, xs, k_a, k_b, radius: int, patch_r: int,
                        rel: float = 1e-5):
    """The points where labels k_a and k_b [B, P] differ, and whether at
    each the two displacements' float64 costs agree within `rel`."""
    d = 2 * radius + 1
    g1 = np.asarray(g1, np.float64)
    g2 = np.asarray(g2, np.float64)
    out = []
    for b, i in zip(*np.nonzero(np.asarray(k_a) != np.asarray(k_b))):
        cs = [patch_cost64(g1[b], g2[b], int(ys[b, i]), int(xs[b, i]),
                           int(k[b, i]) // d - radius,
                           int(k[b, i]) % d - radius, patch_r)
              for k in (k_a, k_b)]
        out.append(((int(b), int(i)), abs(cs[0] - cs[1])
                    <= rel * max(max(cs), 1e-30)))
    return out
