"""The synthetic bench scene of the stage-2 jet solve, made from a seed.

`moving_sequence` is the scene the JAX package's benchmark solves (its
`bench.py` `_moving_sequence`), kept here so that the port's smoke run and
tests need nothing of that package.
"""
from __future__ import annotations

import numpy as np


def moving_sequence(f: int, h: int, w: int, u: float, v: float,
                    seed: int = 0) -> np.ndarray:
    """Two-layer scene, [f, 3, h, w] float64 in 0..255: a smooth background
    translating (u, v) px/frame with a disc of foreground moving the opposite
    way in x, so the occlusion reasoning has real boundaries."""
    rng = np.random.default_rng(seed)
    pad = 16
    base = rng.random((h + 2 * pad, w + 2 * pad)).astype(np.float32) * 255
    fg = rng.random((h + 2 * pad, w + 2 * pad)).astype(np.float32) * 255
    for _ in range(2):  # cheap smoothing
        base = 0.25 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                       + np.roll(base, 1, 1) + np.roll(base, -1, 1))
        fg = 0.25 * (np.roll(fg, 1, 0) + np.roll(fg, -1, 0)
                     + np.roll(fg, 1, 1) + np.roll(fg, -1, 1))
    yy, xx = np.mgrid[0:h, 0:w]
    ref = (f - 1) // 2

    def sample(img, dx_t, dy_t):
        xs = np.clip(xx + pad - dx_t, 0, w + 2 * pad - 2)
        ys = np.clip(yy + pad - dy_t, 0, h + 2 * pad - 2)
        x0, y0 = xs.astype(int), ys.astype(int)
        fx, fy = xs - x0, ys - y0
        return (img[y0, x0] * (1 - fx) * (1 - fy)
                + img[y0, x0 + 1] * fx * (1 - fy)
                + img[y0 + 1, x0] * (1 - fx) * fy
                + img[y0 + 1, x0 + 1] * fx * fy)

    cy, cx, r = h // 2, w // 2, min(h, w) // 6
    frames = []
    for s in range(-ref, f - ref):
        im = sample(base, s * u, s * v)
        im_fg = sample(fg, -s * u, s * v)
        in_fg = ((yy - (cy + s * v)) ** 2 + (xx - (cx - s * u)) ** 2) < r * r
        frames.append(np.repeat(np.where(in_fg, im_fg, im)[None], 3, 0))
    return np.stack(frames)
