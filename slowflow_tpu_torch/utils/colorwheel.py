"""Middlebury flow color wheel visualization.

Vectorized re-implementation of the Middlebury devkit `computeColor` /
`colorcode.cpp` convention as used by the reference's `flowColorImg`
(utils/utils.cpp:998-1112): normalization by the max flow radius, black for
NaN/too-large flow, saturation ramp inside the unit circle, 0.75 scaling
outside.
"""
from __future__ import annotations

import numpy as np

_RY, _YG, _GC, _CB, _BM, _MR = 15, 6, 4, 11, 13, 6
_NCOLS = _RY + _YG + _GC + _CB + _BM + _MR  # 55


def _make_colorwheel() -> np.ndarray:
    wheel = np.zeros((_NCOLS, 3))
    col = 0
    # RY
    wheel[0:_RY, 0] = 255
    wheel[0:_RY, 1] = np.floor(255 * np.arange(_RY) / _RY)
    col += _RY
    # YG
    wheel[col:col + _YG, 0] = 255 - np.floor(255 * np.arange(_YG) / _YG)
    wheel[col:col + _YG, 1] = 255
    col += _YG
    # GC
    wheel[col:col + _GC, 1] = 255
    wheel[col:col + _GC, 2] = np.floor(255 * np.arange(_GC) / _GC)
    col += _GC
    # CB
    wheel[col:col + _CB, 1] = 255 - np.floor(255 * np.arange(_CB) / _CB)
    wheel[col:col + _CB, 2] = 255
    col += _CB
    # BM
    wheel[col:col + _BM, 2] = 255
    wheel[col:col + _BM, 0] = np.floor(255 * np.arange(_BM) / _BM)
    col += _BM
    # MR
    wheel[col:col + _MR, 2] = 255 - np.floor(255 * np.arange(_MR) / _MR)
    wheel[col:col + _MR, 0] = 255
    return wheel / 255.0


_WHEEL = _make_colorwheel()


def compute_color(fx: np.ndarray, fy: np.ndarray) -> np.ndarray:
    """Map normalized flow (|f| <= 1 inside wheel) to RGB uint8 [..., 3]."""
    rad = np.sqrt(fx * fx + fy * fy)
    a = np.arctan2(-fy, -fx) / np.pi
    fk = (a + 1.0) / 2.0 * (_NCOLS - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % _NCOLS
    f = fk - k0
    col0 = _WHEEL[k0]  # [..., 3]
    col1 = _WHEEL[k1]
    col = (1 - f)[..., None] * col0 + f[..., None] * col1
    inside = rad <= 1
    col = np.where(inside[..., None], 1 - rad[..., None] * (1 - col), col * 0.75)
    return (255.0 * col).astype(np.uint8)


def flow_color_img(u: np.ndarray, v: np.ndarray, maxrad: float = -1.0,
                   mask: np.ndarray | None = None) -> np.ndarray:
    """Render a flow field to a Middlebury color image (RGB uint8 [H, W, 3])."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    h, w = u.shape
    invalid = ~np.isfinite(u) | ~np.isfinite(v) | (np.abs(u) > w) | (np.abs(v) > h)
    if mask is not None:
        invalid |= np.asarray(mask) == 0
    valid = ~invalid
    if maxrad <= 0:
        rad = np.sqrt(u * u + v * v)
        maxrad = float(rad[valid].max()) if valid.any() else 0.0
    if maxrad == 0:
        maxrad = 1.0
    img = compute_color(np.where(valid, u, 0) / maxrad, np.where(valid, v, 0) / maxrad)
    img[invalid] = 0
    return img
