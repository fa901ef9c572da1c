"""Bayer demosaicing and raw channel-confidence weighting.

Vectorized re-implementations of the reference's host-side kernels:
  - bayer2rgb            plain bilinear            (utils/utils.cpp:1191-1240)
  - bayer2rgbGR          green-ratio bilinear      (utils/utils.cpp:1242-1334)
  - rawWeighting         per-channel confidence    (utils/utils.cpp:1336-1374)

Input Bayer mosaics are [H, W] float arrays; `red_x`, `red_y` give the
location of the first red pixel in the pattern (cfg key `raw_red_loc`).
Mirror-boundary neighbours (x-1 -> x+1 at the left edge, etc.) follow the
reference exactly.
"""
from __future__ import annotations

import numpy as np


def _shifted(src: np.ndarray):
    """Return mirror-edge shifted views: (ym1, yp1, xm1, xp1, and diagonals)."""
    h, w = src.shape
    ym1 = np.empty_like(src); ym1[1:] = src[:-1]; ym1[0] = src[1]
    yp1 = np.empty_like(src); yp1[:-1] = src[1:]; yp1[-1] = src[-2]
    xm1 = np.empty_like(src); xm1[:, 1:] = src[:, :-1]; xm1[:, 0] = src[:, 1]
    xp1 = np.empty_like(src); xp1[:, :-1] = src[:, 1:]; xp1[:, -1] = src[:, -2]

    def shift_x(a, sign):
        out = np.empty_like(a)
        if sign < 0:
            out[:, 1:] = a[:, :-1]; out[:, 0] = a[:, 1]
        else:
            out[:, :-1] = a[:, 1:]; out[:, -1] = a[:, -2]
        return out

    d_mm = shift_x(ym1, -1)  # (y-1, x-1)
    d_mp = shift_x(ym1, +1)  # (y-1, x+1)
    d_pm = shift_x(yp1, -1)  # (y+1, x-1)
    d_pp = shift_x(yp1, +1)  # (y+1, x+1)
    return ym1, yp1, xm1, xp1, d_mm, d_mp, d_pm, d_pp


def _pattern_masks(h: int, w: int, red_x: int, red_y: int):
    """Boolean masks for (blue-row green, blue, red-row green, red) sites."""
    yy, xx = np.mgrid[0:h, 0:w]
    blue_row = (yy + (1 - red_y)) % 2 == 0
    red_row = ~blue_row
    g_in_blue = blue_row & ((xx + red_x) % 2 == 0)
    b_site = blue_row & ((xx + red_x) % 2 == 1)
    g_in_red = red_row & ((xx + (1 - red_x)) % 2 == 0)
    r_site = red_row & ((xx + (1 - red_x)) % 2 == 1)
    return g_in_blue, b_site, g_in_red, r_site


def bayer2rgb(src: np.ndarray, red_x: int, red_y: int) -> np.ndarray:
    """Plain bilinear demosaic -> [H, W, 3] RGB."""
    src = np.asarray(src, np.float32)
    h, w = src.shape
    ym1, yp1, xm1, xp1, d_mm, d_mp, d_pm, d_pp = _shifted(src)
    g_in_blue, b_site, g_in_red, r_site = _pattern_masks(h, w, red_x, red_y)

    cross = 0.25 * (ym1 + yp1 + xm1 + xp1)
    diag = 0.25 * (d_mm + d_mp + d_pm + d_pp)
    horiz = 0.5 * (xm1 + xp1)
    vert = 0.5 * (ym1 + yp1)

    r = np.where(g_in_blue, vert, np.where(b_site, diag, np.where(g_in_red, horiz, src)))
    g = np.where(g_in_blue | g_in_red, src, cross)
    b = np.where(g_in_blue, horiz, np.where(b_site, src, np.where(g_in_red, vert, diag)))
    return np.stack([r, g, b], axis=-1)


def bayer2rgb_green_ratio(src: np.ndarray, red_x: int, red_y: int) -> np.ndarray:
    """Green-ratio demosaic (bayer2rgbGR): interpolate G first, then R/B as
    G * mean(raw_neighbour / G_neighbour)."""
    src = np.asarray(src, np.float32)
    h, w = src.shape
    g_in_blue, b_site, g_in_red, r_site = _pattern_masks(h, w, red_x, red_y)

    ym1, yp1, xm1, xp1, d_mm, d_mp, d_pm, d_pp = _shifted(src)
    cross = 0.25 * (ym1 + yp1 + xm1 + xp1)
    green = np.where(g_in_blue | g_in_red, src, cross)

    gym1, gyp1, gxm1, gxp1, g_mm, g_mp, g_pm, g_pp = _shifted(green)

    ratio_vert = 0.5 * (ym1 / gym1 + yp1 / gyp1)
    ratio_horiz = 0.5 * (xm1 / gxm1 + xp1 / gxp1)
    ratio_diag = 0.25 * (d_mm / g_mm + d_mp / g_mp + d_pm / g_pm + d_pp / g_pp)

    r = np.where(g_in_blue, green * ratio_vert,
                 np.where(b_site, green * ratio_diag,
                          np.where(g_in_red, green * ratio_horiz, src)))
    b = np.where(g_in_blue, green * ratio_horiz,
                 np.where(b_site, src,
                          np.where(g_in_red, green * ratio_vert, green * ratio_diag)))
    return np.stack([r, green, b], axis=-1)


def raw_weighting(h: int, w: int, red_x: int, red_y: int, weight: float) -> np.ndarray:
    """Per-channel confidence weights [3, H, W] (rawWeighting).

    The sampled channel at each Bayer site gets `weight`; the interpolated
    channels share the remainder 0.5*(3 - weight). Note the reference swaps
    the green-site test depending on red_y (utils.cpp:1344-1359).
    """
    weight = float(np.clip(weight, 0.0, 3.0))
    other = 0.5 * (3.0 - weight)
    yy, xx = np.mgrid[0:h, 0:w]
    blue_row = (yy + (1 - red_y)) % 2 == 0
    if red_y == 1:
        g_in_blue = blue_row & ((xx + (1 - red_x)) % 2 == 0)
        g_in_red = ~blue_row & ((xx + red_x) % 2 == 0)
    else:
        g_in_blue = blue_row & ((xx + red_x) % 2 == 0)
        g_in_red = ~blue_row & ((xx + (1 - red_x)) % 2 == 0)
    b_site = blue_row & ~g_in_blue
    r_site = ~blue_row & ~g_in_red
    g_site = g_in_blue | g_in_red

    wr = np.where(r_site, weight, other)
    wg = np.where(g_site, weight, other)
    wb = np.where(b_site, weight, other)
    return np.stack([wr, wg, wb], axis=0).astype(np.float32)


def _shift2(src: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Mirror-edge shift by (dy, dx) with |dy|,|dx| <= 2 (reflect-101)."""
    h, w = src.shape
    ys = np.abs(np.arange(h) + dy)
    ys = np.where(ys > h - 1, 2 * (h - 1) - ys, ys)
    xs = np.abs(np.arange(w) + dx)
    xs = np.where(xs > w - 1, 2 * (w - 1) - xs, xs)
    return src[ys][:, xs]


def bayer2rgb_hamilton_adams(src: np.ndarray, red_x: int,
                             red_y: int) -> np.ndarray:
    """Hamilton-Adams gradient-corrected demosaicing.

    The reference optionally links Pascal Getreuer's implementation of
    Hamilton & Adams (U.S. patent 5,629,734) for `raw_demosaicing 1`
    (DMGUNTURK, configuration.h:24-25, slow_flow.cpp:47-50,487-500); the
    build was shipped with the define commented out, so this is a from-spec
    implementation rather than a port:

      green at R/B sites: pick the axis with the smaller combined
      green-gradient + same-color-Laplacian detail estimator and correct
      the averaged greens with half the Laplacian of the underlying color;
      ties average both axes.
      R/B elsewhere: bilinear interpolation of the color *differences*
      (R-G, B-G) — axial at green sites, diagonal across sites, with the
      diagonal direction again chosen by the smaller color gradient.

    src: [H, W] Bayer mosaic; returns [H, W, 3] float32.
    """
    src = np.asarray(src, np.float32)
    h, w = src.shape
    g_in_blue, b_site, g_in_red, r_site = _pattern_masks(h, w, red_x, red_y)
    g_site = g_in_blue | g_in_red

    sh = lambda dy, dx: _shift2(src, dy, dx)

    # ---- green at red/blue sites -------------------------------------
    dh = np.abs(sh(0, -1) - sh(0, 1)) + np.abs(2 * src - sh(0, -2) - sh(0, 2))
    dv = np.abs(sh(-1, 0) - sh(1, 0)) + np.abs(2 * src - sh(-2, 0) - sh(2, 0))
    gh = 0.5 * (sh(0, -1) + sh(0, 1)) + 0.25 * (2 * src - sh(0, -2) - sh(0, 2))
    gv = 0.5 * (sh(-1, 0) + sh(1, 0)) + 0.25 * (2 * src - sh(-2, 0) - sh(2, 0))
    gb = 0.5 * (gh + gv)
    green = np.where(g_site, src, np.where(dh < dv, gh,
                                           np.where(dv < dh, gv, gb)))

    # ---- red/blue via color differences ------------------------------
    def chroma(site_mask, same_row_green):
        """Interpolate (C - G) from `site_mask` samples to everywhere."""
        diff = np.where(site_mask, src - green, 0.0)
        gsh = lambda dy, dx: _shift2(diff, dy, dx)
        # at green pixels: average the two axial neighbours that carry C
        axial_h = 0.5 * (gsh(0, -1) + gsh(0, 1))
        axial_v = 0.5 * (gsh(-1, 0) + gsh(1, 0))
        # across sites (B site for R, R site for B): diagonal neighbours,
        # direction chosen by the smaller diagonal gradient
        dn = np.abs(gsh(-1, -1) - gsh(1, 1))
        dp = np.abs(gsh(-1, 1) - gsh(1, -1))
        diag_n = 0.5 * (gsh(-1, -1) + gsh(1, 1))
        diag_p = 0.5 * (gsh(-1, 1) + gsh(1, -1))
        diag = np.where(dn < dp, diag_n,
                        np.where(dp < dn, diag_p, 0.5 * (diag_n + diag_p)))
        out = np.where(site_mask, diff,
                       np.where(same_row_green, axial_h,
                                np.where(g_site, axial_v, diag)))
        return green + out

    red = chroma(r_site, g_in_red)
    blue = chroma(b_site, g_in_blue)
    return np.stack([red, green, blue], axis=-1).astype(np.float32)
