"""Lab conversion, saliency, resize and normalization (frozen copy of the
port's `core.image`).

Images are channel-planar float32 tensors [..., 3, H, W]; every function
batches over the leading dims.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .conv import DERIV_3PT, conv_horiz, conv_vert, gaussian_kernel


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of x >= 0. torch has no cbrt, and float32
    `pow(x, 1/3)` is off by a few ulp (1/3 itself is rounded); the float64
    power rounded back to float32 differs from a correctly rounded cube
    root only where the float64 result lies within its own error of a
    float32 rounding boundary."""
    return x.double().pow(1.0 / 3.0).to(x.dtype)


def rgb_to_lab(im: torch.Tensor) -> torch.Tensor:
    """RGB [..., 3, H, W] in 0..255 -> attenuated L*a*b*: the a/b channels
    are scaled by exp(-1.5 * ((L/100)^2 - 0.6)^2) (the reference's
    `correct_lab`)."""
    r = im[..., 0, :, :] / 255.0
    g = im[..., 1, :, :] / 255.0
    b = im[..., 2, :, :] / 255.0
    t = 0.008856
    x = (0.412453 * r + 0.357580 * g + 0.180423 * b) / 0.950456
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / 1.088754
    y3 = _cbrt(y.clamp_min(0.0))
    fx = torch.where(x > t, _cbrt(x.clamp_min(0.0)), 7.787 * x + 16.0 / 116.0)
    fy = torch.where(y > t, y3, 7.787 * y + 16.0 / 116.0)
    fz = torch.where(z > t, _cbrt(z.clamp_min(0.0)), 7.787 * z + 16.0 / 116.0)
    lum = torch.where(y > t, 116.0 * y3 - 16.0, 903.3 * y)
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    correct = torch.exp(-1.5 * ((lum / 100.0) ** 2 - 0.6) ** 2)
    return torch.stack([lum, a * correct, bb * correct], dim=-3)


def saliency(im: torch.Tensor, sigma_image: float = 0.8,
             sigma_matrix: float = 1.0) -> torch.Tensor:
    """Smaller eigenvalue's square root of the smoothed structure tensor of
    [..., C, H, W] (summed over C); returns [..., H, W]."""
    k_img = gaussian_kernel(sigma_image)
    sim = conv_vert(conv_horiz(im, k_img), k_img)
    imx = conv_horiz(sim, DERIV_3PT)
    imy = conv_vert(sim, DERIV_3PT)
    ixx = (imx * imx).sum(dim=-3)
    ixy = (imx * imy).sum(dim=-3)
    iyy = (imy * imy).sum(dim=-3)
    k_mat = gaussian_kernel(sigma_matrix)
    ixx = conv_vert(conv_horiz(ixx, k_mat), k_mat)
    ixy = conv_vert(conv_horiz(ixy, k_mat), k_mat)
    iyy = conv_vert(conv_horiz(iyy, k_mat), k_mat)
    tr = 0.5 * (ixx + iyy)
    disc = torch.sqrt((tr * tr + ixy * ixy - ixx * iyy).clamp_min(0.0))
    return torch.sqrt((tr - disc).clamp_min(0.0))


def resize_bilinear(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Bilinear resize of the trailing [H, W] axes, pixel-centre aligned.

    The reference is `jax.image.resize(..., "linear")`, which widens the
    triangle filter when it downscales (antialiasing). `F.interpolate` with
    `antialias=True` computes the same filter; without it a 0.9 pyramid step
    would differ by ~0.2 on 0..255 data."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    flat = x.reshape(-1, 1, h, w)
    out = F.interpolate(flat, size=(new_h, new_w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(*lead, new_h, new_w)


def normalize_sequence(seq: np.ndarray):
    """Zero mean, std 255 per channel, statistics over all frames.

    seq is [F, 3, H, W]. Returns (normalized float32, avg[3], std[3])."""
    seq = np.asarray(seq, np.float64)
    avg = seq.mean(axis=(0, 2, 3))
    second = (seq * seq).mean(axis=(0, 2, 3))
    std = np.sqrt(second - avg * avg) / 255.0
    out = seq.copy()
    for c in range(seq.shape[1]):
        if std[c] > 0:
            out[:, c] = (seq[:, c] - avg[c]) / std[c]
    return out.astype(np.float32), avg, std
