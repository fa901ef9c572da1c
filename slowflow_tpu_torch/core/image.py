"""Lab conversion, saliency, resize, pyramid and normalization (torch port of
`slowflow_tpu.core.image`).

Images are channel-planar float32 tensors [..., 3, H, W]; every function
batches over the leading dims.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .conv import DERIV_3PT, conv_horiz, conv_vert, gaussian_blur, \
    gaussian_kernel


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


def luminance(im: torch.Tensor, scale: float = 255.0) -> torch.Tensor:
    """0.299 R + 0.587 G + 0.114 B of [..., 3, H, W], divided by `scale`."""
    return (0.299 * im[..., 0, :, :] + 0.587 * im[..., 1, :, :]
            + 0.114 * im[..., 2, :, :]) / scale


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


def rescale_flow(wx: torch.Tensor, wy: torch.Tensor, new_h: int, new_w: int):
    """Resize a flow field and scale the vectors by the size ratio."""
    fh = new_h / wx.shape[-2]
    fw = new_w / wx.shape[-1]
    return (resize_bilinear(wx, new_h, new_w) * fw,
            resize_bilinear(wy, new_h, new_w) * fh)


def pyramid_sizes(h: int, w: int, layers: int, p_scale: float,
                  min_size: int | None = None) -> list[tuple[int, int]]:
    """Per-layer (H, W), layer 0 = full resolution; layer l is
    floor(size_{l-1} * p_scale), stopping before a side reaches `min_size`
    (default: presmoothing order + 1)."""
    sigma = 1.0 / math.sqrt(2.0 * p_scale)
    order = max(int(math.floor(3 * sigma)) + 1, 1)
    if min_size is None:
        min_size = order + 1
    sizes = [(h, w)]
    for _ in range(1, layers):
        ph, pw = sizes[-1]
        nh, nw = int(math.floor(ph * p_scale)), int(math.floor(pw * p_scale))
        if nh <= min_size or nw <= min_size:
            break
        sizes.append((nh, nw))
    return sizes


def build_pyramid(seq: torch.Tensor, sizes: list[tuple[int, int]],
                  p_scale: float, sigma0: float = 0.0) -> list[torch.Tensor]:
    """Gaussian pyramid of a stack [..., H, W]: layer l is layer l-1 blurred
    with sigma = 1/sqrt(2*p_scale) and resized to sizes[l]."""
    cur = gaussian_blur(seq, sigma0) if sigma0 > 0 else seq
    out = [cur]
    sigma = 1.0 / math.sqrt(2.0 * p_scale)
    for nh, nw in sizes[1:]:
        cur = resize_bilinear(gaussian_blur(cur, sigma), nh, nw)
        out.append(cur)
    return out


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
