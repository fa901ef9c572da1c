"""Separable correlations with clamp-to-edge boundaries (frozen copy of the
port's `core.conv`).

out[i] = sum_k coeffs[k] * src[clamp(i + k - order)], taps written as shifted
adds in the reference's order (zero taps skipped), so the float32 results
match the JAX functions term by term. No cuDNN convolution is involved, so
TF32 cannot creep in.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def full_coeffs(half_coeffs, even: bool) -> np.ndarray:
    half = np.asarray(half_coeffs, np.float32)
    order = len(half) - 1
    coeffs = np.zeros(2 * order + 1, np.float32)
    for i in range(order + 1):
        coeffs[order - i] = half[i]
        coeffs[order + i] = half[i] if even else -half[i]
    return coeffs


DERIV_5PT = full_coeffs([0.0, -8.0 / 12.0, 1.0 / 12.0], even=False)
DERIV_3PT = full_coeffs([0.0, -0.5], even=False)


def shift_clamped(x: torch.Tensor, off: int, dim: int) -> torch.Tensor:
    """out[i] = x[clamp(i + off)] along `dim` (edge replicate)."""
    if off == 0:
        return x
    n = x.shape[dim]
    idx = (torch.arange(n, device=x.device) + off).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def _conv_axis(x: torch.Tensor, coeffs, dim: int) -> torch.Tensor:
    coeffs = np.asarray(coeffs, np.float32)
    order = (len(coeffs) - 1) // 2
    out = None
    for k, c in enumerate(coeffs):
        if c == 0.0:
            continue
        term = float(c) * shift_clamped(x, k - order, dim)
        out = term if out is None else out + term
    return torch.zeros_like(x) if out is None else out


def conv_horiz(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Correlation along the width axis with edge-clamped boundaries."""
    return _conv_axis(x, coeffs, -1)


def conv_vert(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Correlation along the height axis with edge-clamped boundaries."""
    return _conv_axis(x, coeffs, -2)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Normalized Gaussian taps, order = floor(3*sigma) + 1 (at least 1)."""
    if sigma <= 0:
        raise ValueError("sigma must be > 0")
    order = max(int(math.floor(3 * sigma)) + 1, 1)
    i = np.arange(-order, order + 1, dtype=np.float64)
    k = np.exp(-i * i / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with replicate borders, horizontal first."""
    k = gaussian_kernel(sigma)
    return conv_vert(conv_horiz(x, k), k)
