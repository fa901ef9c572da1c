"""Red-black coupled 2x2-block SOR (torch port of
`slowflow_tpu.core.solver.sor_coupled_rb`), the plain version of the sweep
loop inside the K1 kernel (csrc/solve_step.cu).

Solves [a11 + S, a12; a12, a22 + S] [du; dv] = [b1 + sum w_n du_n; b2 + ...]
over the 4-neighbourhood with horizontal weights wh (edge (j,i)-(j,i+1)) and
vertical weights wv (edge (j,i)-(j+1,i)); red = (row + col) % 2 == 0 first,
the row counted in the image when `rows` places [E, H, W] strip windows in
it (parallel/strips.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .rows import red_cells


def shift0(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-fill shift on [..., H, W]: out[j, i] = x[j + dy, i + dx]."""
    h, w = x.shape[-2:]
    padded = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    oy, ox = max(dy, 0), max(dx, 0)
    return padded[..., oy:oy + h, ox:ox + w]


def checkerboard(h: int, w: int, device) -> torch.Tensor:
    """True on red cells, (row + col) % 2 == 0."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy + xx) % 2 == 0


def sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv,
                   iterations: int = 30, omega: float = 1.9, rows=None):
    """All inputs [..., H, W] float32. The last column of wh and the last row
    of wv are ignored (boundary). Returns updated (du, dv)."""
    h, w = du.shape[-2:]
    wh = wh.clone()
    wv = wv.clone()
    wh[..., :, -1] = 0.0
    wv[..., -1, :] = 0.0

    w_n = shift0(wv, -1, 0)
    w_w = shift0(wh, 0, -1)
    w_s = wv
    w_e = wh
    sum_w = w_n + w_w + w_s + w_e
    A11 = a11 + sum_w
    A22 = a22 + sum_w
    det = A11 * A22 - a12 * a12
    det = torch.where(det == 0, torch.ones_like(det), det)
    i11 = A22 / det
    i12 = -a12 / det
    i22 = A11 / det
    red = checkerboard(h, w, du.device) if rows is None \
        else red_cells(rows, h, w, du.device)

    def half(du, dv, mask):
        su = (w_n * shift0(du, -1, 0) + w_w * shift0(du, 0, -1)
              + w_s * shift0(du, 1, 0) + w_e * shift0(du, 0, 1))
        sv = (w_n * shift0(dv, -1, 0) + w_w * shift0(dv, 0, -1)
              + w_s * shift0(dv, 1, 0) + w_e * shift0(dv, 0, 1))
        B1 = b1 + su
        B2 = b2 + sv
        nu = i11 * B1 + i12 * B2
        nv = i12 * B1 + i22 * B2
        du = torch.where(mask, (1 - omega) * du + omega * nu, du)
        dv = torch.where(mask, (1 - omega) * dv + omega * nv, dv)
        return du, dv

    for _ in range(iterations):
        du, dv = half(du, dv, red)
        du, dv = half(du, dv, ~red)
    return du, dv


def sor_coupled_reference(du, dv, a11, a12, a22, b1, b2, wh, wv,
                          iterations: int = 30, omega: float = 1.9):
    """Sequential Gauss-Seidel oracle (solver.c:17-57): the same system
    swept pixel by pixel in row order, in float64 NumPy. Slow; the tests'
    fixed point for `sor_coupled_rb`. [H, W] arrays; returns (du, dv)."""
    du = np.array(du, np.float64)
    dv = np.array(dv, np.float64)
    a11, a12, a22, b1, b2, wh, wv = (np.asarray(a) for a in
                                     (a11, a12, a22, b1, b2, wh, wv))
    h, w = du.shape
    for _ in range(iterations):
        for j in range(h):
            for i in range(w):
                sigma_u = sigma_v = sum_d = 0.0
                if j > 0:
                    sigma_u -= wv[j - 1, i] * du[j - 1, i]
                    sigma_v -= wv[j - 1, i] * dv[j - 1, i]
                    sum_d += wv[j - 1, i]
                if i > 0:
                    sigma_u -= wh[j, i - 1] * du[j, i - 1]
                    sigma_v -= wh[j, i - 1] * dv[j, i - 1]
                    sum_d += wh[j, i - 1]
                if j < h - 1:
                    sigma_u -= wv[j, i] * du[j + 1, i]
                    sigma_v -= wv[j, i] * dv[j + 1, i]
                    sum_d += wv[j, i]
                if i < w - 1:
                    sigma_u -= wh[j, i] * du[j, i + 1]
                    sigma_v -= wh[j, i] * dv[j, i + 1]
                    sum_d += wh[j, i]
                A11 = a11[j, i] + sum_d
                A12 = a12[j, i]
                A22 = a22[j, i] + sum_d
                det = A11 * A22 - A12 * A12
                B1 = b1[j, i] - sigma_u
                B2 = b2[j, i] - sigma_v
                du[j, i] = ((1 - omega) * du[j, i]
                            + omega * (A22 * B1 - A12 * B2) / det)
                dv[j, i] = ((1 - omega) * dv[j, i]
                            + omega * (-A12 * B1 + A11 * B2) / det)
    return du, dv
