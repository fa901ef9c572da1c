"""Built-in edge cost maps for the geodesic interpolation (torch port of
`slowflow_tpu.epic.edges`): a multi-scale colour-gradient magnitude squashed
to [0, 1), the same float32 H x W contract as the SED edge files that the
CLIs ingest when present."""
from __future__ import annotations

import torch

from ..core.conv import DERIV_3PT, conv_horiz, conv_vert, gaussian_blur


def detect_edges(im: torch.Tensor) -> torch.Tensor:
    """Edge strength in [0, 1) of [..., 3, H, W] images (0..255): |grad| at
    sigma 1, 2 and 4, each scaled by its sigma, averaged, then tanh(4x).
    Returns [..., H, W]."""
    im = im / 255.0
    total = 0.0
    for sigma in (1.0, 2.0, 4.0):
        sm = gaussian_blur(im, sigma)
        gx = conv_horiz(sm, DERIV_3PT)
        gy = conv_vert(sm, DERIV_3PT)
        mag = torch.sqrt((gx * gx + gy * gy).sum(dim=-3))
        total = total + mag * sigma
    return torch.tanh(4.0 * (total / 3.0))
