"""The synthetic bench scenes, made from a seed.

`moving_sequence` is the scene the JAX package's benchmark solves (its
`bench.py` `_moving_sequence`); `stage3_final_pair` and `stage3_config` are
its stage-3 final pair and configuration (`bench.py` `dt_final_pair_seconds`,
which chip_smoke.py's `stage3_final_pair` phase runs). They are kept here so
that the port's smoke run, sweep and tests need nothing of that package.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

DT_UV = (1.5, -0.8)     # the stage-3 scene's background motion, px/frame


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


def stage3_config(**overrides):
    """The stage-3 bench configuration: Jets 10, the working resolution
    subsampled by 2, capacity 16, 5 alternations, 20 tryouts, EPIC
    hypotheses on (the production default), seed 1."""
    from .tracking.driver import TrackingConfig

    return replace(TrackingConfig(jets=10, rates=1, skip_pixel=1,
                                  capacity=16, alternate=5,
                                  hyp_neigh_tryouts=20,
                                  epic_interpolation=True, seed=1),
                   **overrides)


def stage3_final_pair(h=270, w=480, jets=10, seed=0, device=None):
    """The stage-3 final pair of the bench: `jets + 1` frames of
    `moving_sequence` at (1.5, -0.8) px/frame, their normalized data and
    derivatives, jet flows of the background and of the disc (moving the
    other way in x) with N(0, 0.08) noise from `default_rng(seed)`,
    smoothness weight 0.4 and the EPIC context of frame 0.

    Returns (job, gt): `job` the per-final inputs of
    `track_final_pairs_batched`, `gt` the final flow's x component on the
    subsampled grid [h // 2, w // 2]."""
    import torch

    from .core.conv import DERIV_5PT, conv_horiz, conv_vert
    from .core.image import normalize_sequence, rgb_to_lab
    from .epic import EpicParams
    from .epic.edges import detect_edges
    from .runtime import resolve_device

    device = resolve_device(device)
    u, v = DT_UV
    frames = moving_sequence(jets + 1, h, w, u, v, seed=seed)
    stack, avg, std = normalize_sequence(frames)
    st = torch.as_tensor(stack, device=device)
    data_dx = conv_horiz(st, DERIV_5PT).permute(0, 2, 3, 1).cpu().numpy()
    data_dy = conv_vert(st, DERIV_5PT).permute(0, 2, 3, 1).cpu().numpy()
    data = np.moveaxis(stack, 1, -1)

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx, r = h // 2, w // 2, min(h, w) // 6
    fg = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
    fwd = np.zeros((jets, h, w, 2), np.float32)
    fwd[..., 0] = np.where(fg, -u, u)
    fwd[..., 1] = v
    fwd += rng.normal(0, 0.08, fwd.shape).astype(np.float32)
    bwd = (-fwd).astype(np.float32)
    sw = np.full((h, w), 0.4, np.float32)

    im0 = torch.as_tensor(frames[0], dtype=torch.float32, device=device)
    epic_ctx = (rgb_to_lab(im0).cpu().numpy(),
                detect_edges(im0).cpu().numpy(), EpicParams.sintel())
    job = dict(rate_flows=[(fwd, bwd, None)], forward=fwd, backward=bwd,
               occlusions=None, data=data, data_dx=data_dx, data_dy=data_dy,
               smooth_weight=sw, epic_ctx=epic_ctx)
    return job, fwd.sum(0)[::2, ::2, 0] / 2


def dt_flow_err_px(flow, gt):
    """Median |u - gt| over the interior (8 px in from each side)."""
    return float(np.median(np.abs(flow[8:-8, 8:-8, 0] - gt[8:-8, 8:-8])))

