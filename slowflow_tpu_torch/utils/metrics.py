"""Flow accuracy metrics: mean endpoint error, mean angular error and mean
colour distance (utils/utils.cpp:39-167 of the reference)."""
from __future__ import annotations

import numpy as np

from ..io.flo import UNKNOWN_FLOW_THRESH


def _known(flow, gt, mask):
    """(fu, fv, gu, gv) as float64 planes and the pixels where both flows
    are known and `mask` (if given) is nonzero."""
    fu, fv = np.moveaxis(np.asarray(flow, np.float64), -1, 0)
    gu, gv = np.moveaxis(np.asarray(gt, np.float64), -1, 0)
    valid = ((np.abs(gu) <= UNKNOWN_FLOW_THRESH)
             & (np.abs(gv) <= UNKNOWN_FLOW_THRESH)
             & (np.abs(fu) <= UNKNOWN_FLOW_THRESH)
             & (np.abs(fv) <= UNKNOWN_FLOW_THRESH))
    if mask is not None:
        valid &= np.asarray(mask) != 0
    return fu, fv, gu, gv, valid


def compute_epe(flow, gt, mask=None) -> float:
    """Mean endpoint error over the pixels where both flows are known (and
    `mask` is nonzero). flow / gt are [H, W, 2] (u, v)."""
    fu, fv, gu, gv, valid = _known(flow, gt, mask)
    if not valid.any():
        return 0.0
    err = np.sqrt((fu - gu) ** 2 + (fv - gv) ** 2)
    return float(err[valid].mean())


def compute_aae(flow, gt, mask=None) -> float:
    """Mean angular error in radians between the 3D vectors (u, v, 1), over
    the same pixels as `compute_epe`."""
    fu, fv, gu, gv, valid = _known(flow, gt, mask)
    if not valid.any():
        return 0.0
    n1 = np.sqrt(fu * fu + fv * fv + 1.0)
    n2 = np.sqrt(gu * gu + gv * gv + 1.0)
    cos = np.minimum((fu * gu + fv * gv + 1.0) / (n1 * n2), 1.0)
    return float(np.arccos(cos)[valid].mean())


def compute_rms(im1, im2) -> float:
    """Mean per-pixel colour distance between two [3, H, W] images."""
    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    return float(np.sqrt(((im1 - im2) ** 2).sum(axis=0)).mean())
