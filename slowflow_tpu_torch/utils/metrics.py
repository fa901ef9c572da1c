"""Flow accuracy metric of the CLI: mean endpoint error (utils/utils.cpp:39-167
of the reference)."""
from __future__ import annotations

import numpy as np

from ..io.flo import UNKNOWN_FLOW_THRESH


def compute_epe(flow, gt, mask=None) -> float:
    """Mean endpoint error over the pixels where both flows are known (and
    `mask` is nonzero). flow / gt are [H, W, 2] (u, v)."""
    fu, fv = np.moveaxis(np.asarray(flow, np.float64), -1, 0)
    gu, gv = np.moveaxis(np.asarray(gt, np.float64), -1, 0)
    valid = ((np.abs(gu) <= UNKNOWN_FLOW_THRESH)
             & (np.abs(gv) <= UNKNOWN_FLOW_THRESH)
             & (np.abs(fu) <= UNKNOWN_FLOW_THRESH)
             & (np.abs(fv) <= UNKNOWN_FLOW_THRESH))
    if mask is not None:
        valid &= np.asarray(mask) != 0
    if not valid.any():
        return 0.0
    err = np.sqrt((fu - gu) ** 2 + (fv - gv) ** 2)
    return float(err[valid].mean())
